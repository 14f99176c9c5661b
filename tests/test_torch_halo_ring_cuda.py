"""The ring halo exchange kernel (K12) against its plain PyTorch version on
a CUDA card, for every form (the wrapped ring, the ring with a carried
context, several rings and planes in one launch, more pairs than one
launch holds) and every copy path (16-byte, 4-byte and 1-byte copies).
A halo exchange moves bytes, so the kernel must equal the plain version
bit for bit.  Also the sharded layer's launch counts and its dry run on
an 8-shard mesh of the card.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_halo_ring_cuda.py

Without a CUDA device the tests skip: the kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from comms_tpu_torch.kernels import halo_ring as HR


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _rings(card, n_rings, n, length, trailing, dtype, seed):
    g = torch.Generator(device=card)
    g.manual_seed(seed)
    shape = (length,) + trailing
    if dtype == torch.uint8:
        return [[torch.randint(0, 256, shape, generator=g, device=card,
                               dtype=dtype) for _ in range(n)]
                for _ in range(n_rings)]
    return [[torch.randn(shape, generator=g, device=card).to(dtype)
             for _ in range(n)] for _ in range(n_rings)]


def _same(got, want):
    return all(torch.equal(a, b) for ga, wa in zip(got, want)
               for a, b in zip(ga, wa))


def _width(rings, halo):
    t = rings[0][0][-halo:]
    return HR.copy_width([t.data_ptr()], t.numel() * t.element_size())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (dtype, length, halo, trailing, copy width of the tails)
    (torch.float32, 1024, 64, (), 16),
    (torch.float32, 1000, 62, (), 4),      # the audio FIR halo (T - 1)
    (torch.complex64, 1000, 62, (), 16),   # one pair over the float view
    (torch.float32, 4096, 1, (), 4),       # the FM prev / yprev halo
    (torch.uint8, 102400, 25669, (), 1),   # the fused chain's raw tail
    (torch.float32, 4096, 1, (4,), 16),    # the 2-D demod row [1, Kl]
])
@pytest.mark.parametrize("form", ["wrap", "ctx"])
def test_kernel_equals_plain(card, case, form):
    dtype, length, halo, trailing, width = case
    rings = _rings(card, 2, 8, length, trailing, dtype, length + halo)
    assert _width(rings, halo) == width
    ctxs = None
    if form == "ctx":
        ctxs = [r[0][:halo].clone() for r in
                _rings(card, 2, 1, halo, trailing, dtype, 7)]
    launches = HR.launches
    got = HR.exchange(rings, halo, ctxs)
    want = HR.exchange_plain(rings, halo, ctxs)
    torch.cuda.synchronize()
    assert HR.launches == launches + 1
    assert _same(got, want)


@pytest.mark.cuda
def test_many_pairs_take_more_launches(card):
    rings = _rings(card, 3, 60, 256, (), torch.float32, 3)   # 180 pairs
    launches = HR.launches
    got = HR.exchange(rings, 31)
    want = HR.exchange_plain(rings, 31)
    torch.cuda.synchronize()
    assert HR.launches == launches + 2
    assert _same(got, want)


@pytest.mark.cuda
def test_single_ring_and_offsets(card):
    # tails at every byte offset mod 16 of a u8 plane: each copy path
    x = torch.randint(0, 256, (8, 4096), device=card, dtype=torch.uint8)
    for off in range(16):
        xs = [row[:4096 - off] for row in x]
        got = HR.ring_halo_exchange(xs, 48)
        want = HR.ring_halo_exchange_plain(xs, 48)
        torch.cuda.synchronize()
        assert all(torch.equal(a, b) for a, b in zip(got, want))


@pytest.mark.cuda
def test_sharded_chain_launch_counts(card):
    from comms_tpu_torch.models.fm_receiver import FM_LPF_TAPS
    from comms_tpu_torch.parallel import sharding as sh
    from comms_tpu_torch.parallel import wideband

    mesh = sh.time_mesh(8)
    cfg = wideband.WidebandConfig(FM_LPF_TAPS, block=8 * 4000)
    step = wideband.make_sharded_step(cfg, mesh)
    rng = np.random.default_rng(0)
    pairs = torch.from_numpy(rng.normal(size=(cfg.block, 2)).astype(
        np.float32)).to(card)
    launches = HR.launches
    (audio, _), st = step(wideband.init_state(cfg), pairs)
    torch.cuda.synchronize()
    assert HR.launches == launches + 4          # four ring exchanges
    assert torch.isfinite(audio).all()
    cpu = wideband.make_sharded_step(cfg, sh.time_mesh(8, device="cpu"))
    (a_cpu, _), _ = cpu(wideband.init_state(cfg, device="cpu"),
                        pairs.cpu())
    assert float((audio.cpu() - a_cpu).abs().max()) < 1e-4


@pytest.mark.cuda
def test_dryrun_multichip_on_the_card(card):
    from comms_tpu_torch.parallel import dryrun

    dryrun.dryrun_multichip(8)


@pytest.mark.cuda
def test_multi_card_ring_raises(card):
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two CUDA devices")
    xs = [torch.zeros(8, device="cuda:0"), torch.zeros(8, device="cuda:1")]
    with pytest.raises(ValueError, match="later slice"):
        HR.ring_halo_exchange(xs, 2)
