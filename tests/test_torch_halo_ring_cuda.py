"""The ring halo exchange kernel (K12) against its plain PyTorch version on
a CUDA card, for every form (the wrapped ring, the ring with a carried
context, several rings and planes in one launch, more pairs than one
launch holds) and every source byte offset in its 16-byte word (the
plain word copy at 0, the realigned copy at 1..15), over lengths from 1
element to 1 MiB.  A halo exchange moves bytes, so the kernel must equal
the plain version bit for bit.  Also the received tensors (rows of one
buffer, contiguous, 16-byte aligned, overlapping no other row and no
source), the C entry's refusal of a misaligned destination, the launch
floor's empty kernel, the sharded layer's launch counts and its dry run
on an 8-shard mesh of the card.

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


def _offset(rings, halo):
    return HR.source_offset(rings[0][0][-halo:].data_ptr())


@pytest.mark.cuda
@pytest.mark.parametrize("case", [
    # (dtype, length, halo, trailing, byte offset of the tails)
    (torch.float32, 1024, 64, (), 0),
    (torch.float32, 1000, 62, (), 8),      # the audio FIR halo (T - 1)
    (torch.complex64, 1000, 62, (), 0),    # one pair over the float view
    (torch.float32, 4096, 1, (), 12),      # the FM prev / yprev halo
    (torch.uint8, 102400, 25669, (), 11),  # the fused chain's raw tail
    (torch.float32, 4096, 1, (4,), 0),     # the 2-D demod row [1, Kl]
])
@pytest.mark.parametrize("form", ["wrap", "ctx"])
def test_kernel_equals_plain(card, case, form):
    dtype, length, halo, trailing, offset = case
    rings = _rings(card, 2, 8, length, trailing, dtype, length + halo)
    assert _offset(rings, halo) == offset
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
    # tails at every byte offset mod 16 of a u8 plane: the plain word copy
    # and the realigned one at each shift
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


def _sweep_rings(card, dtype, length, off, gen):
    """2 rings of 4 shards whose tails start at byte offsets off, off +
    5 es, ... (mod 16), each shard 16 bytes and its tail, cut from a
    fresh byte buffer (so the tail ends its allocation's used bytes)."""
    es = torch.empty(0, dtype=dtype).element_size()

    def shard(o):
        buf = torch.randint(0, 256, (32 + length * es,), generator=gen,
                            device=card, dtype=torch.uint8)
        return buf[o:o + 16 + length * es].view(dtype)
    return [[shard((off + 5 * i * es) % 16) for i in range(4)]
            for _ in range(2)], [shard(0)[-length:] for _ in range(2)]


def _same_bytes(got, want):
    return all(torch.equal(a.view(torch.uint8), b.view(torch.uint8))
               for ga, wa in zip(got, want) for a, b in zip(ga, wa))


@pytest.mark.cuda
@pytest.mark.parametrize("nbytes", [1, 15, 16, 17, 4095, 25669, 1 << 20])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32,
                                   torch.complex64])
def test_offset_sweep(card, dtype, nbytes):
    # every source offset the dtype allows, wrapped and with contexts
    es = torch.empty(0, dtype=dtype).element_size()
    length = nbytes if nbytes < (1 << 20) else nbytes // es
    gen = torch.Generator(device=card)
    gen.manual_seed(nbytes)
    for off in range(0, 16, es):
        rings, ctxs = _sweep_rings(card, dtype, length, off, gen)
        assert _offset(rings, length) == off
        for c in (None, ctxs):
            n0 = HR.launches
            got = HR.exchange(rings, length, c)
            want = HR.exchange_plain(rings, length, c)
            torch.cuda.synchronize()
            assert HR.launches == n0 + 1
            assert _same_bytes(got, want), (off, c is None)


@pytest.mark.cuda
@pytest.mark.parametrize("form", ["wrap", "ctx", "rings"])
def test_destinations(card, form):
    # rows of one buffer: contiguous, 16-byte aligned, of the right shape,
    # overlapping no other row and no source
    rings = _rings(card, 3 if form == "rings" else 1, 8, 1000, (),
                   torch.uint8, 5)
    ctxs = None if form == "wrap" else [r[0][:333].clone() for r in rings]
    got = HR.exchange(rings, 333, ctxs)
    torch.cuda.synchronize()
    rows = [a for g in got for a in g]
    spans = sorted((a.data_ptr(), a.data_ptr() + a.numel()) for a in rows)
    assert all(e0 <= s1 for (_, e0), (s1, _) in zip(spans, spans[1:]))
    srcs = [(x.data_ptr(), x.data_ptr() + x.numel())
            for r in rings for x in r] + [
        (c.data_ptr(), c.data_ptr() + c.numel()) for c in ctxs or []]
    for a in rows:
        assert a.is_contiguous() and a.shape == (333,)
        assert a.data_ptr() % 16 == 0
        assert all(a.data_ptr() + a.numel() <= s or e <= a.data_ptr()
                   for s, e in srcs)
    assert _same_bytes(got, HR.exchange_plain(rings, 333, ctxs))


@pytest.mark.cuda
def test_c_entry_contract(card):
    import struct

    from comms_tpu_torch.kernels import _build

    lib = _build.load()
    assert lib.halo_ring_max_pairs() == HR.MAX_PAIRS
    src = torch.zeros(64, dtype=torch.uint8, device=card)
    dst = torch.zeros(64, dtype=torch.uint8, device=card)
    stream = torch.cuda.current_stream().cuda_stream
    bad = struct.pack("2Q", src.data_ptr(), dst.data_ptr() + 1)
    assert lib.halo_ring_launch(bad, 1, 16, stream) != 0
    ok = struct.pack("2Q", src.data_ptr() + 3, dst.data_ptr())
    assert lib.halo_ring_launch(ok, 1, 16, stream) == 0
    assert lib.halo_ring_launch(ok, 0, 16, stream) != 0
    assert lib.halo_ring_launch(ok, 1, 0, stream) != 0
    assert lib.halo_ring_launch(ok, 1, 1 << 31, stream) != 0
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_launch_floor(card):
    n0 = HR.launches
    for big in (True, False):
        for blocks in (1, 32):
            HR.launch_floor(big, blocks)
    torch.cuda.synchronize()
    assert HR.launches == n0
    with pytest.raises(ValueError, match="CUDA"):
        HR.launch_floor(True, device="cpu")
