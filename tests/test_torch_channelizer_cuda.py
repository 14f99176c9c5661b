"""The channelizer kernel (csrc/channelizer.cu) on a CUDA card: every
K | 128 and M in {1, 8, 16} against the plain version, a float64
channelizer and the CPU replay of its plan (tests/_k8_replay.py), the
partition (1, 2 and 17 tiles a block, a partition edge), chained calls,
one launch a call, and a failed launch raising.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a CUDA device the tests skip: the kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from _k8_replay import f64_channelize, k8_replay
from comms_tpu_torch.kernels import channelizer as TCK
from comms_tpu_torch.ops import channelizer as tchan

# Kernel against plain: float32 on both sides, an FFT against the direct
# sum (the JAX test's bound, chip_smoke.TOL_CHAN).
TOL_CHAN = 1e-5
# Kernel against the replay of its own plan: the same operations, the
# kernel contracting products into FMAs where the replay rounds each.
TOL_REPLAY = 1e-6
# Against float64 the kernel is held to the replay's error, with room for
# those contractions.
F64_SLACK = 1.5

CASES = [(k, m) for k in (2, 4, 8, 16, 32, 64, 128) for m in (1, 8, 16)
         if k * m <= TCK.CTX_SAMPLES + 1]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _planes(seed, n):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=s).astype(np.float32)
            for s in (n, n, TCK.CTX_SAMPLES, TCK.CTX_SAMPLES)]


def _err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _run(host, h, k, dev):
    re_, im_, cr, ci = (torch.from_numpy(a).to(dev) for a in host)
    return TCK.channelize_planar(re_, im_, h, cr, ci, k)


@pytest.mark.cuda
@pytest.mark.parametrize("k,m", CASES)
def test_kernel_matches_plain_float64_and_replay(cuda, k, m):
    host = _planes(10 * k + m, 2 * TCK.step_samples())
    h = tchan.design_prototype(k, m)
    n = TCK.launches
    got = _run(host, h, k, cuda)
    t = [torch.from_numpy(a).to(cuda) for a in host]
    want = TCK.channelize_plain(t[0], t[1], h, t[2], t[3], k)
    torch.cuda.synchronize()
    assert TCK.launches == n + 1
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape and _err(g, w) < TOL_CHAN
    assert torch.equal(got[2], t[0][-TCK.CTX_SAMPLES:])
    assert torch.equal(got[3], t[1][-TCK.CTX_SAMPLES:])
    rr, ri, _ = k8_replay(*host[:2], h, *host[2:], k)
    f = f64_channelize(*host[:2], h, *host[2:], k)
    scale = max(np.abs(f.real).max(), np.abs(f.imag).max())
    g = [a.cpu().numpy() for a in got[:2]]
    assert max(np.abs(g[0] - rr).max(), np.abs(g[1] - ri).max()) \
        < TOL_REPLAY * scale
    e_kernel = max(np.abs(g[0] - f.real).max(), np.abs(g[1] - f.imag).max())
    e_replay = max(np.abs(rr - f.real).max(), np.abs(ri - f.imag).max())
    assert e_kernel <= F64_SLACK * e_replay


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 64, 128])
def test_chained_halves_equal_one_call(cuda, k):
    host = _planes(k, 4 * TCK.step_samples())
    h = tchan.design_prototype(k, 8)
    re_, im_, cr, ci = (torch.from_numpy(a).to(cuda) for a in host)
    whole = TCK.channelize_planar(re_, im_, h, cr, ci, k)
    n = re_.shape[0] // 2
    a = TCK.channelize_planar(re_[:n], im_[:n], h, cr, ci, k)
    b = TCK.channelize_planar(re_[n:], im_[n:], h, a[2], a[3], k)
    torch.cuda.synchronize()
    assert torch.equal(whole[0], torch.cat([a[0], b[0]]))
    assert torch.equal(whole[1], torch.cat([a[1], b[1]]))
    assert torch.equal(whole[2], b[2]) and torch.equal(whole[3], b[3])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("steps,blocks,run", [
    (1, None, 1),         # 4 tiles, 4 blocks
    (2, 4, 2),            # 8 tiles, 4 blocks: 2 tiles a block
    (17, 4, 17),          # 68 tiles, 4 blocks: 17 tiles a block
    (529, None, 2),       # 2116 tiles: past the 2112 blocks, the edge
])
def test_partitions_give_the_same_bits(cuda, monkeypatch, k, steps, blocks,
                                       run):
    F = 4096 // k
    host = _planes(steps + k, steps * TCK.step_samples())
    h = tchan.design_prototype(k, 8)
    tiles = steps * TCK.step_samples() // k // F
    one = _run(host, h, k, cuda)                      # default partition
    if blocks is not None:
        monkeypatch.setattr(TCK, "_RUN_BLOCKS", blocks)
    assert TCK.partition(tiles * F, k)[1] == run
    got = _run(host, h, k, cuda)
    monkeypatch.setattr(TCK, "_RUN_BLOCKS", 1 << 30)  # one tile a block
    each = _run(host, h, k, cuda)
    torch.cuda.synchronize()
    for a, b, c in zip(got[:2], one[:2], each[:2]):
        assert torch.equal(a, b) and torch.equal(a, c)
    t = [torch.from_numpy(a).to(cuda) for a in host]
    want = TCK.channelize_plain(t[0], t[1], h, t[2], t[3], k)
    for g, w in zip(got[:2], want[:2]):
        assert _err(g, w) < TOL_CHAN


@pytest.mark.cuda
def test_unaligned_planes_take_the_load_path(cuda):
    # Planes off a 16-byte boundary are read without cp.async: same bits.
    host = _planes(5, 2 * TCK.step_samples() + 1)
    h = tchan.design_prototype(64, 8)
    re_, im_, cr, ci = (torch.from_numpy(a).to(cuda) for a in host)
    shifted = TCK.channelize_planar(re_[1:], im_[1:], h, cr, ci, 64)
    aligned = TCK.channelize_planar(re_[1:].clone(), im_[1:].clone(), h,
                                    cr, ci, 64)
    torch.cuda.synchronize()
    assert torch.equal(shifted[0], aligned[0])
    assert torch.equal(shifted[1], aligned[1])


@pytest.mark.cuda
def test_failed_launch_raises(cuda, monkeypatch):
    # A non-zero return of the C entry (here: zero blocks) raises and is
    # not counted as a launch.
    host = _planes(6, TCK.step_samples())
    h = tchan.design_prototype(64, 8)
    monkeypatch.setattr(TCK, "partition", lambda frames, k: (64, 1, 0))
    n = TCK.launches
    with pytest.raises(RuntimeError, match="CUDA error"):
        _run(host, h, 64, cuda)
    assert TCK.launches == n
