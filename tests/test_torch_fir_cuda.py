"""K4, the dense streaming FIR (``kernels/fir.fir_planar`` and
``fir_block`` on the decimating-FIR kernel of ``csrc/decim_fir.cu`` at
D = 1), on a CUDA card: against its plain version and the CPU replay of
the kernel's plan (tests/_k2_replay.py) at every tap count class up to
1025, real and complex; chopped streams bit for bit; the next context
the launch writes; one K4 launch a call and none counted as the
decimating FIR's.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a CUDA device the tests skip: the kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from _k2_replay import k4_replay
from comms_tpu_torch.kernels import decim_fir as TDF
from comms_tpu_torch.kernels import fir as TFK

# float32 on both sides in other summation orders (the bound of
# tests/test_torch_qpsk_cuda.py).
TOL_FIR = 5e-5
TAPS = [1, 2, 31, 32, 33, 129, 257, 1024, 1025]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


def _taps(rng, T, cplx):
    h = rng.normal(size=T)
    return h + 1j * rng.normal(size=T) if cplx else h


def _planes(rng, shape, dev):
    return tuple(torch.from_numpy(rng.normal(size=shape).astype(np.float32))
                 .to(dev) for _ in range(2))


def _ctx(rng, dev):
    return tuple(c.reshape(8, 128) for c in _planes(rng, 1024, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("T", TAPS)
def test_kernel_matches_plain_and_replay(cuda, T, cplx):
    rng = np.random.default_rng(10 * T + cplx)
    h = _taps(rng, T, cplx)
    N = 3 * 1024
    xr, xi = _planes(rng, N, cuda)
    cr, ci = _ctx(rng, cuda)
    n4, n2 = TFK.launches, TDF.launches
    yr, yi, nr, ni = TFK.fir_planar(xr, xi, h, cr, ci, tile_rows=8)
    assert (TFK.launches, TDF.launches) == (n4 + 1, n2)
    wr, wi = TFK.fir_plain(xr, xi, h, cr, ci)
    torch.cuda.synchronize()
    g = torch.complex(yr, yi)
    assert g.shape == (N,) and torch.isfinite(g).all()
    assert _err(g, torch.complex(wr, wi)) < TOL_FIR
    rep = k4_replay(*(t.cpu().numpy() for t in (xr, xi)), h,
                    *(t.cpu().numpy() for t in (cr, ci)))
    rep = torch.complex(*(torch.from_numpy(v) for v in rep))
    assert _err(g.cpu(), rep) < TOL_FIR
    # the launch also writes the next context: the block's last 1024
    assert nr.shape == (8, 128) and ni.shape == (8, 128)
    assert torch.equal(nr.reshape(-1), xr[-1024:])
    assert torch.equal(ni.reshape(-1), xi[-1024:])


@pytest.mark.cuda
@pytest.mark.parametrize("T,cplx,parts", [
    (32, False, (3, 7, 1)), (1, False, (1, 2, 1)), (257, True, (1, 5, 3)),
    (1025, True, (2, 1, 4)), (33, True, (5, 1, 1))])
def test_chopped_streams_are_bit_identical(cuda, T, cplx, parts):
    # split at multiples of the quantum (tile_rows 8: 1,024 samples): the
    # outputs and the carried context chain to the one-shot call's bits
    rng = np.random.default_rng(T + 7)
    h = _taps(rng, T, cplx)
    q = 1024
    N = q * sum(parts)
    xr, xi = _planes(rng, N, cuda)
    cr, ci = _ctx(rng, cuda)
    one = TFK.fir_planar(xr, xi, h, cr, ci, tile_rows=8)
    outs, c, at = [], (cr, ci), 0
    for p in parts:
        a, b = at * q, (at + p) * q
        y = TFK.fir_planar(xr[a:b].contiguous(), xi[a:b].contiguous(), h,
                           *c, tile_rows=8)
        outs.append(y[:2])
        c, at = y[2:], at + p
    assert torch.equal(torch.cat([o[0] for o in outs]), one[0])
    assert torch.equal(torch.cat([o[1] for o in outs]), one[1])
    assert torch.equal(c[0], one[2]) and torch.equal(c[1], one[3])


@pytest.mark.cuda
@pytest.mark.parametrize("N,tile_rows", [(1024, 8), (1 << 20, 1024),
                                         (3 * (1 << 18), 64)])
def test_call_sizes(cuda, N, tile_rows):
    # one tile of 64 threads, a call of 128-thread tiles, and between
    rng = np.random.default_rng(N)
    h = rng.normal(size=32)
    xr, xi = _planes(rng, N, cuda)
    cr, ci = _ctx(rng, cuda)
    yr, yi, nr, ni = TFK.fir_planar(xr, xi, h, cr, ci, tile_rows=tile_rows)
    wr, wi = TFK.fir_plain(xr, xi, h, cr, ci)
    torch.cuda.synchronize()
    assert _err(torch.complex(yr, yi), torch.complex(wr, wi)) < TOL_FIR
    assert torch.equal(nr.reshape(-1), xr[-1024:])


@pytest.mark.cuda
def test_one_launch_a_call(cuda):
    rng = np.random.default_rng(3)
    xr, xi = _planes(rng, 8 * 1024, cuda)
    cr, ci = _ctx(rng, cuda)
    x = torch.complex(*_planes(rng, 5000, cuda))
    ctx = torch.complex(*_planes(rng, 62, cuda))
    n4, n2 = TFK.launches, TDF.launches
    for k in range(3):
        TFK.fir_planar(xr, xi, np.ones(32), cr, ci, tile_rows=8)
        TFK.fir_block(x, np.hanning(63), ctx)
        assert TFK.launches == n4 + 2 * (k + 1)
    assert TDF.launches == n2


@pytest.mark.cuda
@pytest.mark.parametrize("T,cplx", [(63, True), (33, False)])
def test_fir_block_matches_the_cpu_path(cuda, T, cplx):
    rng = np.random.default_rng(T)
    h = _taps(rng, T, cplx)
    x = torch.complex(*_planes(rng, 5000, "cpu"))
    ctx = torch.complex(*_planes(rng, T - 1, "cpu"))
    want, want_ctx = TFK.fir_block(x, h, ctx)
    got, got_ctx = TFK.fir_block(x.to(cuda), h, ctx.to(cuda))
    torch.cuda.synchronize()
    assert got.shape == (5000,)
    assert _err(got.cpu(), want) < TOL_FIR
    assert torch.equal(got_ctx.cpu(), want_ctx)


@pytest.mark.cuda
def test_unaligned_planes_read_sample_by_sample(cuda):
    # planes that are not 16-byte aligned take the kernel's plain loads:
    # the same bits as aligned planes
    rng = np.random.default_rng(5)
    N = 3 * 1024
    base = _planes(rng, N + 1, cuda)
    xr, xi = base[0][1:], base[1][1:]
    assert xr.data_ptr() % 16
    cr, ci = _ctx(rng, cuda)
    h = _taps(rng, 129, True)
    got = TFK.fir_planar(xr, xi, h, cr, ci, tile_rows=8)
    ref = TFK.fir_planar(xr.clone(), xi.clone(), h, cr, ci, tile_rows=8)
    assert all(torch.equal(a, b) for a, b in zip(got, ref))
