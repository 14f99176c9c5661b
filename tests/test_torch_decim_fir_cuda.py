"""The decimating-FIR kernel (both entries: K2's ``fir_decimate_planar``
and K3's ``poly_fir_planar``) on a CUDA card, against its plain version
and the CPU replay of its plan (tests/_k2_replay.py): every D in 1..8 at
its most taps, real and complex, the run-time-D path, K3's context,
calls of every size class, one launch a call, and chopped streams bit for
bit.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a CUDA device the tests skip: the kernel has no CPU mode.
"""

import numpy as np
import pytest
import torch

from _k2_replay import k2_replay
from comms_tpu_torch.kernels import decim_fir as TDF

# float32 on both sides in other summation orders (the bound of
# tests/test_torch_band_monitor_cuda.py).
TOL_FIR = 5e-5


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


def _check(got, xr, xi, h, dec, cr, ci, replay=False):
    want = TDF.fir_decimate_plain(xr, xi, h, dec, cr, ci)
    torch.cuda.synchronize()
    g, w = torch.complex(got[0], got[1]), torch.complex(*want)
    assert g.shape == w.shape and torch.isfinite(g).all()
    assert _err(g, w) < TOL_FIR
    if replay:
        rows = 1 if xr.ndim == 1 else xr.shape[0]
        r = k2_replay(*(t.cpu().numpy().reshape(rows, -1)
                        for t in (xr, xi)), h, dec,
                      tuple(t.cpu().numpy().reshape(rows, -1)
                            for t in (cr, ci)))
        rep = torch.complex(*(torch.from_numpy(v).reshape(g.shape)
                              for v in r))
        assert _err(g.cpu(), rep) < TOL_FIR


@pytest.mark.cuda
@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("dec", list(range(1, 9)))
def test_every_dec_at_its_most_taps(cuda, dec, cplx):
    rng = np.random.default_rng(10 * dec + cplx)
    h = _taps(rng, TDF.max_taps(dec), cplx)
    N = 3 * 8 * dec * 128
    xr, xi = _planes(rng, (2, N), cuda)
    cr, ci = _planes(rng, (2, dec * 128), cuda)
    n = TDF.launches
    got = TDF.fir_decimate_planar(xr, xi, h, dec, cr, ci, tile_rows=8)
    assert TDF.launches == n + 1
    _check(got, xr, xi, h, dec, cr, ci, replay=True)
    # the launch also writes the next context: each row's last samples
    assert torch.equal(got[2], xr[:, -dec * 128:])
    assert torch.equal(got[3], xi[:, -dec * 128:])


@pytest.mark.cuda
@pytest.mark.parametrize("dec,T", [(9, 5), (9, 9 * 128), (12, 40)])
def test_run_time_dec_path(cuda, dec, T):
    rng = np.random.default_rng(dec + T)
    h = _taps(rng, T, False)
    N = 2 * 8 * dec * 128
    xr, xi = _planes(rng, (3, N), cuda)
    cr, ci = _planes(rng, (3, dec * 128), cuda)
    got = TDF.fir_decimate_planar(xr, xi, h, dec, cr, ci, tile_rows=8)
    _check(got, xr, xi, h, dec, cr, ci)


@pytest.mark.cuda
@pytest.mark.parametrize("dec,T,cplx", [(5, 63, False), (5, 641, False),
                                        (5, 641, True)]
                         + [(d, d * 128 + 1, d % 2 == 0)
                            for d in range(2, 9)])
def test_poly_entry_k3_context(cuda, dec, T, cplx):
    rng = np.random.default_rng(dec * T)
    h = _taps(rng, T, cplx)
    re, im = _planes(rng, TDF.step_samples(dec), cuda)
    cr, ci = _planes(rng, TDF.CTX_ROWS * dec * 128, cuda)
    n = TDF.launches
    yr, yi, nr, ni = TDF.poly_fir_planar(re, im, h, cr, ci, dec)
    assert TDF.launches == n + 1
    _check((yr, yi), re, im, h, dec, cr, ci, replay=T < 100)
    assert torch.equal(nr, re[-cr.shape[0]:])
    assert torch.equal(ni, im[-ci.shape[0]:])


@pytest.mark.cuda
@pytest.mark.parametrize("rows,n_tiles", [(1, 1), (1, 3), (2, 40),
                                          (64, 4), (256, 1)])
def test_call_sizes(cuda, rows, n_tiles):
    # one tile, fewer tiles than SMs, many rows: N a multiple of the K2
    # quantum (tile_rows 8 at dec 4: 4,096 samples, 1,024 outputs)
    rng = np.random.default_rng(rows * 100 + n_tiles)
    dec = 4
    h = np.hanning(32)
    N = n_tiles * 8 * dec * 128
    xr, xi = _planes(rng, (rows, N), cuda)
    cr, ci = _planes(rng, (rows, dec * 128), cuda)
    got = TDF.fir_decimate_planar(xr, xi, h, dec, cr, ci, tile_rows=8)
    _check(got, xr, xi, h, dec, cr, ci)
    threads, tiles, blocks = TDF.partition(N // dec, rows, dec)
    assert 1 <= blocks <= tiles


@pytest.mark.cuda
def test_one_launch_a_call_on_both_entries(cuda):
    rng = np.random.default_rng(3)
    xr, xi = _planes(rng, (4, 8 * 4 * 128), cuda)
    cr, ci = _planes(rng, (4, 4 * 128), cuda)
    re, im = _planes(rng, TDF.step_samples(5), cuda)
    pc = _planes(rng, TDF.CTX_ROWS * 5 * 128, cuda)
    n = TDF.launches
    for k in range(3):
        TDF.fir_decimate_planar(xr, xi, np.ones(32), 4, cr, ci, tile_rows=8)
        TDF.poly_fir_planar(re, im, np.ones(63), *pc, 5)
        assert TDF.launches == n + 2 * (k + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dec,T,cplx,parts", [
    (4, 32, False, (3, 7, 1)), (5, 63, True, (1, 5, 3)),
    (1, 129, False, (7, 3, 5)), (8, 1024, False, (5, 1, 1)),
    (3, 200, True, (3, 3, 3))])
def test_chopped_streams_are_bit_identical(cuda, dec, T, cplx, parts):
    # split at odd multiples of the quantum (tile_rows 8): the outputs and
    # the carried context chain to the one-shot call's bits
    rng = np.random.default_rng(dec * T)
    h = _taps(rng, T, cplx)
    q = 8 * dec * 128
    N = q * sum(parts)
    xr, xi = _planes(rng, (2, N), cuda)
    cr, ci = _planes(rng, (2, dec * 128), cuda)
    one = TDF.fir_decimate_planar(xr, xi, h, dec, cr, ci, tile_rows=8)
    outs, c, at = [], (cr, ci), 0
    for p in parts:
        a, b = at * q, (at + p) * q
        y = TDF.fir_decimate_planar(xr[:, a:b].contiguous(),
                                    xi[:, a:b].contiguous(), h, dec, *c,
                                    tile_rows=8)
        outs.append(y[:2])
        c, at = y[2:], at + p
    assert torch.equal(torch.cat([o[0] for o in outs], 1), one[0])
    assert torch.equal(torch.cat([o[1] for o in outs], 1), one[1])
    assert torch.equal(c[0], one[2]) and torch.equal(c[1], one[3])


@pytest.mark.cuda
def test_unaligned_planes_read_sample_by_sample(cuda):
    # planes that are not 16-byte aligned take the kernel's plain loads:
    # the same bits as aligned planes
    rng = np.random.default_rng(5)
    dec, N = 5, 8 * 5 * 128 * 3
    base = _planes(rng, N + 1, cuda)
    xr, xi = base[0][1:], base[1][1:]
    assert xr.data_ptr() % 16
    cr, ci = _planes(rng, (1, dec * 128), cuda)
    h = _taps(rng, 63, True)
    got = TDF.fir_decimate_planar(xr, xi, h, dec, cr, ci, tile_rows=8)
    ref = TDF.fir_decimate_planar(xr.clone(), xi.clone(), h, dec, cr, ci,
                                  tile_rows=8)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    _check(got, xr, xi, h, dec, cr, ci)
