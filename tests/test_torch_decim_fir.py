"""The decimating-FIR kernel's two entries (the contracts of the JAX
package's decim_fir_pallas and poly_fir_pallas kernels) against those
Pallas kernels in interpret mode.  Here the wrappers run the plain
PyTorch version, because the tensors lie on the CPU; the kernel itself
is compared with it on the card by tests/test_torch_band_monitor_cuda.py
and chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import decim_fir_pallas as JDF
from comms_tpu.kernels import poly_fir_pallas as JPF
from comms_tpu_torch.kernels import decim_fir as TDF

# The JAX kernels' own parity bounds: the bf16x3 split entry at 5e-5
# relative (tests/test_decim_fir_pallas.py), the HIGHEST-precision poly
# entry at 1e-5 (tests/test_poly_fir_pallas.py).
TOL_SPLIT = 5e-5
TOL_POLY = 1e-5


def _x(rng, n):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(
        np.complex64)


def _split_pair(x, taps, dec, tile_rows=16):
    cr, ci = JDF.decim_ctx_zero(dec)
    want = JDF.fir_decimate_planar_pallas(
        jnp.asarray(x.real.copy()), jnp.asarray(x.imag.copy()), taps, dec,
        cr, ci, tile_rows=tile_rows, interpret=True)
    tr, ti = TDF.decim_ctx_zero(dec, device="cpu")
    launches = TDF.launches
    got = TDF.fir_decimate_planar(
        torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()),
        taps, dec, tr, ti, tile_rows=tile_rows)
    assert TDF.launches == launches          # CPU tensors: no kernel
    return ([np.asarray(w) for w in want], [g.numpy() for g in got])


def _assert_close(got, want, tol):
    g = got[0] + 1j * got[1]
    w = want[0] + 1j * want[1]
    assert g.shape == w.shape
    assert np.max(np.abs(g - w)) < tol * np.max(np.abs(w))


@pytest.mark.parametrize("dec,taps_len", [(5, 63), (4, 12), (2, 33),
                                          (3, 1), (5, 640)])
def test_split_entry_matches_jax_kernel(dec, taps_len):
    rng = np.random.default_rng(dec * 100 + taps_len)
    N = 16 * dec * 128 * 2
    x = _x(rng, N)
    taps = rng.normal(size=taps_len).astype(np.float32)
    want, got = _split_pair(x, taps, dec)
    assert got[0].shape == (N // dec,)
    _assert_close(got, want, TOL_SPLIT)
    np.testing.assert_array_equal(got[2], np.asarray(want[2]))
    np.testing.assert_array_equal(got[3], np.asarray(want[3]))


def test_split_entry_complex_taps():
    rng = np.random.default_rng(7)
    dec = 5
    x = _x(rng, 16 * dec * 128 * 2)
    taps = (rng.normal(size=63) + 1j * rng.normal(size=63)).astype(
        np.complex64)
    want, got = _split_pair(x, taps, dec)
    _assert_close(got, want, TOL_SPLIT)


@pytest.mark.parametrize("dec", [1, 2, 5])
def test_split_entry_max_taps(dec):
    T = TDF.max_taps(dec)
    assert T == JDF.max_taps(dec)
    rng = np.random.default_rng(T)
    x = _x(rng, 16 * dec * 128)
    taps = rng.normal(size=T).astype(np.float32)
    want, got = _split_pair(x, taps, dec)
    _assert_close(got, want, TOL_SPLIT)
    z = torch.zeros(16 * dec * 128)
    cr, ci = TDF.decim_ctx_zero(dec, device="cpu")
    with pytest.raises(ValueError, match="taps"):
        TDF.fir_decimate_planar(z, z, np.ones(T + 1, np.float32), dec, cr,
                                ci, tile_rows=16)


def test_split_entry_mid_stream_ctx_and_batch_rows():
    # A batch of rows is the same as each row alone, from a carried
    # context of which only the last MD-1 samples count.
    rng = np.random.default_rng(11)
    dec, T = 4, 30                         # MD = 32: ragged taps
    N = 8 * dec * 128
    W = dec * 128
    xr = rng.normal(size=(3, N)).astype(np.float32)
    xi = rng.normal(size=(3, N)).astype(np.float32)
    cr = rng.normal(size=(3, W)).astype(np.float32)
    ci = rng.normal(size=(3, W)).astype(np.float32)
    taps = np.hanning(T).astype(np.float32)
    yr, yi, nr, ni = TDF.fir_decimate_planar(
        torch.from_numpy(xr), torch.from_numpy(xi), taps, dec,
        torch.from_numpy(cr), torch.from_numpy(ci), tile_rows=8)
    assert yr.shape == (3, N // dec) and nr.shape == (3, W)
    for b in range(3):
        want = JDF.fir_decimate_planar_pallas(
            jnp.asarray(xr[b]), jnp.asarray(xi[b]), taps, dec,
            jnp.asarray(cr[b:b + 1]), jnp.asarray(ci[b:b + 1]),
            tile_rows=8, interpret=True)
        _assert_close([yr[b].numpy(), yi[b].numpy()],
                      [np.asarray(want[0]), np.asarray(want[1])], TOL_SPLIT)
        np.testing.assert_array_equal(nr[b:b + 1].numpy(),
                                      np.asarray(want[2]))


def test_split_entry_validation_errors():
    cr, ci = TDF.decim_ctx_zero(5, device="cpu")
    z = torch.zeros(5 * 128 * 16)
    with pytest.raises(ValueError, match="taps"):
        TDF.fir_decimate_planar(z, z, np.ones(5 * 128 + 2, np.float32), 5,
                                cr, ci, tile_rows=16)
    with pytest.raises(ValueError, match="multiple"):
        TDF.fir_decimate_planar(torch.zeros(1000), torch.zeros(1000),
                                np.ones(5, np.float32), 5, cr, ci,
                                tile_rows=16)
    with pytest.raises(ValueError, match="mode"):
        TDF.fir_decimate_planar(z, z, np.ones(5), 5, cr, ci, tile_rows=16,
                                mode="fast")
    with pytest.raises(ValueError, match="tile_rows"):
        TDF.fir_decimate_planar(z, z, np.ones(5), 5, cr, ci, tile_rows=12)
    with pytest.raises(ValueError, match="samples per row"):
        TDF.fir_decimate_planar(z, z, np.ones(5), 5, cr[:, :100],
                                ci[:, :100], tile_rows=16)


def _poly_pair(x, taps, dec, ctx):
    want = JPF.poly_fir_pallas(jnp.asarray(x), taps, jnp.asarray(ctx), dec,
                               interpret=True)
    got = TDF.poly_fir(torch.from_numpy(x), taps, torch.from_numpy(ctx),
                       dec)
    return np.asarray(want[0]), got[0].numpy(), np.asarray(want[1]), got[1]


@pytest.mark.parametrize("dec,taps_len,cplx", [(5, 63, False),
                                               (4, 48, True),
                                               (5, 256, False)])
def test_poly_entry_matches_jax_kernel(dec, taps_len, cplx):
    rng = np.random.default_rng(taps_len)
    x = _x(rng, TDF.step_samples(dec))
    taps = rng.normal(size=taps_len)
    if cplx:
        taps = taps + 1j * rng.normal(size=taps_len)
    ctx = _x(rng, TDF.CTX_ROWS * dec * 128)
    want, got, wctx, gctx = _poly_pair(x, taps, dec, ctx)
    assert got.shape == want.shape == (x.shape[0] // dec,)
    assert np.max(np.abs(got - want)) < TOL_POLY * np.abs(want).max()
    np.testing.assert_array_equal(gctx.numpy(), wctx)


def test_poly_entry_streams_641_taps():
    rng = np.random.default_rng(21)
    taps = rng.normal(size=641)
    N = TDF.step_samples(5)
    x = _x(rng, 2 * N)
    L = TDF.CTX_ROWS * 5 * 128
    jctx = jnp.zeros(L, jnp.complex64)
    tctx = torch.zeros(L, dtype=torch.complex64)
    want, got = [], []
    for b in range(2):
        w, jctx = JPF.poly_fir_pallas(jnp.asarray(x[b * N:(b + 1) * N]),
                                      taps, jctx, 5, interpret=True)
        g, tctx = TDF.poly_fir(torch.from_numpy(x[b * N:(b + 1) * N]), taps,
                               tctx, 5)
        want.append(np.asarray(w))
        got.append(g.numpy())
    want, got = np.concatenate(want), np.concatenate(got)
    assert np.max(np.abs(got - want)) < TOL_POLY * np.abs(want).max()


def test_poly_entry_rejections():
    z = torch.zeros(TDF.step_samples(2), dtype=torch.complex64)
    c = torch.zeros(TDF.CTX_ROWS * 2 * 128, dtype=torch.complex64)
    with pytest.raises(ValueError, match="dec\\*128"):
        TDF.poly_fir(z, np.ones(258), c, 2)
    with pytest.raises(ValueError, match="dec must be in"):
        TDF.poly_fir(z, np.ones(8), c, 9)
    with pytest.raises(ValueError, match="multiple"):
        TDF.poly_fir(z[:1000], np.ones(8), c, 2)
    with pytest.raises(ValueError, match="ctx must be"):
        TDF.poly_fir(z, np.ones(8), c[:100], 2)


@pytest.mark.parametrize("x_cplx,taps_cplx", [(True, False), (False, False),
                                              (False, True), (True, True)])
def test_block_entry_matches_jax_op(x_cplx, taps_cplx):
    """``fir_decimate_block`` carries the JAX op's MD-1 state: two chained
    blocks from a mid-stream state match ``ops.fir.fir_decimate_poly``,
    and each new state equals the JAX op's."""
    from comms_tpu.ops import fir as jfir
    rng = np.random.default_rng(10 * x_cplx + taps_cplx)
    dec, T = 5, 63
    MD = dec * -(-T // dec)
    N = 8 * dec * 128 * 2
    taps = _x(rng, T) if taps_cplx else rng.normal(size=T).astype(
        np.float32)
    Hb = jfir.decimating_branch_taps(taps, dec)
    def stream(n):
        return _x(rng, n) if x_cplx else rng.normal(size=n).astype(
            np.float32)
    ctx = stream(MD - 1)
    jc, tc = jnp.asarray(ctx), torch.from_numpy(ctx)
    for _ in range(2):
        x = stream(N)
        want, jc = jfir.fir_decimate_poly(jnp.asarray(x), Hb, jc)
        launches = TDF.launches
        got, tc = TDF.fir_decimate_block(torch.from_numpy(x), taps, dec, tc)
        assert TDF.launches == launches      # CPU tensors: no kernel
        assert got.is_complex() == (x_cplx or taps_cplx)
        w = np.asarray(want)
        assert got.shape == w.shape == (N // dec,)
        assert np.max(np.abs(got.numpy() - w)) < TOL_SPLIT * np.max(np.abs(w))
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))
