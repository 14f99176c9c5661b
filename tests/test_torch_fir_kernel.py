"""The streaming FIR kernel's entries (the contract of the JAX package's
fir_pallas) against that Pallas kernel in interpret mode, at the cases
of tests/test_kernels.py.  Here the wrappers run the plain PyTorch
version, because the tensors lie on the CPU; the kernel itself is
compared with it on the card by tests/test_torch_qpsk_cuda.py and
chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import fir_pallas as JFP
from comms_tpu_torch.kernels import fir as TFK

# The JAX kernel's bf16x3 products against float32 here (its own bound,
# tests/test_kernels.py).
TOL = 5e-5


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / float(np.max(np.abs(want)))


def _cx(rng, n):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex64)


@pytest.mark.parametrize("N,T,tile_rows,seed", [(40000, 63, 16, 0),
                                                (5000, 33, 8, 1),
                                                (4096, 257, None, 30)])
def test_fir_block_matches_jax_kernel(N, T, tile_rows, seed):
    rng = np.random.default_rng(seed)
    taps = _cx(rng, T) if seed != 1 else rng.normal(size=T).astype(
        np.complex64)
    x = _cx(rng, N)
    ctx = _cx(rng, T - 1)
    want, want_ctx = JFP.fir_block_pallas(jnp.asarray(x), taps,
                                          jnp.asarray(ctx),
                                          tile_rows=tile_rows, interpret=True)
    n0 = TFK.launches
    got, got_ctx = TFK.fir_block(torch.from_numpy(x), taps,
                                 torch.from_numpy(ctx), tile_rows=tile_rows)
    assert TFK.launches == n0                 # CPU tensors: no kernel
    assert got.shape == (N,)
    assert _rel(got.numpy(), want) < TOL
    np.testing.assert_array_equal(got_ctx.numpy(), np.asarray(want_ctx))


@pytest.mark.parametrize("real_taps", [False, True])
def test_fir_planar_streaming_matches_jax_kernel(real_taps):
    """Two blocks with the carried [8, 128] context reproduce the one-shot
    output exactly, and match the JAX kernel's stream."""
    rng = np.random.default_rng(7 + real_taps)
    T = 63
    taps = (rng.normal(size=T).astype(np.float32) if real_taps
            else _cx(rng, T))
    N = 16 * 128 * 4
    xr = rng.normal(size=N).astype(np.float32)
    xi = rng.normal(size=N).astype(np.float32)
    h = N // 2

    def stream(mod, to, zero):
        cr, ci = zero()
        out_r, out_i = [], []
        for a, b in ((0, h), (h, N)):
            yr, yi, cr, ci = mod(to(xr[a:b]), to(xi[a:b]), taps, cr, ci,
                                 tile_rows=16)
            out_r.append(np.asarray(yr))
            out_i.append(np.asarray(yi))
        return np.concatenate(out_r) + 1j * np.concatenate(out_i)

    def jax_fir(*a, **kw):
        return JFP.fir_planar_pallas(*a, interpret=True, **kw)

    want = stream(jax_fir, jnp.asarray, JFP.planar_ctx_zero)
    got = stream(TFK.fir_planar, lambda v: torch.from_numpy(v.copy()),
                 lambda: TFK.planar_ctx_zero(device="cpu"))
    cr, ci = TFK.planar_ctx_zero(device="cpu")
    yr, yi, _, _ = TFK.fir_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                  taps, cr, ci, tile_rows=16)
    np.testing.assert_array_equal(got, yr.numpy() + 1j * yi.numpy())
    assert _rel(got, want) < TOL


def test_fir_planar_single_tap_gain():
    rng = np.random.default_rng(12)
    N = 8 * 128
    xr = rng.normal(size=N).astype(np.float32)
    xi = rng.normal(size=N).astype(np.float32)
    cr, ci = TFK.planar_ctx_zero(device="cpu")
    yr, yi, _, _ = TFK.fir_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                  np.array([2.0], np.float32), cr, ci,
                                  tile_rows=8)
    np.testing.assert_allclose(yr.numpy(), 2.0 * xr, atol=1e-6)
    np.testing.assert_allclose(yi.numpy(), 2.0 * xi, atol=1e-6)


def test_fir_next_context_is_the_tail():
    x = torch.arange(2048, dtype=torch.float32)
    cr, ci = TFK.planar_ctx_zero(device="cpu")
    _, _, nr, ni = TFK.fir_planar(x, -x, np.ones(3), cr, ci, tile_rows=8)
    assert nr.shape == (8, 128)
    np.testing.assert_array_equal(nr.reshape(-1).numpy(), x[-1024:].numpy())
    tr, ti = TFK.planar_ctx_from_tail(x, -x)
    assert torch.equal(tr, nr) and torch.equal(ti, ni)


def test_fir_validation_errors():
    cr, ci = TFK.planar_ctx_zero(device="cpu")
    z = torch.zeros(1024)
    with pytest.raises(ValueError, match="1025"):
        TFK.fir_block(torch.zeros(2048, dtype=torch.complex64),
                      np.zeros(1026, np.complex64),
                      torch.zeros(1025, dtype=torch.complex64))
    with pytest.raises(ValueError, match="1025"):
        TFK.fir_planar(z, z, np.zeros(1026), cr, ci, tile_rows=8)
    with pytest.raises(ValueError, match="multiple"):
        TFK.fir_planar(torch.zeros(1000), torch.zeros(1000),
                       np.ones(5, np.float32), cr, ci, tile_rows=16)
    with pytest.raises(ValueError, match="mode"):
        TFK.fir_planar(z, z, np.ones(5), cr, ci, tile_rows=8, mode="fp8")
    with pytest.raises(ValueError, match="multiple of 8"):
        TFK.fir_planar(z, z, np.ones(5), cr, ci, tile_rows=12)
    with pytest.raises(ValueError, match="1024 samples"):
        TFK.fir_planar(z, z, np.ones(5), cr[:4], ci[:4], tile_rows=8)


@pytest.mark.parametrize("N,cplx_taps", [(2048, False), (2048, True),
                                         (5000, False)])
def test_fir_block_real_stream_matches_jax_op(N, cplx_taps):
    """A float32 stream (its imaginary plane zero): a real output through
    real taps, a complex one through complex taps; the new context is
    the block's tail, from the kernel's next context where the block
    fills its tiles and from the block itself where it is padded."""
    from comms_tpu.ops import fir as jfir
    rng = np.random.default_rng(N + cplx_taps)
    T = 33
    taps = _cx(rng, T) if cplx_taps else rng.normal(size=T).astype(
        np.float32)
    x = rng.normal(size=N).astype(np.float32)
    ctx = rng.normal(size=T - 1).astype(np.float32)
    want, want_ctx = jfir.fir_block(jnp.asarray(x), taps, jnp.asarray(ctx))
    got, got_ctx = TFK.fir_block(torch.from_numpy(x), taps,
                                 torch.from_numpy(ctx),
                                 tile_rows=8 if N % 1024 == 0 else None)
    assert got.is_complex() == cplx_taps
    assert _rel(got.numpy(), want) < TOL
    assert got_ctx.dtype == torch.float32
    np.testing.assert_array_equal(got_ctx.numpy(), np.asarray(want_ctx))
