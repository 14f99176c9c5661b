"""comms_tpu_torch.ops.fir against comms_tpu.ops.fir: the same numpy
inputs through both, at the tolerances stated per test."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.ops import fir as jfir
from comms_tpu_torch.ops import fir as tfir

HELPER_TAPS = np.random.default_rng(11).normal(size=63)
# f32: summation order differs (torch.matmul vs XLA dot), ~1e-7 relative
# per product; 1e-5 absolute on unit-scale signals.  f64: 1e-10.
TOL = {np.float32: 1e-5, np.float64: 1e-10}
CPLX = {np.float32: np.complex64, np.float64: np.complex128}


def _signal(rng, n, dtype, complex_):
    x = rng.normal(size=n)
    if complex_:
        return (x + 1j * rng.normal(size=n)).astype(CPLX[dtype])
    return x.astype(dtype)


def _taps(dtype, complex_):
    rng = np.random.default_rng(3)
    t = rng.normal(size=63) * 0.1
    if complex_:
        return (t + 1j * rng.normal(size=63) * 0.1).astype(CPLX[dtype])
    return t.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float32, np.float64, np.complex64,
                                   np.complex128])
@pytest.mark.parametrize("phases", [128, 16])
def test_banded_tap_matrix_equals_jax(dtype, phases):
    taps = HELPER_TAPS.astype(dtype)
    got = tfir.banded_tap_matrix(taps, phases)
    want = jfir.banded_tap_matrix(taps, phases)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate", [2, 5, 8])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_decimating_helpers_equal_jax(rate, dtype):
    taps = HELPER_TAPS.astype(dtype)
    C = tfir.decimating_branch_taps(taps, rate)
    np.testing.assert_array_equal(C, jfir.decimating_branch_taps(taps, rate))
    flat = np.zeros(C.size, dtype)
    flat[:63] = taps
    np.testing.assert_array_equal(
        tfir._decimating_banded_matrix(flat, rate, 128),
        jfir._decimating_banded_matrix(flat, rate, 128))


@pytest.mark.parametrize("real", [np.float32, np.float64])
@pytest.mark.parametrize("complex_x,complex_taps",
                         [(False, False), (True, False), (True, True)])
def test_fir_block_matches_jax(real, complex_x, complex_taps):
    rng = np.random.default_rng(0)
    n = 1000
    x = _signal(rng, n, real, complex_x)
    taps = _taps(real, complex_taps)
    ctx = _signal(rng, 62, real, complex_x)
    y_j, c_j = jfir.fir_block(jnp.asarray(x), taps, jnp.asarray(ctx))
    y_t, c_t = tfir.fir_block(torch.from_numpy(x), taps,
                              torch.from_numpy(ctx))
    assert y_t.numpy().dtype == np.asarray(y_j).dtype
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=TOL[real])
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


@pytest.mark.parametrize("real", [np.float32, np.float64])
@pytest.mark.parametrize("complex_x", [False, True])
@pytest.mark.parametrize("rate", [5, 4])
def test_fir_decimate_poly_matches_jax(real, complex_x, rate):
    rng = np.random.default_rng(1)
    n = 200 * rate * 3
    x = _signal(rng, n, real, complex_x)
    C = tfir.decimating_branch_taps(_taps(real, False), rate)
    ctx = _signal(rng, C.size - 1, real, complex_x)
    y_j, c_j = jfir.fir_decimate_poly(jnp.asarray(x), C, jnp.asarray(ctx))
    y_t, c_t = tfir.fir_decimate_poly(torch.from_numpy(x), C,
                                      torch.from_numpy(ctx))
    assert y_t.shape == (n // rate,)
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), rtol=0,
                               atol=TOL[real])
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))


def test_fir_decimate_poly_rejects_ragged_block():
    C = tfir.decimating_branch_taps(_taps(np.float32, False), 5)
    with pytest.raises(ValueError, match="multiple of rate"):
        tfir.fir_decimate_poly(torch.zeros(12), C, torch.zeros(C.size - 1))


@pytest.mark.parametrize("kind", ["dense", "poly"])
def test_streaming_three_blocks_equals_one_shot(kind):
    # f64 so that the comparison is about block seams, not rounding.
    rng = np.random.default_rng(2)
    n = 3 * 640
    x = torch.from_numpy(_signal(rng, n, np.float64, True))
    taps = _taps(np.float64, False)
    if kind == "dense":
        step = lambda xb, c: tfir.fir_block(xb, taps, c)  # noqa: E731
        ctx0 = tfir.init_ctx(63, torch.complex128, device="cpu")
    else:
        C = tfir.decimating_branch_taps(taps, 5)
        step = lambda xb, c: tfir.fir_decimate_poly(xb, C, c)  # noqa: E731
        ctx0 = tfir.init_ctx(C.size, torch.complex128, device="cpu")
    once, _ = step(x, ctx0)
    outs, ctx = [], ctx0
    for b in range(3):
        y, ctx = step(x[b * 640:(b + 1) * 640], ctx)
        outs.append(y)
    np.testing.assert_allclose(torch.cat(outs).numpy(), once.numpy(),
                               rtol=0, atol=1e-12)
