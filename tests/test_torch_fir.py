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


def _oracle_batch_fir(x, taps, state):
    """The reference's direct form (tests/test_fir.py): state
    rotate_right(1); state[0] = x; dot."""
    state = list(state)
    out = []
    for s in x:
        state = [state[-1]] + state[:-1]
        state[0] = s
        out.append(sum(t * v for t, v in zip(taps, state)))
    return np.array(out)


@pytest.mark.parametrize("dtype", [np.complex64, np.complex128,
                                   np.float64])
def test_ctx_from_reference_state_equals_jax(dtype):
    ref_state = np.array([1.0, 0.5, 0.25, 0.125], dtype=dtype)
    tdt = torch.from_numpy(np.zeros(1, dtype)).dtype
    got = tfir.ctx_from_reference_state(ref_state, dtype=tdt, device="cpu")
    want = np.asarray(jfir.ctx_from_reference_state(ref_state,
                                                    dtype=jnp.dtype(dtype)))
    assert got.dtype == tdt
    np.testing.assert_array_equal(got.numpy(), want)
    # tests/test_fir.py:46 on the port: the fir.rs doc example from a
    # reference state, against the direct form
    taps = np.array([0.2, 0.6, 0.6, 0.2], dtype=np.complex128)
    x = np.cos(np.arange(20)).astype(np.complex128)
    ctx = tfir.ctx_from_reference_state(
        np.array([1.0, 0.5, 0.25, 0.125], np.complex128),
        dtype=torch.complex128, device="cpu")
    y, _ = tfir.fir_block(torch.from_numpy(x), taps, ctx)
    np.testing.assert_allclose(
        y.numpy(), _oracle_batch_fir(x, taps, [1.0, 0.5, 0.25, 0.125]),
        atol=1e-12)


@pytest.mark.parametrize("real", [np.float32, np.float64])
@pytest.mark.parametrize("T", [1, 63])
def test_fir_apply_matches_jax(real, T):
    rng = np.random.default_rng(T)
    taps = rng.normal(size=T).astype(real)
    x = rng.normal(size=500).astype(real)
    got = tfir.fir_apply(torch.from_numpy(x), taps)
    want = np.asarray(jfir.fir_apply(jnp.asarray(x), taps))
    assert got.dtype == torch.from_numpy(x).dtype
    np.testing.assert_allclose(got.numpy(), want, atol=TOL[real], rtol=0)
    if real == np.float64:
        # tests/test_fir.py:77 on the port: against the direct form
        np.testing.assert_allclose(
            got.numpy(), _oracle_batch_fir(x, taps, np.zeros(T)),
            atol=1e-10)
    # a precomputed band matrix gives the same output
    got_b = tfir.fir_apply(torch.from_numpy(x), tfir.banded_tap_matrix(taps))
    np.testing.assert_array_equal(got_b.numpy(), got.numpy())


@pytest.mark.parametrize("rate", [0, 1, 3, 5])
@pytest.mark.parametrize("complex_", [False, True])
def test_fir_decimate_block_matches_jax(rate, complex_):
    rng = np.random.default_rng(2 + rate)
    taps = rng.normal(size=17)
    x = _signal(rng, 300, np.float64, complex_)
    jdt = jnp.complex128 if complex_ else jnp.float64
    tdt = torch.complex128 if complex_ else torch.float64
    yj, cj = jfir.fir_decimate_block(jnp.asarray(x), taps,
                                     jfir.init_ctx(17, dtype=jdt), rate=rate)
    ctx = tfir.init_ctx(17, dtype=tdt, device="cpu")
    y1, c1 = tfir.fir_decimate_block(torch.from_numpy(x[:150]), taps, ctx,
                                     rate)
    y2, c2 = tfir.fir_decimate_block(torch.from_numpy(x[150:]), taps, c1,
                                     rate)
    y, c = tfir.fir_decimate_block(torch.from_numpy(x), taps, ctx, rate)
    np.testing.assert_allclose(y.numpy(), np.asarray(yj), atol=1e-10)
    np.testing.assert_allclose(c.numpy(), np.asarray(cj), atol=0)
    # the phase resets each block (DecimateNode); 150 is a multiple of
    # every rate here, so two half blocks equal one block
    np.testing.assert_allclose(torch.cat([y1, y2]).numpy(), y.numpy(),
                               atol=1e-12)
    np.testing.assert_array_equal(c2.numpy(), c.numpy())
