"""The port's ops/resample against the JAX package's: the reference doc
examples (resample_node.rs:44-52, :111-118), rate 0/1 passthroughs, the
streaming decimator's carried phase, and the rational P/Q resampler
against JAX and a float64 oracle (mirrors tests/test_resample.py).

Bounds: integer and index paths exact; the rational resampler equal to
JAX's matrices exactly and its output to JAX's within 1e-12 in
complex128 (the same GEMM on other BLAS), 1e-9 of the oracle (the JAX
test's bound)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.ops import resample as jres
from comms_tpu.ops import taps as jtaps
from comms_tpu_torch.ops import resample as tres

CPU = "cpu"


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_decimate_doc_example():
    data = np.array([1, 2, 3, 4, 5, 6, 7, 8])
    got = tres.decimate_block(_t(data), 3).numpy()
    assert np.array_equal(got, [1, 4, 7])
    assert np.array_equal(got, np.asarray(jres.decimate_block(data, 3)))


@pytest.mark.parametrize("rate", [0, 1])
def test_decimate_rate_0_1_passthrough(rate):
    data = np.array([1, 2, 3])
    assert np.array_equal(tres.decimate_block(_t(data), rate).numpy(),
                          [1, 2, 3])


def test_upsample_doc_example():
    data = np.array([1, 2, 3])
    got = tres.upsample_block(_t(data), 3).numpy()
    assert np.array_equal(got, [1, 0, 0, 2, 0, 0, 3, 0, 0])
    assert np.array_equal(got, np.asarray(jres.upsample_block(
        jnp.asarray(data), 3)))


@pytest.mark.parametrize("rate", [0, 1])
def test_upsample_rate_0_1_passthrough(rate):
    data = np.array([5, 6])
    assert np.array_equal(tres.upsample_block(_t(data), rate).numpy(),
                          [5, 6])


def test_decimate_stream_carries_phase():
    x = np.arange(24)
    offset = tres.decimate_stream_init(CPU)
    joff = jres.decimate_stream_init()
    got = []
    for i in range(4):
        y, offset = tres.decimate_stream(_t(x[i * 6:(i + 1) * 6]), offset, 3)
        jy, joff = jres.decimate_stream(jnp.asarray(x[i * 6:(i + 1) * 6]),
                                        joff, 3)
        assert np.array_equal(y.numpy(), np.asarray(jy))
        assert int(offset) == int(joff) and offset.dtype == torch.int32
        got.append(y.numpy())
    assert np.array_equal(np.concatenate(got), x[::3])
    with pytest.raises(ValueError):
        tres.decimate_stream(_t(x[:7]), offset, 3)


def test_decimate_stream_nonzero_offset():
    # A carried offset picks the column on the device (a gather).
    x = np.arange(12.0)
    y, off = tres.decimate_stream(_t(x), torch.tensor(2, dtype=torch.int32),
                                  3)
    jy, joff = jres.decimate_stream(jnp.asarray(x), jnp.int32(2), 3)
    assert np.array_equal(y.numpy(), np.asarray(jy))
    assert int(off) == int(joff)


def test_block_reset_vs_stream_differ_midblock():
    x = np.arange(8)
    a = tres.decimate_block(_t(x[:4]), 3).numpy()
    b = tres.decimate_block(_t(x[4:]), 3).numpy()
    assert np.array_equal(np.concatenate([a, b]), [0, 3, 4, 7])


def _rational_oracle(x, h, P, Q):
    """zero-stuff by P -> causal FIR(h) -> keep every Q (float64)."""
    ups = np.zeros(len(x) * P, dtype=np.complex128)
    ups[::P] = x
    y = np.convolve(ups, h)[: len(ups)]
    return y[::Q]


@pytest.mark.parametrize("P,Q", [(3, 2), (2, 3), (5, 4), (4, 5), (7, 3)])
def test_rational_resample_matches_jax_and_oracle(P, Q):
    rng = np.random.default_rng(0)
    h = np.asarray(jtaps.rrc_taps(8 * P, float(P), 0.3)).real
    n = 40 * Q
    x = (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(np.complex128)
    mats, offs, P2 = tres.rational_taps(h, P, Q)
    jmats, joffs, jP = jres.rational_taps(h, P, Q)
    assert P2 == jP == P and offs == joffs
    for a, b in zip(mats, jmats):
        assert np.array_equal(a, b)
    ctx = tres.rational_resample_init(mats, dtype=torch.complex128,
                                      device=CPU)
    y, _ = tres.rational_resample_block(_t(x), mats, offs, P, ctx)
    jctx = jres.rational_resample_init(jmats, dtype=jnp.complex128)
    jy, _ = jres.rational_resample_block(jnp.asarray(x), jmats, joffs, P,
                                         jctx)
    assert y.shape[0] == n * P // Q
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), atol=1e-12,
                               rtol=0)
    expected = _rational_oracle(x, h, P, Q)
    assert np.allclose(y.numpy(), expected[: y.shape[0]], atol=1e-9)


def test_rational_resample_streaming():
    rng = np.random.default_rng(1)
    P, Q = 3, 2
    h = np.asarray(jtaps.rc_taps(24, float(P), 0.4)).real
    n = 60 * Q
    x = rng.normal(size=n).astype(np.complex128)
    mats, offs, _ = tres.rational_taps(h, P, Q)
    ctx = tres.rational_resample_init(mats, dtype=torch.complex128,
                                      device=CPU)
    y_once, _ = tres.rational_resample_block(_t(x), mats, offs, P, ctx)
    parts = []
    for i in range(6):
        y, ctx = tres.rational_resample_block(_t(x[i * 20:(i + 1) * 20]),
                                              mats, offs, P, ctx)
        parts.append(y.numpy())
    assert np.allclose(np.concatenate(parts), y_once.numpy(), atol=1e-12)
    with pytest.raises(ValueError):
        tres.rational_resample_block(_t(x[:21]), mats, offs, P, ctx)


def test_rational_resample_gcd_normalized():
    h = np.ones(12, dtype=np.float64)
    mats, offs, P = tres.rational_taps(h, 6, 4)  # -> 3/2
    assert P == 3
    assert mats[0].shape[1] == 2
