"""comms_tpu_torch.ops.demodulation against comms_tpu.ops.demodulation,
including the signed-zero cases that decide the first demodulated
sample of a stream."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.ops import demodulation as jdem
from comms_tpu_torch.ops import demodulation as tdem


def _grid():
    v = np.array([0.0, -0.0, 1.0, -1.0, 0.5, -2.0, 1e-30, -1e-30,
                  3e38, -3e38, np.inf, -np.inf], np.float32)
    yy, xx = np.meshgrid(v, v, indexing="ij")
    rng = np.random.default_rng(5)
    r = rng.normal(size=(2, 4000)).astype(np.float32) * rng.choice(
        [1e-3, 1.0, 1e3], size=(2, 4000)).astype(np.float32)
    return (np.concatenate([yy.ravel(), r[0]]),
            np.concatenate([xx.ravel(), r[1]]))


def test_fast_atan2_matches_jax_on_grid():
    y, x = _grid()
    want = np.asarray(jdem.fast_atan2(jnp.asarray(y), jnp.asarray(x)))
    got = tdem.fast_atan2(torch.from_numpy(y), torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    # Same float32 operations in the same order: 1e-6 rad covers any
    # difference in how the two libraries round the polynomial.
    assert np.max(np.abs(got[ok] - want[ok])) <= 1e-6
    # Signed-zero inputs: exact, including the sign of a zero result.
    zero = (y == 0) & (x == 0)
    assert zero.sum() == 4
    np.testing.assert_array_equal(got[zero], want[zero])
    np.testing.assert_array_equal(np.signbit(got[zero]),
                                  np.signbit(want[zero]))
    np.testing.assert_array_equal(
        got[zero], np.arctan2(y[zero], x[zero]).astype(np.float32))


def test_fast_angle_matches_jax():
    rng = np.random.default_rng(6)
    z = (rng.normal(size=500) + 1j * rng.normal(size=500)).astype(
        np.complex64)
    want = np.asarray(jdem.fast_angle(jnp.asarray(z)))
    got = tdem.fast_angle(torch.from_numpy(z)).numpy()
    assert np.max(np.abs(got - want)) <= 1e-6


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("cdtype,tol", [(np.complex64, 1e-6),
                                        (np.complex128, 1e-12)])
def test_fm_demod_block_across_blocks_matches_jax(fast, cdtype, tol):
    if fast and cdtype == np.complex128:
        tol = 1e-6   # fast_atan2 is float32 whatever the input
    rng = np.random.default_rng(7)
    n = 300
    ph = np.cumsum(0.4 + 0.3 * rng.normal(size=3 * n))
    x = (np.exp(1j * ph) * (1 + 0.1 * rng.normal(size=3 * n))).astype(
        cdtype)
    pj = jdem.fm_demod_init(jnp.dtype(cdtype))
    pt = tdem.fm_demod_init(torch.from_numpy(x[:1]).dtype, device="cpu")
    for b in range(3):
        xb = x[b * n:(b + 1) * n]
        yj, pj = jdem.fm_demod_block(jnp.asarray(xb), pj, fast=fast)
        yt, pt = tdem.fm_demod_block(torch.from_numpy(xb), pt, fast=fast)
        assert yt.numpy().dtype == np.asarray(yj).dtype
        assert np.max(np.abs(yt.numpy() - np.asarray(yj))) <= tol
        assert complex(pt) == complex(np.asarray(pj))


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("first", [1 + 1j, -1 + 1j, -1 - 1j, 1 - 1j])
def test_zero_prev_first_sample_matches_jax(first, fast):
    # prev = 0 at stream start: z = x[0] * conj(0) is a signed zero and
    # atan2 of it is 0, -0 or pi by quadrant (pi for -1-1j).
    x = np.array([first, 0.5 + 0.2j], np.complex64)
    yj, _ = jdem.fm_demod_block(jnp.asarray(x), jdem.fm_demod_init(),
                                fast=fast)
    yt, _ = tdem.fm_demod_block(torch.from_numpy(x),
                                tdem.fm_demod_init(device="cpu"),
                                fast=fast)
    want = np.asarray(yj)[0]
    got = yt.numpy()[0]
    assert got == want and np.signbit(got) == np.signbit(want)
    if first == -1 - 1j:
        assert got == np.float32(np.pi)
