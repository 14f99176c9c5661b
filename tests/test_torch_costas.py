"""The port's Costas loop, phase estimators and AGC against the JAX
package's (``ops/demodulation.py`` and ``ops/agc.py``), on the same
seeded numpy inputs; the plain versions of both loops
(``kernels.recurrence``) against JAX directly; mirrors of
tests/test_spectrum_agc.py's AGC tests on the port.

Tolerances (measured on the CPU, then about 10x): the loops carry their
state through sin/cos/atan2 (Costas) or log/exp/hypot (AGC), and XLA's
float32 versions of those differ from the C library's that PyTorch
calls by an ulp here and there.  On input locked from the first symbol
the loop damps those differences instead of growing them: the Costas
outputs (symbols of magnitude ~1.4) stayed within 2.2e-6 of JAX over up
to 4096 symbols, its state within 1e-8 rad (and rad/symbol); the AGC
within 2.2e-6 of outputs of order 1, its gain within 6e-8.  So TOL_LOOP =
2e-5 on outputs and states.  The phase estimates sum a block of powers
in another order than XLA: within 1.5e-8 rad, so TOL_EST = 1e-6."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.ops import agc as jagc
from comms_tpu.ops import demodulation as jdem
from comms_tpu_torch.kernels import recurrence as R
from comms_tpu_torch.ops import agc
from comms_tpu_torch.ops import demodulation as dem

TOL_LOOP = 2e-5
TOL_EST = 1e-6


def _locked(n, seed, cfo=2e-3, phi=0.3, sigma=0.05, order=4):
    """M-PSK symbols (M = order; QPSK at its +-1+-1j points) turned by a
    carrier offset, with complex Gaussian noise."""
    rng = np.random.default_rng(seed)
    if order == 4:
        b = rng.integers(0, 2, size=(2, n))
        s = (2 * b[0] - 1) + 1j * (2 * b[1] - 1)
    else:
        s = np.exp(2j * np.pi * rng.integers(0, order, size=n) / order)
    s = s * np.exp(1j * (phi + cfo * np.arange(n)))
    s = s + sigma * (rng.normal(size=n) + 1j * rng.normal(size=n))
    return s.astype(np.complex64)


def _state(ph=0.0, fr=0.0):
    return (np.float32(ph), np.float32(fr))


def _jax_costas(x, st, alpha, beta, order):
    y, (ph, fr) = jdem.costas_loop_block(
        jnp.asarray(x), (jnp.float32(st[0]), jnp.float32(st[1])), alpha,
        beta, order=order)
    return np.asarray(y), float(ph), float(fr)


@pytest.mark.parametrize("n,seed,order,st", [
    (2048, 0, 4, (0.0, 0.0)),
    (1000, 1, 4, (0.2, 1e-3)),
    (777, 2, 2, (0.0, 0.0)),
    (512, 3, 8, (-0.1, 0.0)),
])
def test_costas_loop_block_matches_jax(n, seed, order, st):
    x = _locked(n, seed, order=order)
    yj, phj, frj = _jax_costas(x, st, 0.1, 0.005, order)
    y, (ph, fr) = dem.costas_loop_block(
        torch.from_numpy(x), tuple(torch.tensor(v) for v in st), 0.1, 0.005,
        order=order)
    assert y.dtype == torch.complex64 and y.shape == (n,)
    assert np.abs(y.numpy() - yj).max() <= TOL_LOOP
    assert abs(float(ph) - phj) <= TOL_LOOP
    assert abs(float(fr) - frj) <= TOL_LOOP
    assert ph.dtype == fr.dtype == torch.float32 and ph.ndim == 0


def test_costas_blocks_chain_like_one_block():
    # the carried (phase, freq) makes two half blocks equal one block
    x = torch.from_numpy(_locked(1024, 4))
    z = (torch.zeros(()), torch.zeros(()))
    y, st = dem.costas_loop_block(x, z, 0.1, 0.005)
    y1, st1 = dem.costas_loop_block(x[:400], z, 0.1, 0.005)
    y2, st2 = dem.costas_loop_block(x[400:], st1, 0.1, 0.005)
    assert torch.equal(torch.cat([y1, y2]), y)
    assert torch.equal(st2[0], st[0]) and torch.equal(st2[1], st[1])


@pytest.mark.parametrize("order", [2, 4])
def test_costas_plain_matches_jax(order):
    x = _locked(1500, 5 + order, order=order)
    yj, phj, frj = _jax_costas(x, _state(0.05), 0.1, 0.005, order)
    yr, yi, ph, fr = R.costas_loop_plain(
        torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()),
        torch.tensor(0.05), torch.tensor(0.0), 0.1, 0.005, order)
    assert np.abs(yr.numpy() - yj.real).max() <= TOL_LOOP
    assert np.abs(yi.numpy() - yj.imag).max() <= TOL_LOOP
    assert abs(float(ph) - phj) <= TOL_LOOP
    assert abs(float(fr) - frj) <= TOL_LOOP


def test_costas_tracks_a_carrier_offset():
    # the loop's frequency integrator converges on the residual offset
    x = torch.from_numpy(_locked(4000, 6, cfo=3e-3, sigma=0.02))
    y, (ph, fr) = dem.costas_loop_block(
        x, (torch.zeros(()), torch.zeros(())), 0.1, 0.005)
    assert abs(float(fr) - 3e-3) < 2e-4
    tail = y[-500:].numpy()
    # locked: the corrected symbols sit on the +-1+-1j points
    assert np.abs(np.abs(tail.real) - 1).mean() < 0.1
    assert np.abs(np.abs(tail.imag) - 1).mean() < 0.1


@pytest.mark.parametrize("m", [1, 2, 3, 4, 8])
def test_psk_phase_estimate_matches_jax(m):
    x = _locked(4096, m, cfo=0.0, phi=0.1, order=4 if m >= 4 else 2)
    want = float(jdem.psk_phase_estimate(jnp.asarray(x), m))
    got = dem.psk_phase_estimate(torch.from_numpy(x), m)
    assert got.dtype == torch.float32 and got.ndim == 0
    assert abs(float(got) - want) <= TOL_EST


def test_qam_phase_estimate_matches_jax():
    rng = np.random.default_rng(9)
    lv = np.array([-3, -1, 1, 3])
    x = (lv[rng.integers(0, 4, 4096)] + 1j * lv[rng.integers(0, 4, 4096)])
    x = (x * np.exp(0.2j) + 0.1 * rng.normal(size=4096)).astype(np.complex64)
    want = float(jdem.qam_phase_estimate(jnp.asarray(x)))
    got = float(dem.qam_phase_estimate(torch.from_numpy(x)))
    assert abs(got - want) <= TOL_EST
    assert abs(got - 0.2) < 0.02


def test_agc_block_matches_jax_over_chained_blocks():
    rng = np.random.default_rng(2)
    x = (0.01 * (rng.normal(size=(6, 4096))
                 + 1j * rng.normal(size=(6, 4096)))).astype(np.complex64)
    gj, gt = jagc.agc_init(), agc.agc_init(device="cpu")
    for b in range(6):
        yj, gj = jagc.agc_block(jnp.asarray(x[b]), gj, target_rms=1.0)
        yt, gt = agc.agc_block(torch.from_numpy(x[b]), gt, target_rms=1.0)
        assert yt.dtype == torch.complex64
        np.testing.assert_allclose(yt.numpy(), np.asarray(yj),
                                   rtol=TOL_LOOP, atol=TOL_LOOP)
        assert abs(float(gt) - float(gj)) <= TOL_LOOP * abs(float(gj))


@pytest.mark.parametrize("rate", [1e-2, 5e-2])
def test_agc_scan_matches_jax(rate):
    n = 3000
    rng = np.random.default_rng(int(rate * 1000))
    amp = np.where(np.arange(n) < n // 2, 0.1, 2.0)
    x = (amp * np.exp(1j * 0.3 * np.arange(n))
         + 0.01 * rng.normal(size=n)).astype(np.complex64)
    yj, gj = jagc.agc_scan(jnp.asarray(x), jagc.agc_init(), rate=rate)
    y, g = agc.agc_scan(torch.from_numpy(x), agc.agc_init(device="cpu"),
                        rate=rate)
    assert np.abs(y.numpy() - np.asarray(yj)).max() <= TOL_LOOP
    assert abs(float(g) - float(gj)) <= TOL_LOOP
    # the plain version on the planes directly
    yr, yi, gp = R.agc_scan_plain(torch.from_numpy(x.real.copy()),
                                  torch.from_numpy(x.imag.copy()),
                                  torch.tensor(1.0), 1.0, rate)
    assert torch.equal(yr, y.real) and torch.equal(yi, y.imag)
    assert torch.equal(gp, g)


def test_agc_block_converges():
    # tests/test_spectrum_agc.py's convergence check, on the port
    rng = np.random.default_rng(2)
    x = (0.01 * (rng.normal(size=(20, 4096))
                 + 1j * rng.normal(size=(20, 4096)))).astype(np.complex64)
    g = agc.agc_init(device="cpu")
    for b in range(20):
        y, g = agc.agc_block(torch.from_numpy(x[b]), g, target_rms=1.0)
    rms = float(torch.sqrt(torch.mean(y.abs() ** 2)))
    assert abs(rms - 1.0) < 0.05


def test_agc_scan_tracks_step():
    # tests/test_spectrum_agc.py's gain step, on the port
    n = 4000
    amp = np.where(np.arange(n) < n // 2, 0.1, 2.0)
    x = (amp * np.exp(1j * 0.3 * np.arange(n))).astype(np.complex64)
    y, g = agc.agc_scan(torch.from_numpy(x), agc.agc_init(device="cpu"),
                        rate=5e-2)
    assert abs(float(y[-200:].abs().mean()) - 1.0) < 0.1


def test_recurrences_refuse_bad_input():
    z = torch.zeros(())
    with pytest.raises(ValueError, match="complex64"):
        dem.costas_loop_block(torch.zeros(4, dtype=torch.complex128),
                              (z, z), 0.1, 0.005)
    with pytest.raises(ValueError, match="complex64"):
        agc.agc_scan(torch.zeros(4), z)
    with pytest.raises(ValueError, match="order"):
        R.costas_loop(torch.zeros(4), torch.zeros(4), z, z, 0.1, 0.005,
                      order=0)
    with pytest.raises(ValueError, match="scalars"):
        R.agc_scan(torch.zeros(4), torch.zeros(4), torch.zeros(2))
    with pytest.raises(ValueError, match="length"):
        R.agc_scan(torch.zeros(4), torch.zeros(5), z)
