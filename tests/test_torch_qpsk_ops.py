"""The QPSK receiver's ops in the port against the JAX package: taps,
the traced de-rotation, the frequency and timing estimators, the traced
decimators, fractional delay and the receiver config's host folds.  The
same float32 inputs (numpy, from a seed) go to both; the JAX side is
pinned to float32 (the conftest enables x64)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.models import qpsk_rx as jrx
from comms_tpu.ops import demodulation as jdemod
from comms_tpu.ops import fir as jfir
from comms_tpu.ops import interp as jinterp
from comms_tpu.ops import mixer as jmixer
from comms_tpu.ops import taps as jtaps
from comms_tpu_torch.models import qpsk_rx as trx
from comms_tpu_torch.ops import demodulation as tdemod
from comms_tpu_torch.ops import fir as tfir
from comms_tpu_torch.ops import interp as tinterp
from comms_tpu_torch.ops import mixer as tmixer
from comms_tpu_torch.ops import taps as ttaps

TOL_REL = 1e-5


def _f32(rng, *shape):
    return rng.normal(size=shape).astype(np.float32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    return float(np.max(np.abs(got - want))) / max(
        float(np.max(np.abs(want))), 1e-30)


@pytest.mark.parametrize("n,sps,beta", [(32, 4.0, 0.25), (33, 2.0, 0.5),
                                        (64, 8.0, 0.0), (17, 4.0, 1.0)])
def test_rrc_and_qfilt_taps_bit_equal(n, sps, beta):
    np.testing.assert_array_equal(ttaps.rrc_taps(n, sps, beta),
                                  jtaps.rrc_taps(n, sps, beta))
    np.testing.assert_array_equal(ttaps.qfilt_taps(2 * n, beta, int(sps)),
                                  jtaps.qfilt_taps(2 * n, beta, int(sps)))
    with pytest.raises(ttaps.InvalidRolloffError):
        ttaps.rrc_taps(n, sps, 1.5)


@pytest.mark.parametrize("phase0", [0.0, 0.31])
def test_derotate_traced_planar(phase0):
    rng = np.random.default_rng(1)
    xr, xi = _f32(rng, 5000), _f32(rng, 5000)
    jr, ji = jmixer.derotate_traced_planar(
        jnp.asarray(xr), jnp.asarray(xi), jnp.float32(0.011), phase0)
    tr, ti = tmixer.derotate_traced_planar(
        torch.from_numpy(xr), torch.from_numpy(xi), torch.tensor(0.011),
        phase0)
    assert np.max(np.abs(tr.numpy() - np.asarray(jr))) < 1e-6
    assert np.max(np.abs(ti.numpy() - np.asarray(ji))) < 1e-6
    z = tmixer.derotate_traced(torch.complex(torch.from_numpy(xr),
                                             torch.from_numpy(xi)), 0.011,
                               phase0)
    assert np.max(np.abs(z.real.numpy() - np.asarray(jr))) < 1e-6


def test_frequency_offset_estimates():
    rng = np.random.default_rng(2)
    n = np.arange(4096)
    x = (np.exp(1j * 0.013 * n) + 0.1 * (rng.normal(size=4096)
                                         + 1j * rng.normal(size=4096))
         ).astype(np.complex64)
    want = float(jdemod.frequency_offset_estimate_planar(
        jnp.asarray(x.real), jnp.asarray(x.imag)))
    got = float(tdemod.frequency_offset_estimate_planar(
        torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy())))
    assert abs(got - want) < 1e-6
    got_c = float(tdemod.frequency_offset_estimate(torch.from_numpy(x)))
    assert abs(got_c - float(jdemod.frequency_offset_estimate(
        jnp.asarray(x)))) < 1e-6


@pytest.mark.parametrize("n,hw", [(4, None), (4, 51), (3, None)])
def test_timing_panels_lag_sums_and_estimate(n, hw):
    rng = np.random.default_rng(3 + n)
    N = 16384
    re, im = _f32(rng, N), _f32(rng, N)
    jt = jdemod.TimingEstimator(n=n, d=5, alpha=0.25)
    tt = tdemod.TimingEstimator(n=n, d=5, alpha=0.25)
    jp = jt.corr_panels(jnp.asarray(re), jnp.asarray(im), halfwidth=hw)
    tp = tt.corr_panels(torch.from_numpy(re), torch.from_numpy(im),
                        halfwidth=hw)
    for a, b in zip(tp[:4], jp[:4]):
        assert _rel(a.numpy(), b) < TOL_REL
    for k in ("nd", "K", "Kp", "R", "width"):
        assert tp[4][k] == jp[4][k]
    for a, b in zip(tt.lag_sums_r2(tp), jt.lag_sums_r2(jp)):
        assert _rel(a.numpy(), b) < TOL_REL
    if hw is None:
        assert abs(float(tt.estimate_from_panels(tp))
                   - float(jt.estimate_from_panels(jp))) < 1e-5
        assert abs(float(tt.estimate_planar(torch.from_numpy(re),
                                            torch.from_numpy(im)))
                   - float(jt.estimate_planar(jnp.asarray(re),
                                              jnp.asarray(im)))) < 1e-5
    else:
        cfg = jrx.QpskRxConfig()
        want = float(jt.estimate_from_panels(jp, weights=cfg.wq2,
                                             lag_rot=jnp.float32(0.01)))
        got = float(tt.estimate_from_panels(tp, weights=cfg.wq2,
                                            lag_rot=torch.tensor(0.01)))
        assert abs(got - want) < 1e-5
        with pytest.raises(ValueError, match="weight"):
            tt.estimate_from_panels(tp)


def test_timing_estimate_short_block_is_zero():
    tt = tdemod.TimingEstimator(n=4, d=5, alpha=0.25)
    assert float(tt.estimate(torch.ones(20, dtype=torch.complex64))) == 0.0


@pytest.mark.parametrize("tail,with_ctx", [(4, False), (0, True), (4, True)])
def test_traced_decimators(tail, with_ctx):
    rng = np.random.default_rng(4 + tail)
    N = 4096 + 256
    xr, xi = _f32(rng, N), _f32(rng, N)
    fr, fi = _f32(rng, 44), _f32(rng, 44)
    ctx = (_f32(rng, 43), _f32(rng, 43)) if with_ctx else None
    jr, ji = jfir.fir_decimate_traced_planar_complex(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(fr), jnp.asarray(fi),
        4, tail_zeros=tail,
        ctx=None if ctx is None else tuple(jnp.asarray(c) for c in ctx))
    tr, ti = tfir.fir_decimate_traced_planar_complex(
        torch.from_numpy(xr), torch.from_numpy(xi), torch.from_numpy(fr),
        torch.from_numpy(fi), 4, tail_zeros=tail,
        ctx=None if ctx is None else tuple(torch.from_numpy(c)
                                           for c in ctx))
    assert _rel(tr.numpy() + 1j * ti.numpy(),
                np.asarray(jr) + 1j * np.asarray(ji)) < TOL_REL
    # real flat taps on planes, and on a complex block
    jr, ji = jfir.fir_decimate_traced_planar(
        jnp.asarray(xr), jnp.asarray(xi), jnp.asarray(fr[:12]), 4,
        tail_zeros=tail)
    tr, ti = tfir.fir_decimate_traced_planar(
        torch.from_numpy(xr), torch.from_numpy(xi), torch.from_numpy(fr[:12]),
        4, tail_zeros=tail)
    assert _rel(tr.numpy(), jr) < TOL_REL and _rel(ti.numpy(), ji) < TOL_REL
    z = (xr + 1j * xi).astype(np.complex64)
    jz = jfir.fir_decimate_traced(jnp.asarray(z), jnp.asarray(fr[:12]), 4,
                                  tail_zeros=tail)
    tz = tfir.fir_decimate_traced(torch.from_numpy(z),
                                  torch.from_numpy(fr[:12]), 4,
                                  tail_zeros=tail)
    assert _rel(tz.numpy(), jz) < TOL_REL


def test_traced_decimator_errors():
    x = torch.zeros(4096)
    with pytest.raises(ValueError, match="multiple of rate"):
        tfir.fir_decimate_traced_planar(x, x, torch.zeros(10), 4)
    with pytest.raises(ValueError, match="tail_zeros"):
        tfir.fir_decimate_traced_planar(x, x, torch.zeros(12), 4,
                                        tail_zeros=3)
    with pytest.raises(ValueError, match="MD-1"):
        tfir.fir_decimate_traced_planar_complex(
            x, x, torch.zeros(12), torch.zeros(12), 4,
            ctx=(torch.zeros(5), torch.zeros(5)))


def test_fir_apply_planar():
    rng = np.random.default_rng(5)
    xr, xi = _f32(rng, 3000), _f32(rng, 3000)
    B = jfir.banded_tap_matrix(_f32(rng, 32))
    jr, ji = jfir.fir_apply_planar(jnp.asarray(xr), jnp.asarray(xi), B)
    tr, ti = tfir.fir_apply_planar(torch.from_numpy(xr),
                                   torch.from_numpy(xi), B)
    assert _rel(tr.numpy(), jr) < TOL_REL and _rel(ti.numpy(), ji) < TOL_REL


@pytest.mark.parametrize("delay", [0.0, 3.0, 0.4, 2.3])
def test_fractional_delay(delay):
    np.testing.assert_array_equal(tinterp.lagrange_taps(0.37),
                                  jinterp.lagrange_taps(0.37))
    rng = np.random.default_rng(6)
    x = (rng.normal(size=2000) + 1j * rng.normal(size=2000)).astype(
        np.complex64)
    want = np.asarray(jinterp.delay_signal(jnp.asarray(x), delay))
    got = tinterp.delay_signal(torch.from_numpy(x), delay).numpy()
    assert np.max(np.abs(got - want)) < 1e-6


@pytest.mark.parametrize("sps", [4, 2, 8])
def test_rx_config_host_folds_equal(sps):
    jc = jrx.QpskRxConfig(sps=sps)
    tc = trx.QpskRxConfig(sps=sps)
    np.testing.assert_array_equal(tc.mf_taps, jc.mf_taps)
    np.testing.assert_array_equal(tc.wq2, jc.wq2)
    np.testing.assert_array_equal(tc.w4, jc.w4)
    np.testing.assert_array_equal(tc.lag_bands, jc.lag_bands)
    np.testing.assert_array_equal(tc.timing._wq, jc.timing._wq)
    assert tc.panel_hw == jc.panel_hw
