"""The fused band-monitor kernel's wrapper and plain version against the
JAX package's Pallas kernel (interpret mode, as its own tests run it on
the CPU).  Here the wrapper runs the plain PyTorch version, because the
tensors lie on the CPU; the kernel itself is compared with it on the
card by tests/test_torch_band_monitor_cuda.py and chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import band_monitor_pallas as JBM
from comms_tpu.models import fm_band_monitor as jmodel
from comms_tpu_torch.kernels import band_monitor as TBM

# The JAX kernel's own parity bound against the staged chain
# (tests/test_band_monitor_pallas.py): bf16x3 DFT and audio products
# there, float32 here.
TOL = 2e-4


def _jax_blocks(cfg, blocks):
    ctx_r = ctx_i = jnp.zeros((JBM.CTX_SAMPLES,), jnp.float32)
    yh_r, yh_i = JBM.zero_spec_halo(cfg.num_channels,
                                    cfg.audio_taps.shape[0])
    outs, states = [], []
    for re, im in blocks:
        audio, ctx_r, ctx_i, yh_r, yh_i = JBM.band_monitor_pallas_planar(
            jnp.asarray(re), jnp.asarray(im), cfg.prototype,
            cfg.audio_taps, cfg.audio_dec, ctx_r, ctx_i, yh_r, yh_i,
            num_channels=cfg.num_channels, interpret=True)
        outs.append(np.asarray(audio))
        states.append([np.asarray(s) for s in (ctx_r, ctx_i, yh_r, yh_i)])
    return outs, states


def _port_blocks(cfg, blocks, fn=TBM.band_monitor_planar):
    ctx_r = ctx_i = torch.zeros(TBM.CTX_SAMPLES)
    yh_r, yh_i = TBM.zero_spec_halo(cfg.num_channels,
                                    cfg.audio_taps.shape[0], device="cpu")
    outs, states = [], []
    for re, im in blocks:
        audio, ctx_r, ctx_i, yh_r, yh_i = fn(
            torch.from_numpy(re), torch.from_numpy(im), cfg.prototype,
            cfg.audio_taps, cfg.audio_dec, ctx_r, ctx_i, yh_r, yh_i,
            num_channels=cfg.num_channels)
        outs.append(audio.numpy())
        states.append([s.numpy() for s in (ctx_r, ctx_i, yh_r, yh_i)])
    return outs, states


@pytest.mark.parametrize("k,m,dec", [(64, 8, 4), (16, 8, 4)])
def test_plain_matches_jax_kernel_streaming(k, m, dec):
    rng = np.random.default_rng(11 + k)
    cfg = jmodel.BandMonitorConfig(num_channels=k, taps_per_branch=m,
                                   block=TBM.step_samples(), audio_dec=dec)
    blocks = [(rng.normal(size=cfg.block).astype(np.float32),
               rng.normal(size=cfg.block).astype(np.float32))
              for _ in range(3)]
    want, wst = _jax_blocks(cfg, blocks)
    launches = TBM.launches
    got, gst = _port_blocks(cfg, blocks)
    assert TBM.launches == launches          # CPU tensors: no kernel
    want, got = np.concatenate(want), np.concatenate(got)
    assert got.shape == want.shape == (3 * cfg.block // k // dec, k)
    scale = np.abs(want).max()
    assert np.max(np.abs(got - want)) < TOL * scale
    for g, w in zip(gst[-1], wst[-1]):
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) < 1e-5 * max(np.abs(w).max(), 1.0)


def test_stream_start_signed_zero_first_frame():
    # Only x[0] reaches spectrum frame 0 (through C[0, K-1] = h[0]), so
    # Y[0, ch] = h[0] * x[0] for every channel.  x[0] puts it in the
    # third quadrant; against the zero carried spectrum dotp = -0 and
    # cross = +0, so d[0] = atan2(+0, -0) = pi in every channel, and
    # audio[0, ch] = h_audio[0] * pi.
    rng = np.random.default_rng(5)
    cfg = jmodel.BandMonitorConfig(num_channels=16,
                                   block=TBM.step_samples())
    re = rng.normal(size=cfg.block).astype(np.float32)
    im = rng.normal(size=cfg.block).astype(np.float32)
    s = -np.sign(cfg.prototype[0])
    re[0] = im[0] = s
    want = _jax_blocks(cfg, [(re, im)])[0][0]
    got = _port_blocks(cfg, [(re, im)])[0][0]
    # The first audio sample of every channel: d[0] alone.
    assert np.max(np.abs(got[0] - want[0])) < 1e-5
    scale = np.abs(want).max()
    assert np.max(np.abs(got - want)) < TOL * scale
    pi_h0 = np.float32(cfg.audio_taps[0]) * np.pi
    assert np.max(np.abs(got[0] - pi_h0)) < 1e-6
    assert np.max(np.abs(want[0] - pi_h0)) < 1e-6


def test_plain_and_wrapper_agree():
    rng = np.random.default_rng(2)
    cfg = jmodel.BandMonitorConfig(num_channels=32,
                                   block=TBM.step_samples())
    blocks = [(rng.normal(size=cfg.block).astype(np.float32),
               rng.normal(size=cfg.block).astype(np.float32))
              for _ in range(2)]
    a, sa = _port_blocks(cfg, blocks)
    b, sb = _port_blocks(cfg, blocks, fn=TBM.band_monitor_plain)
    for x, y in zip(a + sa[-1], b + sb[-1]):
        np.testing.assert_array_equal(x, y)


def test_halo_rows_match_jax():
    for k in (2, 4, 8, 16, 32, 64, 128):
        for t in (1, 9, 32, 33, 63, 31 * (128 // k) + 1):
            assert TBM.halo_rows(k, t) == JBM.halo_rows(k, t), (k, t)


def test_validation_errors():
    cfg = jmodel.BandMonitorConfig(block=TBM.step_samples())
    re = torch.zeros(TBM.step_samples())
    ctx = torch.zeros(TBM.CTX_SAMPLES)
    yh_r, yh_i = TBM.zero_spec_halo(cfg.num_channels,
                                    cfg.audio_taps.shape[0], device="cpu")
    args = (cfg.prototype, cfg.audio_taps)
    with pytest.raises(ValueError, match="audio_dec"):
        TBM.band_monitor_planar(re, re, *args, 3, ctx, ctx, yh_r, yh_i,
                                num_channels=16)
    with pytest.raises(ValueError, match="spec halo"):
        TBM.band_monitor_planar(re, re, *args, 4, ctx, ctx, yh_r[:-1],
                                yh_i[:-1], num_channels=16)
    with pytest.raises(ValueError, match="audio taps"):
        TBM.band_monitor_planar(re, re, cfg.prototype, np.ones(250), 4,
                                ctx, ctx, yh_r, yh_i, num_channels=16)
    with pytest.raises(ValueError, match="multiple"):
        TBM.band_monitor_planar(re[:8192], re[:8192], *args, 4, ctx, ctx,
                                yh_r, yh_i, num_channels=16)
    with pytest.raises(ValueError, match="ctx must be"):
        TBM.band_monitor_planar(re, re, *args, 4, ctx[:10], ctx[:10],
                                yh_r, yh_i, num_channels=16)
