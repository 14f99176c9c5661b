"""The band-monitor model, staged and fused: comms_tpu_torch against the
JAX package's model (its XLA path, and its fused path with the Pallas
kernel in interpret mode), streamed over several blocks, and the
per-channel tone recovery on the port.  On the CPU the kernel routes run
the kernels' plain PyTorch versions."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.models import fm_band_monitor as jmodel
from comms_tpu_torch.kernels import band_monitor as TBM
from comms_tpu_torch.kernels import channelizer as TCK
from comms_tpu_torch.kernels import decim_fir as TDF
from comms_tpu_torch.models import fm_band_monitor as tmodel

# The JAX tests' bounds: staged kernel route vs XLA at 2e-5*max(scale, 1)
# (tests/test_channelizer_pallas.py), fused vs staged at 2e-4*scale
# (tests/test_band_monitor_pallas.py).
TOL_STAGED = 2e-5
TOL_FUSED = 2e-4


def _planes(rng, n):
    return (rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


def _both(kw):
    return jmodel.BandMonitorConfig(**kw), tmodel.BandMonitorConfig(**kw)


@pytest.mark.parametrize("pairs", [False, True])
def test_staged_matches_jax_xla_streamed(pairs):
    rng = np.random.default_rng(1 + pairs)
    jcfg, tcfg = _both(dict(num_channels=16, block=8192))
    if pairs:
        jblk, tblk = jmodel.make_block_fn(jcfg), tmodel.make_block_fn(tcfg)
    else:
        jblk = jmodel.make_planar_block_fn(jcfg)
        tblk = tmodel.make_planar_block_fn(tcfg)
    js, ts = jmodel.init_state(jcfg), tmodel.init_state(tcfg, device="cpu")
    for b in range(3):
        re, im = _planes(rng, tcfg.block)
        if pairs:
            x = np.stack([re, im], -1)
            want, js = jblk(js, jnp.asarray(x))
            got, ts = tblk(ts, torch.from_numpy(x))
        else:
            want, js = jblk(js, jnp.asarray(re), jnp.asarray(im))
            got, ts = tblk(ts, torch.from_numpy(re), torch.from_numpy(im))
        want = np.asarray(want)
        assert got.shape == want.shape == (16, tcfg.audio_per_channel)
        scale = max(np.abs(want).max(), 1.0)
        assert np.max(np.abs(got.numpy() - want)) < TOL_STAGED * scale, b
        for g, w in zip(ts, js):
            w = np.asarray(w)
            assert np.max(np.abs(g.numpy() - w)) < 1e-5 * max(
                np.abs(w).max(), 1.0)


@pytest.mark.parametrize("taps", [None, "hanning30"])
def test_staged_kernel_route_with_audio_fir(taps):
    # The config where the decimating-FIR kernel takes the audio stage,
    # including ragged taps (30 taps at dec 4: the carried context is
    # MD-1 = 31 samples, not taps-1).
    rng = np.random.default_rng(21)
    kw = dict(num_channels=2, taps_per_branch=8, block=2 * 16384,
              audio_dec=4,
              audio_taps=None if taps is None else np.hanning(30))
    jcfg, tcfg = _both(kw)
    assert tmodel._audio_tile_rows(tcfg) == jmodel._audio_tile_rows(jcfg)
    assert tmodel._audio_tile_rows(tcfg) == 32
    jblk = jmodel.make_block_fn(jcfg, use_pallas=False)
    tblk = tmodel.make_block_fn(tcfg, use_kernel=True)
    js, ts = jmodel.init_state(jcfg), tmodel.init_state(tcfg, device="cpu")
    x = rng.normal(size=(tcfg.block, 2)).astype(np.float32)
    for _ in range(2):
        want, js = jblk(js, jnp.asarray(x))
        got, ts = tblk(ts, torch.from_numpy(x))
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1.0)
        assert np.max(np.abs(got.numpy() - want)) < TOL_STAGED * scale


def test_fused_matches_jax_fused_streamed():
    rng = np.random.default_rng(7)
    jcfg, tcfg = _both(dict(block=TBM.step_samples()))
    jblk = jmodel.make_fused_block_fn(jcfg, interpret=True)
    tblk = tmodel.make_fused_block_fn(tcfg)
    js = jmodel.init_state_fused(jcfg)
    ts = tmodel.init_state_fused(tcfg, device="cpu")
    for b in range(2):
        re, im = _planes(rng, tcfg.block)
        want, js = jblk(js, jnp.asarray(re), jnp.asarray(im))
        got, ts = tblk(ts, torch.from_numpy(re), torch.from_numpy(im))
        want = np.asarray(want)
        assert got.shape == want.shape == (16, tcfg.audio_per_channel)
        assert got.is_contiguous()
        assert np.max(np.abs(got.numpy() - want)) < TOL_FUSED * np.abs(
            want).max(), b


def test_fused_matches_staged_on_port():
    rng = np.random.default_rng(8)
    cfg = tmodel.BandMonitorConfig(num_channels=64, block=TBM.step_samples())
    staged = tmodel.make_planar_block_fn(cfg)
    fused = tmodel.make_fused_block_fn(cfg)
    ss = tmodel.init_state(cfg, device="cpu")
    fs = tmodel.init_state_fused(cfg, device="cpu")
    for b in range(2):
        re, im = (torch.from_numpy(p) for p in _planes(rng, cfg.block))
        a, ss = staged(ss, re, im)
        f, fs = fused(fs, re, im)
        assert np.max(np.abs((a - f).numpy())) < TOL_FUSED * np.abs(
            a.numpy()).max(), b


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_state_from_jax_continues_mid_stream(path):
    rng = np.random.default_rng(9)
    jcfg, tcfg = _both(dict(block=TBM.step_samples()))
    (a_re, a_im), (b_re, b_im) = _planes(rng, tcfg.block), _planes(
        rng, tcfg.block)
    if path == "staged":
        jblk = jmodel.make_planar_block_fn(jcfg)
        js = jmodel.init_state(jcfg)
        tblk = tmodel.make_planar_block_fn(tcfg)
        convert = tmodel.state_from_jax
        tol = TOL_STAGED
    else:
        jblk = jmodel.make_fused_block_fn(jcfg, interpret=True)
        js = jmodel.init_state_fused(jcfg)
        tblk = tmodel.make_fused_block_fn(tcfg)
        convert = tmodel.fused_state_from_jax
        tol = TOL_FUSED
    _, js = jblk(js, jnp.asarray(a_re), jnp.asarray(a_im))
    want, _ = jblk(js, jnp.asarray(b_re), jnp.asarray(b_im))
    ts = convert([np.asarray(s) for s in js], device="cpu")
    got, _ = tblk(ts, torch.from_numpy(b_re), torch.from_numpy(b_im))
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) < tol * max(
        np.abs(want).max(), 1.0)


def test_fused_state_from_raw_tail_matches_jax():
    rng = np.random.default_rng(3)
    jcfg, tcfg = _both(dict(block=TBM.step_samples()))
    L = tmodel.fused_tail_samples(tcfg)
    assert L == jmodel.fused_tail_samples(jcfg)
    re, im = _planes(rng, L)
    want = jmodel.fused_state_from_raw_tail(jcfg, jnp.asarray(re),
                                            jnp.asarray(im))
    got = tmodel.fused_state_from_raw_tail(tcfg, torch.from_numpy(re),
                                           torch.from_numpy(im))
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.max(np.abs(g.numpy() - w)) <= 1e-5 * np.abs(w).max()
    with pytest.raises(ValueError, match="raw tail"):
        tmodel.fused_state_from_raw_tail(tcfg, torch.from_numpy(re[1:]),
                                         torch.from_numpy(im[1:]))


def test_fused_state_from_raw_tail_continues_the_stream():
    # The recomputed state stands in for the carried one at a boundary.
    rng = np.random.default_rng(4)
    cfg = tmodel.BandMonitorConfig(block=TBM.step_samples())
    blk = tmodel.make_fused_block_fn(cfg)
    (a_re, a_im), (b_re, b_im) = (
        (torch.from_numpy(p) for p in _planes(rng, cfg.block))
        for _ in range(2))
    _, carried = blk(tmodel.init_state_fused(cfg, device="cpu"), a_re, a_im)
    L = tmodel.fused_tail_samples(cfg)
    rebuilt = tmodel.fused_state_from_raw_tail(cfg, a_re[-L:], a_im[-L:])
    want, _ = blk(carried, b_re, b_im)
    got, _ = blk(rebuilt, b_re, b_im)
    assert np.max(np.abs((got - want).numpy())) < 1e-4 * np.abs(
        want.numpy()).max()


def test_launch_counters_stay_zero_on_cpu():
    rng = np.random.default_rng(6)
    cfg = tmodel.BandMonitorConfig(block=TBM.step_samples())
    before = (TCK.launches, TDF.launches, TBM.launches)
    re, im = (torch.from_numpy(p) for p in _planes(rng, cfg.block))
    tmodel.make_planar_block_fn(cfg, use_kernel=True)(
        tmodel.init_state(cfg, device="cpu"), re, im)
    tmodel.make_fused_block_fn(cfg)(
        tmodel.init_state_fused(cfg, device="cpu"), re, im)
    assert (TCK.launches, TDF.launches, TBM.launches) == before


@pytest.mark.parametrize("path", ["staged", "fused"])
def test_band_monitor_recovers_per_channel_tones(path):
    """Three FM stations (distinct audio tones on distinct channel
    centres) demodulate so that each tone stands out in its own
    channel's audio and not in a quiet one."""
    K = 16
    n = 1 << 18
    cfg = tmodel.BandMonitorConfig(num_channels=K, block=n, audio_dec=4)
    t = np.arange(n)
    stations = {3: 0.020, 7: 0.033, 12: 0.047}  # ch -> audio freq
    x = np.zeros(n, np.complex128)
    for ch, fa in stations.items():
        tone = np.sin(2 * np.pi * fa / K * t)
        phase = 2 * np.pi * (0.25 / K) * np.cumsum(tone)
        x += np.exp(1j * (2 * np.pi * ch * t / K + phase))
    x = (x / np.abs(x).max()).astype(np.complex64)
    re = torch.from_numpy(x.real.copy())
    im = torch.from_numpy(x.imag.copy())
    if path == "staged":
        audio, _ = tmodel.make_planar_block_fn(cfg)(
            tmodel.init_state(cfg, device="cpu"), re, im)
    else:
        audio, _ = tmodel.make_fused_block_fn(cfg)(
            tmodel.init_state_fused(cfg, device="cpu"), re, im)
    audio = audio.numpy().astype(np.float64)[:, 64:]
    f = np.fft.rfftfreq(audio.shape[1], 1.0)
    for ch, fa in stations.items():
        a = audio[ch] - audio[ch].mean()
        X = np.abs(np.fft.rfft(a * np.hanning(len(a))))
        target = np.abs(f - fa * cfg.audio_dec).argmin()
        ratio_t = X[target] / np.median(X)
        assert ratio_t > 10, (ch, ratio_t)
        q = audio[(ch + 2) % K] - audio[(ch + 2) % K].mean()
        Xq = np.abs(np.fft.rfft(q * np.hanning(len(q))))
        assert Xq[target] / np.median(Xq) < ratio_t / 3, ch
