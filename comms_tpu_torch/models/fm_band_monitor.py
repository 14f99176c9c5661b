"""Wideband FM band monitor: channelize, then demodulate every channel.

Counterpart of :mod:`comms_tpu.models.fm_band_monitor`: a wideband
capture covering K FM stations is split by the polyphase channelizer,
then every channel is FM-demodulated and audio-filtered at once, the
channels as a batch axis, so K receivers cost one.

    wideband IQ [N] -> channelizer -> [frames, K]
      -> per channel: FM demod -> audio FIR /dec -> audio [K, N/K/dec]

Two ways to run a block:

* the staged path, :func:`make_block_fn` / :func:`make_planar_block_fn`:
  the channelizer kernel (or tensor ops), the demod as tensor ops, and
  the audio FIR through the decimating-FIR kernel when the block allows
  it (:func:`_audio_tile_rows`), all channels in one launch.  State:
  :func:`init_state`.
* the fused path, :func:`make_fused_block_fn`: one kernel per block
  (:mod:`comms_tpu_torch.kernels.band_monitor`) that also writes the
  next carried state.  State: :func:`init_state_fused`, the input tail
  and the spectrum tail; not interchangeable with the staged state.

Both demodulate with the polynomial atan2 by default (``fast_demod``).
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import band_monitor as _BM
from comms_tpu_torch.kernels import channelizer as _CK
from comms_tpu_torch.kernels import decim_fir as _DF
from comms_tpu_torch.models.channelizer import (_auto_use_kernel,
                                                _check_kernel_config)
from comms_tpu_torch.ops import channelizer as chan
from comms_tpu_torch.ops import demodulation as demod
from comms_tpu_torch.ops import fir

__all__ = ["BandMonitorConfig", "make_block_fn", "make_planar_block_fn",
           "make_fused_block_fn", "init_state", "init_state_fused",
           "state_from_jax", "fused_state_from_jax", "fused_tail_samples",
           "fused_state_from_raw_tail"]


class BandMonitorConfig:
    def __init__(self, num_channels: int = 16, taps_per_branch: int = 8,
                 block: int = 1 << 18, audio_dec: int = 4,
                 audio_taps=None):
        self.num_channels = int(num_channels)
        self.taps_per_branch = int(taps_per_branch)
        self.block = int(block)
        self.audio_dec = int(audio_dec)
        if self.block % (self.num_channels * self.audio_dec):
            raise ValueError("block must divide by channels * audio_dec")
        h = chan.design_prototype(self.num_channels, self.taps_per_branch)
        self.prototype = h
        self.Hb = chan.branch_taps(h.astype(np.float32), self.num_channels)
        at = (np.asarray(audio_taps) if audio_taps is not None
              else chan.design_prototype(self.audio_dec, 8))
        self.audio_taps = at.astype(np.float32)
        self.audio_C = fir.decimating_branch_taps(
            self.audio_taps, self.audio_dec)

    @property
    def frames_per_block(self) -> int:
        return self.block // self.num_channels

    @property
    def audio_per_channel(self) -> int:
        return self.frames_per_block // self.audio_dec


def init_state(cfg: BandMonitorConfig, device="cuda"):
    """(channelizer tail [T-1, 2] pairs, per-channel FM prev [K, 2]
    pairs, per-channel audio-FIR tails [K, MD-1]), float32."""
    T = cfg.num_channels * cfg.taps_per_branch
    K = cfg.num_channels
    f32 = dict(dtype=torch.float32, device=device)
    return (torch.zeros((T - 1, 2), **f32), torch.zeros((K, 2), **f32),
            torch.zeros((K, cfg.audio_C.size - 1), **f32))


def init_state_fused(cfg: BandMonitorConfig, device="cuda"):
    """State of :func:`make_fused_block_fn`: (input-tail planes
    [CTX_SAMPLES] x2, spectrum-tail planes [halo_rows, 128] x2)."""
    z = torch.zeros((_BM.CTX_SAMPLES,), dtype=torch.float32, device=device)
    yh_r, yh_i = _BM.zero_spec_halo(cfg.num_channels,
                                    cfg.audio_taps.shape[0], device)
    return (z, z.clone(), yh_r, yh_i.clone())


def state_from_jax(state, device="cuda"):
    """The JAX package's :func:`init_state`-shaped state (numpy arrays)
    as this package's state on ``device``."""
    return tuple(torch.tensor(np.asarray(s, np.float32), device=device)
                 for s in state)


def fused_state_from_jax(state, device="cuda"):
    """The JAX package's :func:`init_state_fused`-shaped state (numpy
    arrays) as this package's; the layouts are the same."""
    return state_from_jax(state, device)


def make_fused_block_fn(cfg: BandMonitorConfig):
    """Fused serving path: ``(state, re[N], im[N]) -> (audio[K, M],
    state)`` through one launch of the band-monitor kernel per block on
    CUDA tensors (its plain version on CPU tensors).  Demod is the
    polynomial atan2.  State from :func:`init_state_fused`.
    Constraints: K | 128, taps_per_branch <= 16, block % 16384 == 0,
    audio_dec | 128 in [2, 16], audio taps <= 31 * (128 // K) + 1.
    """
    if cfg.block % _BM.step_samples():
        raise ValueError(
            f"fused band monitor needs block % {_BM.step_samples()}"
            f" == 0, got {cfg.block}")

    def block(state, re, im):
        ctx_r, ctx_i, yh_r, yh_i = state
        audio, ctx_r, ctx_i, yh_r, yh_i = _BM.band_monitor_planar(
            re, im, cfg.prototype, cfg.audio_taps, cfg.audio_dec,
            ctx_r, ctx_i, yh_r, yh_i, num_channels=cfg.num_channels)
        return audio.T, (ctx_r, ctx_i, yh_r, yh_i)

    return block


def fused_tail_samples(cfg: BandMonitorConfig) -> int:
    """Raw samples whose tail fully determines the fused state
    (:func:`fused_state_from_raw_tail`): the spectrum tail's input
    window plus the kernel's input-context length."""
    kpr = 128 // cfg.num_channels
    hframes = _BM.halo_rows(cfg.num_channels,
                            cfg.audio_taps.shape[0]) * kpr
    return hframes * cfg.num_channels + _BM.CTX_SAMPLES


def fused_state_from_raw_tail(cfg: BandMonitorConfig, re_tail, im_tail):
    """Recompute :func:`make_fused_block_fn`'s carried state from the
    last :func:`fused_tail_samples` raw input plane samples: the
    spectrum tail is re-channelized with the tensor ops, so a block
    boundary needs only the raw tail.  The windows are the kernel's;
    the sums run in another order, so the state matches the carried one
    to ~1e-5 relative, not bit for bit."""
    K = cfg.num_channels
    hrows = _BM.halo_rows(K, cfg.audio_taps.shape[0])
    hframes = hrows * (128 // K)
    T = K * cfg.taps_per_branch
    L = fused_tail_samples(cfg)
    if re_tail.shape[0] != L:
        raise ValueError(f"raw tail must be {L} samples, got "
                         f"{re_tail.shape[0]}")
    n = hframes * K
    yr, yi, _, _ = chan.channelize_block_planar(
        re_tail[-n:], im_tail[-n:], cfg.Hb,
        re_tail[-(n + T - 1):-n], im_tail[-(n + T - 1):-n])
    return (re_tail[-_BM.CTX_SAMPLES:].clone(),
            im_tail[-_BM.CTX_SAMPLES:].clone(),
            yr.reshape(hrows, 128), yi.reshape(hrows, 128))


def _make_planar_channelize(cfg: BandMonitorConfig, use_kernel: bool):
    """(re[N], im[N], ctx_re[T-1], ctx_im[T-1]) ->
    (yr[frames, K], yi[frames, K], ctx_re', ctx_im')."""
    if not use_kernel:
        def channelize(re, im, cre, cim):
            return chan.channelize_block_planar(re, im, cfg.Hb, cre, cim)
        return channelize

    _check_kernel_config(cfg)
    T = cfg.num_channels * cfg.taps_per_branch
    pad = _CK.CTX_SAMPLES - (T - 1)

    def channelize(re, im, cre, cim):
        zc = re.new_zeros(pad)
        yr, yi, _, _ = _CK.channelize_planar(
            re, im, cfg.prototype, torch.cat([zc, cre]),
            torch.cat([zc, cim]), num_channels=cfg.num_channels)
        # N >= 16384 > T - 1: the next context is the block's tail (a
        # copy, so that it never aliases a block buffer a caller reuses)
        nre = re[-(T - 1):].clone()
        nim = im[-(T - 1):].clone()
        return yr, yi, nre, nim
    return channelize


def _audio_tile_rows(cfg: BandMonitorConfig) -> int:
    """Largest kernel tile (<= 128 rows, multiple of 8) dividing the
    per-channel frame count, or 0 when the decimating-FIR kernel can't
    take this config (odd K, indivisible frames, too many taps).  The
    JAX package's rule, so that a config takes the same route on both
    sides."""
    if cfg.num_channels % 2:
        return 0
    if cfg.audio_taps.shape[0] > _DF.max_taps(cfg.audio_dec):
        return 0
    frames = cfg.frames_per_block
    tr = 128
    while tr >= 8 and frames % (tr * cfg.audio_dec * 128):
        tr //= 2
    return tr if tr >= 8 else 0


def _planar_core(cfg: BandMonitorConfig, channelize,
                 audio_tile_rows: int = 0, fast_demod: bool = True):
    """The staged block body on planes.  ``audio_tile_rows`` > 0 routes
    the audio FIR through the decimating-FIR kernel: one launch over all
    channels, channel k as the re plane and channel k + K/2 as the im
    plane of a batch row (real taps filter the planes independently).
    ``fast_demod`` selects the polynomial atan2."""
    audio_C = cfg.audio_C
    K = cfg.num_channels
    Tm1 = audio_C.size - 1
    at2 = demod.fast_atan2 if fast_demod else torch.atan2

    if audio_tile_rows:
        W = cfg.audio_dec * 128
        half = K // 2

        def audio_fir(d, actxs):
            kctx = d.new_zeros((K, W))
            kctx[:, W - Tm1:] = actxs
            yr, yi, _, _ = _DF.fir_decimate_planar(
                d[:half], d[half:], cfg.audio_taps, cfg.audio_dec,
                kctx[:half], kctx[half:], tile_rows=audio_tile_rows)
            return torch.cat([yr, yi]), d[:, d.shape[1] - Tm1:]
    else:
        def audio_fir(d, actxs):
            return fir.fir_decimate_poly(d, audio_C, actxs)

    def core(state, re, im):
        ctx_pairs, prev_pairs, actxs = state
        yr, yi, nre, nim = channelize(re, im,
                                      ctx_pairs[:, 0], ctx_pairs[:, 1])
        # Channel-major planes [K, frames]; d[j] from y[j] and y[j-1] in
        # the fused kernel's products and order (the signs of zero
        # products at stream start depend on it).
        rt = yr.T.contiguous()
        it = yi.T.contiguous()
        a, b = rt[:, 1:], rt[:, :-1]
        c, d_ = it[:, 1:], it[:, :-1]
        d_int = at2(c * b - a * d_, a * b + c * d_)
        d0 = at2(
            it[:, 0] * prev_pairs[:, 0] - rt[:, 0] * prev_pairs[:, 1],
            rt[:, 0] * prev_pairs[:, 0] + it[:, 0] * prev_pairs[:, 1])
        d = torch.cat([d0[:, None], d_int], dim=1)
        audio, new_actx = audio_fir(d, actxs)
        new_state = (
            torch.stack([nre, nim], dim=-1),
            torch.stack([rt[:, -1], it[:, -1]], dim=-1),
            new_actx,
        )
        return audio, new_state

    return core


def _staged_step(cfg: BandMonitorConfig, use_kernel, fast_demod: bool):
    """``(state, re, im) -> (audio, state)``; with ``use_kernel`` None
    the route is picked per call from the planes' device."""
    cores = {}

    def core_for(uk: bool):
        if uk not in cores:
            cores[uk] = _planar_core(
                cfg, _make_planar_channelize(cfg, uk),
                audio_tile_rows=_audio_tile_rows(cfg) if uk else 0,
                fast_demod=fast_demod)
        return cores[uk]

    if use_kernel is not None:
        core_for(bool(use_kernel))      # build-time errors surface here

    def step(state, re, im):
        uk = use_kernel
        if uk is None:
            uk = _auto_use_kernel(cfg, re.device)
        return core_for(bool(uk))(state, re, im)

    return step


def make_block_fn(cfg: BandMonitorConfig, use_kernel=None,
                  fast_demod: bool = True):
    """``(state, iq_pairs[N, 2]) -> (audio[K, M], state)``.

    ``use_kernel=True`` routes the channelizer through its kernel (K |
    128, taps_per_branch <= 16, block % 16384 == 0; an unmet constraint
    raises here) and, when the per-channel frame count divides a kernel
    tile (:func:`_audio_tile_rows`), the audio FIR through the
    decimating-FIR kernel; False keeps the tensor ops; None (default)
    picks the kernels for CUDA tensors when the constraints hold.
    ``fast_demod`` (default True) demodulates with the polynomial
    :func:`comms_tpu_torch.ops.demodulation.fast_atan2`; False with
    ``torch.atan2``.
    """
    step = _staged_step(cfg, use_kernel, fast_demod)

    def block(state, iq_pairs):
        return step(state, iq_pairs[:, 0].contiguous(),
                    iq_pairs[:, 1].contiguous())

    return block


def make_planar_block_fn(cfg: BandMonitorConfig, use_kernel=None,
                         fast_demod: bool = True):
    """Plane-native variant: ``(state, re[N], im[N]) -> (audio[K, M],
    state)``.  State is interchangeable with :func:`make_block_fn`
    mid-stream; ``use_kernel`` / ``fast_demod`` as there."""
    return _staged_step(cfg, use_kernel, fast_demod)
