"""The fused band monitor: one CUDA kernel, and its plain version.

    f32 re/im planes [N] -> K-channel polyphase channelizer
      -> lag-1 FM demod per channel (polynomial atan2)
      -> decimating audio FIR per channel -> audio [N/K/dec, K]

Counterpart of :mod:`comms_tpu.kernels.band_monitor_pallas`, with its
contract: ``band_monitor_planar(re, im, prototype, audio_taps, audio_dec,
ctx_re, ctx_im, spec_halo_re, spec_halo_im, num_channels)`` over planes
whose length is a multiple of :func:`step_samples`; K dividing 128, at
most 16 taps per branch, ``audio_dec`` dividing 128 in [2, 16], at most
``31*(128/K) + 1`` audio taps.  The carried state is the input context
(``CTX_SAMPLES``, of which the trailing T-1 count) and the spectrum
tail: ``halo_rows(K, T)`` rows of 128, which is the last
``halo_rows*128/K`` spectrum frames, frames-major.

The kernel, ``csrc/band_monitor.cu``, replaces the TPU kernel
``comms_tpu/kernels/band_monitor_pallas.py::band_monitor_pallas_planar``.
On the H100 it reads 8 bytes per complex sample; its direct K-point DFT
(4K multiply-adds a sample) and the demod's atan2 are the work, and the
instructions around them (loads, index arithmetic, barriers) set its
time, so its design cuts those: each block walks a run of consecutive
tiles of 4096/K frames (:func:`partition`, fixed by the shape) and
carries the last phase differences from tile to tile; for K <= 16 one
thread holds a frame's branch sums and spectrum in registers, with the
roots and the branch matrix passed by value as constant operands.  Every
sum keeps one order, so the output does not depend on the tiling.
Device memory sees the input and the audio once.  It writes the new
carried state itself, so a block step makes one launch.  The source's
header says more.

:func:`band_monitor_planar` launches the kernel for CUDA tensors and
runs :func:`band_monitor_plain` for CPU tensors; any other device
raises.  It never falls back: a CUDA tensor gets the kernel or an
exception.  ``launches`` counts the kernel launches (not the plain
runs).  The returned audio is a [N/K/dec, K] view of channel-major
memory, so its transpose (the models' [K, N/K/dec]) is contiguous.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import channelizer as _CK
from comms_tpu_torch.ops import channelizer as _chan
from comms_tpu_torch.ops import demodulation as _demod
from comms_tpu_torch.ops import fir as _fir
from comms_tpu_torch.runtime.metrics import scoped

__all__ = ["band_monitor_planar", "band_monitor_plain", "halo_rows",
           "zero_spec_halo", "partition", "CTX_SAMPLES", "step_samples"]

CTX_SAMPLES = _CK.CTX_SAMPLES
step_samples = _CK.step_samples
_LANES = 128

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

# The tiles of a call are spread over about this many blocks, each
# walking a run of consecutive tiles.  A fixed count, so that the
# partition follows from the shape alone and not from the card (the
# output's bits depend on neither).
_RUN_BLOCKS = 264


def partition(n_frames: int, num_channels: int):
    """The kernel's partition of ``n_frames`` spectrum frames:
    ``(tile_frames, run, blocks)``, tiles of 4096/K frames, ``run``
    consecutive tiles a block."""
    T = 4096 // int(num_channels)
    tiles = int(n_frames) // T
    run = max(1, -(-tiles // _RUN_BLOCKS))
    return T, run, -(-tiles // run)


def halo_rows(num_channels: int, audio_taps_len: int) -> int:
    """Carried spectrum rows of 128 values (128/K frames each): the
    audio FIR reaches back taps-1 frames and the demod lag one more;
    the TPU kernel's packed layout adds 128/K - 1 frames and rounds up
    to 8 rows.  The same count as the JAX package, so that the states
    are interchangeable."""
    kpr = _LANES // int(num_channels)
    need = -(-(int(audio_taps_len) - 1 + kpr) // kpr)
    return max(8, -(-need // 8) * 8)


def zero_spec_halo(num_channels: int, audio_taps_len: int, device="cuda"):
    """Stream-start spectrum-tail planes (pair of [halo_rows, 128])."""
    h = halo_rows(num_channels, audio_taps_len)
    z = torch.zeros((h, _LANES), dtype=torch.float32, device=device)
    return z, z


def _check(re, im, prototype, audio_taps, audio_dec, ctx_re, ctx_im,
           spec_halo_re, spec_halo_im, num_channels):
    """The TPU kernel's constraints, with its messages.  Returns
    ``(k, M, h, at, dec, hrows)``."""
    for name, p in (("re", re), ("im", im)):
        _CK._check_plane(name, p)
    if re.shape != im.shape or re.device != im.device:
        raise ValueError("re and im differ in length or device")
    k = int(num_channels)
    dec = int(audio_dec)
    if k < 2 or _LANES % k:
        raise ValueError(f"num_channels {k} must divide 128")
    h = np.asarray(prototype, np.float64)
    if h.shape[0] % k:
        raise ValueError(f"prototype length must be a multiple of {k}")
    M = h.shape[0] // k
    if M > 16:
        raise ValueError(f"taps_per_branch {M} > 16 unsupported")
    if k * M > CTX_SAMPLES + 1:
        raise ValueError(
            f"prototype length {k * M} exceeds the {CTX_SAMPLES}-"
            "sample halo zone")
    at = np.asarray(audio_taps, np.float64)
    kpr = _LANES // k
    if dec < 2 or _LANES % dec or dec > 16:
        raise ValueError(
            f"audio_dec {dec} must divide 128 and be in [2, 16]")
    if at.shape[0] > 31 * kpr + 1:
        raise ValueError(
            f"audio taps {at.shape[0]} > {31 * kpr + 1} unsupported "
            f"(spectrum halo caps at 32 rows)")
    N = re.shape[0]
    if N % step_samples():
        raise ValueError(f"N {N} must be a multiple of {step_samples()}")
    for name, c in (("ctx_re", ctx_re), ("ctx_im", ctx_im)):
        _CK._check_plane(name, c)
        if c.shape[0] != CTX_SAMPLES:
            raise ValueError(f"ctx must be {CTX_SAMPLES} samples")
    hrows = halo_rows(k, at.shape[0])
    for c in (spec_halo_re, spec_halo_im):
        if tuple(c.shape) != (hrows, _LANES):
            raise ValueError(
                f"spec halo must be [{hrows}, {_LANES}] for K={k}, "
                f"taps={at.shape[0]} — got {tuple(c.shape)}")
        if c.dtype != torch.float32 or not c.is_contiguous():
            raise ValueError("spec halo must be contiguous float32")
    for c in (ctx_re, ctx_im, spec_halo_re, spec_halo_im):
        if c.device != re.device:
            raise ValueError(f"state on {c.device}, planes on {re.device}")
    return k, M, h, at.astype(np.float32), dec, hrows


@scoped("kernel.band_monitor")
def band_monitor_planar(re, im, prototype, audio_taps, audio_dec: int,
                        ctx_re, ctx_im, spec_halo_re, spec_halo_im,
                        num_channels: int):
    """Fused band monitor step on planes.

    Args:
      re, im: [N] float32 wideband input planes, N % step_samples() == 0.
      prototype: length K*M real channelizer lowpass (M <= 16), host.
      audio_taps: [T] real audio FIR taps (host), T <= 31*(128//K) + 1.
      audio_dec: per-channel audio decimation, dividing 128, in [2, 16].
      ctx_re, ctx_im: [CTX_SAMPLES] carried input-tail planes.
      spec_halo_re/_im: [halo_rows(K, T), 128] carried spectrum-tail
        planes (:func:`zero_spec_halo` at stream start).
      num_channels: K, dividing 128.

    Returns ``(audio[N // K // audio_dec, K], new_ctx_re, new_ctx_im,
    new_spec_halo_re, new_spec_halo_im)``.  On a CUDA device the kernel
    is launched on the current stream and not waited for.
    """
    global launches
    k, M, h, at, dec, hrows = _check(
        re, im, prototype, audio_taps, audio_dec, ctx_re, ctx_im,
        spec_halo_re, spec_halo_im, num_channels)
    dev = re.device
    if dev.type == "cpu":
        return _plain(re, im, h, k, at, dec, ctx_re, ctx_im, spec_halo_re,
                      spec_halo_im)
    if dev.type != "cuda":
        raise ValueError(f"band_monitor_planar runs on CUDA or CPU "
                         f"tensors, got {dev}")
    lib = _build.load()
    frames = re.shape[0] // k
    n_audio = frames // dec
    hframes = hrows * (_LANES // k)
    f32 = dict(dtype=torch.float32, device=dev)
    audio = torch.empty((k, n_audio), **f32)
    halo_r = torch.empty((hrows, _LANES), **f32)
    halo_i = torch.empty((hrows, _LANES), **f32)
    ctx_r = torch.empty((CTX_SAMPLES,), **f32)
    ctx_i = torch.empty((CTX_SAMPLES,), **f32)
    # The roots and (K <= 16) the branch matrix go by value in the
    # launch's parameters; above K = 16 the kernel reads C on the card.
    C = _CK.branch_matrix(h, k)
    roots = _CK.root_table(k)
    C_dev = _build.device_constant(C, dev).data_ptr() if k > 16 else None
    taps = _build.device_constant(at, dev)
    _, run, _ = partition(frames, k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.band_monitor_launch(
            re.data_ptr(), im.data_ptr(), ctx_re.data_ptr(),
            ctx_im.data_ptr(), CTX_SAMPLES, spec_halo_re.data_ptr(),
            spec_halo_im.data_ptr(), hframes, C.ctypes.data,
            roots.ctypes.data, C_dev, k, M, taps.data_ptr(), at.shape[0],
            dec, frames, run, audio.data_ptr(), halo_r.data_ptr(),
            halo_i.data_ptr(), ctx_r.data_ptr(), ctx_i.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"band monitor kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return audio.T, ctx_r, ctx_i, halo_r, halo_i


def band_monitor_plain(re, im, prototype, audio_taps, audio_dec: int,
                       ctx_re, ctx_im, spec_halo_re, spec_halo_im,
                       num_channels: int):
    """:func:`band_monitor_planar`'s function in plain PyTorch, on any
    device (the CPU path of the wrapper, and the reference the kernel is
    held to on the card): the plain channelizer, the demod over the
    carried and new spectrum frames in the kernel's order, and
    :func:`comms_tpu_torch.ops.fir.fir_decimate_poly` per channel."""
    k, _, h, at, dec, _ = _check(
        re, im, prototype, audio_taps, audio_dec, ctx_re, ctx_im,
        spec_halo_re, spec_halo_im, num_channels)
    return _plain(re, im, h, k, at, dec, ctx_re, ctx_im, spec_halo_re,
                  spec_halo_im)


def _plain(re, im, h, k, at, dec, ctx_re, ctx_im, yh_r, yh_i):
    C = _CK.branch_matrix(h, k)
    Tm1 = C.size - 1
    yr, yi, _, _ = _chan.channelize_block_planar(
        re, im, C, ctx_re[CTX_SAMPLES - Tm1:], ctx_im[CTX_SAMPLES - Tm1:])
    hrows = yh_r.shape[0]
    hframes = hrows * (_LANES // k)
    # Spectrum frames -hframes .. F-1, channel-major.
    Yr = torch.cat([yh_r.reshape(hframes, k), yr])
    Yi = torch.cat([yh_i.reshape(hframes, k), yi])
    rt = Yr.T.contiguous()
    it = Yi.T.contiguous()
    a, b = rt[:, 1:], rt[:, :-1]
    c, d_ = it[:, 1:], it[:, :-1]
    # The kernel's products and order (dotp = yr*pr + yi*pi, cross =
    # yi*pr - yr*pi), which fix the signs of zero products at stream
    # start.  d[:, i] is frame i - (hframes - 1).
    d = _demod.fast_atan2(c * b - a * d_, a * b + c * d_)
    Hb = _fir.decimating_branch_taps(at, dec)
    L = Hb.size - 1
    head = d[:, :hframes - 1]
    if L > head.shape[1]:     # taps padded to MD reach past the tail
        head = torch.cat([head.new_zeros(k, L - head.shape[1]), head], 1)
    audio, _ = _fir.fir_decimate_poly(d[:, hframes - 1:], Hb,
                                      head[:, head.shape[1] - L:])
    return (audio.T, re[-CTX_SAMPLES:].clone(), im[-CTX_SAMPLES:].clone(),
            Yr[-hframes:].reshape(hrows, _LANES).clone(),
            Yi[-hframes:].reshape(hrows, _LANES).clone())
