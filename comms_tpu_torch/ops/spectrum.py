"""Spectral monitoring: Welch power spectral density and spectrogram.

Counterpart of :mod:`comms_tpu.ops.spectrum`: channel occupancy,
interference and noise-floor monitoring.  On a CUDA tensor of a size the
kernels take, the work runs on the port's kernels, the route the JAX
package takes on a TPU:

* :func:`welch_psd_planar`, the serving path: raw float32 planes into the
  50%-overlap stream accumulator K7 (``kernels/fft.psd_stream_planar``);
* :func:`welch_psd`: segments of 256..16384 into K7's segment-row entry
  (``psd_planar``, reading the overlapped rows as a strided view of the
  planes), segments of 2^16..2^22 into K10's Welch numerator
  (``kernels/fft_big.welch_numerator``; only for a host window, as in the
  JAX package);
* :func:`spectrogram`: the windowed segments through K6
  (``kernels/fft.fft_planar``).

Anything else runs through ``torch.fft.fft``.  On the TPU the JAX
package's fallback of :func:`welch_psd` goes through the four-step DFT
matmuls, which degenerate to a dense DFT for sizes with no divisor <= 128;
the port's fallback is ``torch.fft.fft``, the JAX package's fallback on
every other platform.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import fft as _FK
from comms_tpu_torch.kernels import fft_big as _FB

__all__ = ["hann", "welch_psd", "welch_psd_planar", "spectrogram"]


def hann(n: int) -> np.ndarray:
    """Periodic Hann window (host, float64)."""
    return 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(n) / n)


def _nseg(length: int, nperseg: int, noverlap: int) -> int:
    step = nperseg - noverlap
    if step <= 0:
        raise ValueError(f"noverlap {noverlap} must be < nperseg {nperseg}")
    nseg = (length - noverlap) // step
    if nseg < 1:
        raise ValueError(
            f"signal length {length} shorter than one segment ({nperseg})")
    return nseg


def _segments(x, nperseg: int, noverlap: int):
    """Segment rows ``[nseg, nperseg]`` at start stride nperseg - noverlap,
    in time order: one ``unfold`` view, for every overlap."""
    _nseg(x.shape[0], nperseg, noverlap)
    return x.unfold(0, nperseg, nperseg - noverlap)


def _segment_parts(x, nperseg: int, noverlap: int):
    """Segment rows for order-free callers (Welch accumulation), or None
    when the step does not divide nperseg: there the JAX package needs a
    gather and takes its XLA route, so the port takes the same route."""
    _nseg(x.shape[0], nperseg, noverlap)
    if nperseg % (nperseg - noverlap):
        return None
    return _segments(x, nperseg, noverlap)


def _auto_use_kernel(x, nperseg: int, big: bool = False) -> bool:
    """The kernel route: a CUDA tensor and a size the small kernels take
    (or, with ``big``, welch_psd's four-step sizes 2^16..2^22)."""
    if x.device.type != "cuda":
        return False
    return _FK.supported(nperseg) or (big and _FB.supported_big(nperseg))


def _planes(x):
    """Contiguous float32 (re, im) planes of a real or complex tensor."""
    if x.is_complex():
        return (x.real.to(torch.float32).contiguous(),
                x.imag.to(torch.float32).contiguous())
    re = x.to(torch.float32).contiguous()
    return re, torch.zeros_like(re)


def _window_and_scale(window, nperseg: int, fs: float, device):
    """(window, 1 / (fs * sum(w^2))): a host window stays numpy and its
    scale a float; a tensor window gives a tensor scale on its device."""
    if isinstance(window, torch.Tensor):
        w = window.to(device=device, dtype=torch.float32)
        return w, 1.0 / (fs * torch.sum(w ** 2))
    w = np.asarray(window) if window is not None else hann(nperseg)
    return w, 1.0 / (fs * float(np.sum(w ** 2)))


def welch_psd_planar(re, im, nperseg: int = 1024, window=None,
                     fs: float = 1.0, onesided: bool = False):
    """Plane-native Welch PSD at the standard 50% overlap, the serving
    path: raw float32 re/im planes ``[N]`` straight into the stream
    accumulator.  Requires a kernel size and N a multiple of
    ``rows_per_step(nperseg) * nperseg``; :func:`welch_psd` is the general
    entry.  Returns ``(freqs, psd)``."""
    nperseg = int(nperseg)
    w, scale = _window_and_scale(window, nperseg, fs, re.device)
    nseg = 2 * (int(re.shape[0]) // nperseg) - 1
    acc = _FK.psd_stream_planar(re, im, w, n=nperseg, demean=True)
    psd = acc * (scale / nseg)
    return _fold(psd, nperseg, fs, onesided)


def welch_psd(x, nperseg: int = 1024, noverlap: int | None = None,
              window=None, fs: float = 1.0, onesided: bool = False,
              use_kernel=None):
    """Welch PSD estimate of a (complex or real) sample block ``x[N]``.

    Returns ``(freqs, psd)``; density normalization matches the standard
    Welch definition (window power corrected).  ``onesided`` folds the
    spectrum for real inputs.  ``use_kernel``: route the window + FFT +
    |.|^2 + accumulate through the kernels (None: for CUDA tensors of a
    kernel size)."""
    nperseg = int(nperseg)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    tensor_w = isinstance(window, torch.Tensor)
    w, scale = _window_and_scale(window, nperseg, fs, x.device)
    if w.shape[0] != nperseg:
        raise ValueError("window length must equal nperseg")
    if use_kernel is None:
        use_kernel = _auto_use_kernel(x, nperseg, big=True)

    if use_kernel:
        small = _FK.supported(nperseg)
        re, im = _planes(x)
        segs_r = _segment_parts(re, nperseg, noverlap)
        # the four-step kernel takes a host window only, as on the TPU
        if segs_r is not None and (small or not tensor_w):
            segs_i = im.unfold(0, nperseg, nperseg - noverlap)
            nseg = segs_r.shape[0]
            if small:
                acc = _FK.psd_planar(segs_r, segs_i, w, n=nperseg,
                                     demean=True)
            else:
                acc = _FB.welch_numerator(segs_r, segs_i, w)
            psd = acc * (scale / nseg)
            return _fold(psd, nperseg, fs, onesided)
        # gather-pattern overlaps take the tensor route, as on the TPU

    segs = _segments(x, nperseg, noverlap)             # [nseg, nperseg]
    segs = segs - segs.mean(dim=1, keepdim=True)
    rdt = segs.real.dtype if segs.is_complex() else segs.dtype
    wv = (w.to(rdt) if tensor_w
          else torch.from_numpy(w.astype(np.float32)).to(x.device))
    spec = torch.fft.fft(segs * wv[None, :], dim=1)
    p = spec.abs().square().mean(dim=0)
    psd = p * scale
    return _fold(psd, nperseg, fs, onesided)


def _fold(psd, nperseg: int, fs: float, onesided: bool):
    freqs = np.fft.fftfreq(nperseg, d=1.0 / fs)
    if onesided:
        half = nperseg // 2 + 1
        k = torch.arange(half, device=psd.device)
        psd = psd[:half] * torch.where((k > 0) & (k < nperseg - half + 1),
                                       2.0, 1.0).to(psd.dtype)
        freqs = np.abs(freqs[:half])
        freqs[-1] = abs(fs / 2.0)
    return freqs, psd


def spectrogram(x, nperseg: int = 256, noverlap: int | None = None,
                window=None, use_kernel=None):
    """Short-time power spectrogram [time, freq] (fftshifted).

    ``use_kernel`` routes the batched FFT through the FFT kernel (None:
    for CUDA tensors of a kernel size); the windowed segments keep their
    time order, so this path uses the natural-order FFT rather than the
    PSD accumulator."""
    nperseg = int(nperseg)
    noverlap = nperseg // 2 if noverlap is None else int(noverlap)
    w = np.asarray(window) if window is not None else hann(nperseg)
    if use_kernel is None:
        use_kernel = _auto_use_kernel(x, nperseg)
    segs = _segments(x, nperseg, noverlap)
    rdt = segs.real.dtype if segs.is_complex() else segs.dtype
    wt = torch.from_numpy(w.astype(np.float32)).to(
        device=x.device, dtype=rdt)[None, :]
    if use_kernel:
        # the windowed planes straight from the segments (no complex
        # intermediate to split), |.|^2 in place on the kernel's output
        if segs.is_complex():
            re, im = segs.real * wt, segs.imag * wt
        else:
            re = segs * wt
            im = torch.zeros_like(re)
        yr, yi = _FK.fft_planar(re.to(torch.float32), im.to(torch.float32),
                                n=nperseg)
        p = yr.mul_(yr).addcmul_(yi, yi)
    else:
        p = torch.fft.fft(segs * wt, dim=1).abs().square()
    return torch.fft.fftshift(p, dim=1)
