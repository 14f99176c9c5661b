"""Batched FFT rows and Welch accumulation: the CUDA kernels K6 and K7,
and their plain versions.

* :func:`fft_planar` (``csrc/fft.cu``) replaces the TPU kernel
  ``comms_tpu/kernels/fft_pallas.py::fft_pallas_planar`` (and
  :func:`fft_complex` its complex shim ``fft_pallas``): one n-point FFT
  per row of float32 re/im planes ``[rows, n]``, n = 256..16384 (powers
  of two), natural bin order, times ``scale``.  Each row runs on the
  register FFT of ``csrc/fft_reg.cuh`` (shared with K10): 16 points a
  thread loaded straight from the planes, radix-16 passes with one to
  three shared-memory exchanges, and the outputs stored straight from
  registers; row-strided views are read in place.  The inverse is the
  plane swap, ``ifft(z) = swap(fft(swap(z))) / n``, as the JAX callers
  use it.
* :func:`psd_planar` and :func:`psd_stream_planar` (``csrc/psd.cu``, one
  kernel with two entries, on the same register FFT with K6's twiddles)
  replace ``psd_pallas_planar`` and ``psd_stream_pallas_planar``: window
  * (x - mean) -> FFT -> |.|^2 summed over segment rows, or over the
  2N/n - 1 segments at 50% overlap of a flat stream.  Each thread group
  walks a run of consecutive segments (:func:`psd_partition`); at row
  stride n/2 it keeps the overlapping raw half in registers, so each
  sample is read from device memory once.  Both return ``acc[n]`` in
  natural bin order, summed in a fixed order (no float atomics).

Both ``precision`` values of the TPU kernels ("split_bf16", its bf16x3
DFT matmuls, and "highest") compute in float32 on the CUDA cores here;
any other value raises.  The twiddle table W_n^k of the register FFT is
made on the host in float64 from integer indices and kept on the card as
(re, im) pairs (:func:`pass_twiddles`, :func:`_build.device_constant`).

The wrappers launch the kernels for CUDA tensors and run the plain
versions for CPU tensors; any other device raises.  ``launches`` counts,
per entry, the calls that launched kernels (a PSD call launches a
partial-sum and a reduction kernel and counts once).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from comms_tpu_torch.kernels import _build

__all__ = ["fft_planar", "fft_complex", "psd_planar", "psd_stream_planar",
           "fft_plain", "psd_plain", "psd_stream_plain", "rows_per_step",
           "supported", "pass_twiddles", "psd_partition"]

_SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)
_PRECISIONS = ("split_bf16", "highest")
# K7's run partition (csrc/psd.cu): blocks of max(_PSD_MIN_THREADS, n/16)
# threads, and runs sized so that all runs together hold about
# _PSD_RUN_THREADS threads (one wave of 512 threads on each of 132 SMs:
# longer runs write fewer partial rows) in at least _PSD_MIN_BLOCKS blocks
# (16384 points: one block of 1024 threads an SM).  Fixed counts: the
# summation order, and so the bits, do not depend on the card.
_PSD_MIN_THREADS = 128
_PSD_RUN_THREADS = 1 << 16
_PSD_MIN_BLOCKS = 128

# Kernel launches per entry since import (or since a caller reset them).
launches = {"fft": 0, "psd": 0, "psd_stream": 0}


def supported(n: int) -> bool:
    """True when the kernels handle n-point FFTs (powers of two in
    256..16384, the TPU kernel's set)."""
    return n in _SIZES


def rows_per_step(n: int) -> int:
    """The TPU kernel's row tile (2^17 samples per grid step); the stream
    entry keeps its block quantum, ``rows_per_step(n) * n``, so that both
    packages accept the same blocks."""
    return (1 << 17) // int(n)


def pass_twiddles(n: int, device) -> torch.Tensor:
    """[n, 2] float32 table of W_n^k as (re, im) pairs on ``device``, from
    float64 at the integer index k: the register FFT's pass twiddles (K6
    and K10), one 8-byte load each."""
    return _pass_twiddles_on(int(n), str(torch.device(device)))


@functools.lru_cache(maxsize=64)
def _pass_twiddles_on(n: int, device: str) -> torch.Tensor:
    w = np.exp((-2j * np.pi / n) * np.arange(n))
    return _build.device_constant(np.stack([w.real, w.imag], -1), device)


def psd_partition(rows: int, n: int) -> tuple[int, int]:
    """``(per_run, blocks)`` of a K7 call over ``rows`` segments of n
    points: each group of n/16 threads walks ``per_run`` consecutive
    segments (the last run may be short), G = max(128, n/16) / (n/16)
    groups a block, one partial row a block."""
    T = int(n) // 16
    G = max(_PSD_MIN_THREADS, T) // T
    per_run = -(-int(rows) // max(_PSD_RUN_THREADS // T,
                                  _PSD_MIN_BLOCKS * G))
    runs = -(-int(rows) // per_run)
    return per_run, -(-runs // G)


def _check_precision(precision: str) -> None:
    if precision not in _PRECISIONS:
        raise ValueError(f"precision must be split_bf16/highest, "
                         f"got {precision!r}")


def _check_rows(re, im, n: int) -> None:
    for name, p in (("re", re), ("im", im)):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(p)}")
    if re.ndim != 2 or re.shape[1] != n or im.shape != re.shape:
        raise ValueError(f"expected planar [rows, {n}] f32 pair, got "
                         f"{tuple(re.shape)} / {tuple(im.shape)}")
    if im.device != re.device:
        raise ValueError(f"re is on {re.device}, im on {im.device}")


def _cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on CUDA or CPU tensors, got {dev}")


def _f32(p: torch.Tensor) -> torch.Tensor:
    if p.dtype != torch.float32:
        raise ValueError(f"expected float32 planes, got {p.dtype}")
    return p


def _window(window, n: int, dev) -> torch.Tensor:
    """The window as a contiguous float32 [n] tensor on ``dev``."""
    if isinstance(window, torch.Tensor):
        w = window.to(device=dev, dtype=torch.float32).reshape(-1)
        w = w.contiguous()
    else:
        w = _build.device_constant(
            np.asarray(window, np.float32).reshape(-1), dev)
    if w.shape[0] != n:
        raise ValueError(f"window must have {n} samples, got {w.shape[0]}")
    return w


def fft_planar(re, im, n: int = 1024, precision: str = "split_bf16",
               scale: float = 1.0):
    """Batched n-point FFT of float32 planes ``[rows, n]``, one transform
    per row, times ``scale`` (e.g. 1/sqrt(n) for a unitary transform).
    Rows at one row stride with unit sample stride (views of a wider or
    flat plane) are read in place.  Returns ``(yr, yi)`` [rows, n]
    float32, contiguous, natural bin order."""
    n = int(n)
    if not supported(n):
        raise ValueError(f"fft_planar supports n in 256..16384 "
                         f"(powers of two), got {n}")
    _check_rows(re, im, n)
    _check_precision(precision)
    if re.device.type == "cpu":
        return fft_plain(re, im, scale)
    _cuda(re.device, "the FFT")
    xr, xi = _row_view(re, im)
    rows, dev = int(xr.shape[0]), xr.device
    yr = torch.empty((rows, n), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    if rows == 0:
        return yr, yi
    lib = _build.load()
    tw = pass_twiddles(n, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fft_launch(xr.data_ptr(), xi.data_ptr(), rows,
                            int(xr.stride(0)), n, tw.data_ptr(),
                            float(scale), yr.data_ptr(), yi.data_ptr(),
                            stream)
    if rc != 0:
        raise RuntimeError(f"FFT kernel launch failed: CUDA error {rc}")
    launches["fft"] += 1
    return yr, yi


def fft_complex(x, n: int = 1024, precision: str = "split_bf16"):
    """Batched n-point FFT of complex rows ``x[rows, n]`` (complex64),
    natural bin order: the complex shim over :func:`fft_planar`."""
    yr, yi = fft_planar(x.real.contiguous(), x.imag.contiguous(), n=n,
                        precision=precision)
    return torch.complex(yr, yi)


def _launch_psd(entry: str, re, im, w, row_w, demean: bool, n: int):
    """The PSD kernel over ``re.shape[0]`` segment rows at row stride
    ``re.stride(0)`` (unit sample stride)."""
    dev = re.device
    rows, stride = int(re.shape[0]), int(re.stride(0))
    per_run, blocks = psd_partition(rows, n)
    part = torch.empty((blocks, n), dtype=torch.float32, device=dev)
    out = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _build.load()
    tw = pass_twiddles(n, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.psd_launch(
            re.data_ptr(), im.data_ptr(), rows, stride, n, w.data_ptr(),
            row_w.data_ptr() if row_w is not None else None, int(demean),
            tw.data_ptr(), per_run, part.data_ptr(), blocks,
            out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"PSD kernel launch failed: CUDA error {rc}")
    launches[entry] += 1
    return out


def _row_view(re, im):
    """Planes whose rows the kernel can read at one row stride: unit
    sample stride and one stride for both (views of one flat plane, as
    ``unfold`` gives, stay views)."""
    _f32(re)
    _f32(im)
    if (re.stride(1) != 1 or re.stride() != im.stride()
            or re.stride(0) < 1):
        return re.contiguous(), im.contiguous()
    return re, im


def psd_planar(re, im, window, n: int = 1024, row_weights=None,
               demean: bool = True, precision: str = "split_bf16"):
    """Fused window + FFT + |.|^2 + accumulate over segment rows.

    ``re, im``: [rows, n] float32 segment planes (strided row views are
    read in place).  ``window``: [n] host array or tensor.
    ``row_weights``: optional [rows] weights (0 excludes a row).
    ``demean``: subtract each (weighted) segment's mean before windowing.
    Returns ``acc[n]`` float32: sum over rows of
    |FFT(w * (x - mean))|^2, natural bin order."""
    n = int(n)
    if not supported(n):
        raise ValueError(f"psd_planar supports n in 256..16384 "
                         f"(powers of two), got {n}")
    _check_rows(re, im, n)
    _check_precision(precision)
    rows = re.shape[0]
    dev = re.device
    if row_weights is not None:
        row_weights = torch.as_tensor(row_weights, dtype=torch.float32,
                                      device=dev)
        if tuple(row_weights.shape) != (rows,):
            raise ValueError("row_weights must be [rows]")
    if dev.type == "cpu":
        return psd_plain(re, im, window, row_weights, demean)
    _cuda(dev, "the PSD")
    w = _window(window, n, dev)
    if rows == 0:
        return torch.zeros(n, dtype=torch.float32, device=dev)
    xr, xi = _row_view(re, im)
    rw = row_weights.contiguous() if row_weights is not None else None
    return _launch_psd("psd", xr, xi, w, rw, demean, n)


def psd_stream_planar(re, im, window, n: int = 1024, demean: bool = True,
                      precision: str = "split_bf16"):
    """Welch accumulator over raw flat float32 planes ``[N]`` at 50%
    overlap: the sum over the 2N/n - 1 segments starting at multiples of
    n/2 of |FFT(w * (x - mean))|^2, natural bin order.  The segments are
    formed by the kernel's addressing: each sample is read from device
    memory once (the overlapping half stays in registers).
    N must be a multiple of ``rows_per_step(n) * n``, as on the TPU."""
    n = int(n)
    if not supported(n):
        raise ValueError(f"psd_stream supports n in 256..16384 "
                         f"(powers of two), got {n}")
    _check_precision(precision)
    for name, p in (("re", re), ("im", im)):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(p)}")
    if re.ndim != 1 or im.shape != re.shape:
        raise ValueError("expected flat [N] f32 planes")
    t = rows_per_step(n)
    N = int(re.shape[0])
    if N % (t * n):
        raise ValueError(f"N={N} must be a multiple of "
                         f"rows_per_step*n={t * n} (use psd_planar "
                         f"with explicit segments otherwise)")
    if im.device != re.device:
        raise ValueError(f"re is on {re.device}, im on {im.device}")
    if re.device.type == "cpu":
        return psd_stream_plain(re, im, window, n, demean)
    _cuda(re.device, "the PSD")
    w = _window(window, n, re.device)
    xr = _f32(re).contiguous().unfold(0, n, n // 2)
    xi = _f32(im).contiguous().unfold(0, n, n // 2)
    return _launch_psd("psd_stream", xr, xi, w, None, demean, n)


def fft_plain(re, im, scale: float = 1.0):
    """:func:`fft_planar`'s function in plain PyTorch, on any device:
    ``torch.fft.fft`` of the complex rows times ``scale``."""
    y = torch.fft.fft(torch.complex(re, im), dim=-1)
    if scale != 1.0:
        y = y * scale
    return y.real.contiguous(), y.imag.contiguous()


def psd_plain(re, im, window, row_weights=None, demean: bool = True):
    """:func:`psd_planar`'s function in plain PyTorch, on any device:
    (weighted) rows, demean, window, ``torch.fft.fft``, |.|^2, row sum."""
    x = torch.complex(re, im)
    if row_weights is not None:
        x = x * row_weights.to(x.real.dtype)[:, None]
    if demean:
        x = x - x.mean(dim=1, keepdim=True)
    w = _window(window, re.shape[1], re.device).to(x.real.dtype)
    p = torch.fft.fft(x * w, dim=1).abs().square()
    return p.sum(0)


def psd_stream_plain(re, im, window, n: int, demean: bool = True):
    """:func:`psd_stream_planar`'s function in plain PyTorch: the
    50%-overlap segments by ``unfold``, then :func:`psd_plain`."""
    return psd_plain(re.unfold(0, n, n // 2), im.unfold(0, n, n // 2),
                     window, None, demean)
