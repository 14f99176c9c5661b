"""Large-N FFT and Welch numerator by a four-step split: the CUDA kernel
K10 (three stages) and its plain versions.

``csrc/fft_big.cu`` replaces the TPU kernel
``comms_tpu/kernels/fft_big_pallas.py``: N = n1 * n2 with both factors in
256..2048 (N = 2^16..2^22), x[n] viewed as [n1, n2] (n = i1*n2 + i2).

* Stage A (``_stageA``): per segment and tile of columns, demean and
  window, the n1-point column FFT, the four-step twiddle W_N^{i2 k1}; D is
  written as [segment, k1, n2].  It reads the three ingest layouts of the
  TPU kernel by index arithmetic: [B, N], [B, n1, n2] and the pre-blocked
  [B, n2/128, n1, 128].
* Stage B of :func:`psd_big_planar`: the n2-point row FFTs, |.|^2 summed
  over the segments in order (optionally the sparse demean).
* Stage B of :func:`fft_big_planar`: the row FFTs, natural order
  X[k1 + n1 k2].

:func:`welch_numerator` takes the per-segment means with one torch
reduction, as the JAX function does with one XLA reduction.  The TPU
kernel's ``_prep`` admits factors 4096..16384 that its stages do not
support; this port raises a ValueError for them.  Both ``precision``
values compute in float32 on the CUDA cores.

The wrappers launch the kernels for CUDA tensors and run the plain
versions for CPU tensors; any other device raises.  ``launches`` counts
the launches of each stage.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import fft as _fft

__all__ = ["psd_big_planar", "fft_big_planar", "welch_numerator",
           "factorize", "supported_big", "sparse_window_bins",
           "psd_big_plain", "fft_big_plain", "stage_a", "stage_a_plain"]

_CT = 128          # lanes of the pre-blocked ingest layout
_FACTORS = (256, 512, 1024, 2048)
_TW_LO = 2048      # entries of the low four-step twiddle table

# Kernel launches per stage since import (or since a caller reset them).
launches = {"stage_a": 0, "psd_stage_b": 0, "fft_stage_b": 0}


def factorize(n: int):
    """(n1, n2) with n1 * n2 == n, both in 256..2048, as square as
    possible (n1 the larger on a tie of distance); None if no pair
    exists."""
    best = None
    for n1 in (2048, 1024, 512, 256):
        if n % n1:
            continue
        n2 = n // n1
        if n2 not in _FACTORS:
            continue
        if best is None or abs(n1 - n2) < abs(best[0] - best[1]):
            best = (n1, n2)
    return best


def supported_big(n: int) -> bool:
    return factorize(int(n)) is not None


def sparse_window_bins(window, n1: int, n2: int, rel_tol: float = 1e-7):
    """FFT the window on the host and return its significant bins as
    ``(ks, Wvals)`` if they all fall in the first or last 128 values of
    k1 = k mod n1 (the near-DC/near-Nyquist support of a smooth periodic
    window: periodic Hann 3 bins, Hamming 3, Blackman 5), else None."""
    Wf = np.fft.fft(np.asarray(window, np.float64))
    mag = np.abs(Wf)
    ks = np.nonzero(mag > rel_tol * mag.max())[0]
    if len(ks) > 16:
        return None
    last = n1 // _CT - 1
    for k in ks:
        if (int(k) % n1) // _CT not in (0, last):
            return None
    return ks, Wf[ks]


def _prep(re, im, n1: int, n2: int):
    """Validate the planes and factors (the TPU kernel's messages).
    Returns ``(b, blocked)``."""
    for name, p in (("re", re), ("im", im)):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(p)}")
    if im.shape != re.shape or re.ndim not in (2, 3, 4):
        raise ValueError("expected [segments, N], [segments, n1, n2] "
                         "or [segments, n2//ct, n1, ct] planar f32 "
                         f"pair, got {tuple(re.shape)} / {tuple(im.shape)}")
    ok = ((n1 * n2,), (n1, n2), (n2 // _CT, n1, _CT))
    if tuple(re.shape[1:]) not in ok:
        raise ValueError(f"segment shape {tuple(re.shape[1:])} matches none "
                         f"of N = {n1 * n2}, (n1, n2) = ({n1}, {n2}), "
                         f"blocked ({n2 // _CT}, {n1}, {_CT})")
    if n1 not in _FACTORS or n2 not in _FACTORS:
        raise ValueError(f"n1={n1}, n2={n2} must both be in the supported "
                         f"stage sizes 256..2048")
    if im.device != re.device:
        raise ValueError(f"re is on {re.device}, im on {im.device}")
    return int(re.shape[0]), re.ndim == 4


def _natural(re, im, n1: int, n2: int):
    """Complex [b, N] in natural sample order from any ingest layout."""
    b = re.shape[0]
    x = torch.complex(re, im)
    if x.ndim == 4:
        x = x.permute(0, 2, 1, 3).reshape(b, n1, n2)
    return x.reshape(b, n1 * n2)


def _kernel_planes(p, b: int):
    """A plane whose segments the kernel reads at one segment stride:
    float32, each segment contiguous."""
    if p.dtype != torch.float32:
        raise ValueError(f"expected float32 planes, got {p.dtype}")
    if b and not p[0].is_contiguous():
        p = p.contiguous()
    return p


@functools.lru_cache(maxsize=32)
def _twiddle_tables(N: int, dev: str):
    """[2, N / 2048] of W_N^{2048 j} and [2, 2048] of W_N^j, float64 at
    integer indices, rounded to float32, on ``dev``."""
    j = np.arange(_TW_LO, dtype=np.int64)
    lo = np.exp((-2j * np.pi / N) * np.mod(j, N))
    h = np.arange(N // _TW_LO, dtype=np.int64)
    hi = np.exp((-2j * np.pi / N) * np.mod(h * _TW_LO, N))
    return (_build.device_constant(np.stack([hi.real, hi.imag]), dev),
            _build.device_constant(np.stack([lo.real, lo.imag]), dev))


@functools.lru_cache(maxsize=8)
def _four_step_twiddle(n1: int, n2: int, dev: str) -> torch.Tensor:
    """Complex64 [n1, n2] of W_N^{(k1 i2) mod N} on ``dev`` (the plain
    stage A's twiddle)."""
    N = n1 * n2
    idx = np.mod(np.arange(n1)[:, None] * np.arange(n2)[None, :], N)
    tw = np.exp((-2j * np.pi / N) * idx)
    return torch.from_numpy(tw.astype(np.complex64)).to(dev)


def _col_tile(n1: int) -> int:
    """Stage A's column-tile width: 32 columns up to n1 = 512, 16 at 1024,
    8 at 2048 (one tile of n1 * ct samples fits a block's shared
    memory)."""
    return 32 if n1 <= 512 else (16 if n1 == 1024 else 8)


def stage_a(re, im, n1: int, n2: int, window=None, means=None,
            emit_sums: bool = False):
    """Stage A on planes in any ingest layout: ``(dr, di, sums)``, D as
    [segments, n1, n2] (k1-major) and, with ``emit_sums``, the raw sums
    of each column tile [segments, n2 / _col_tile(n1), 2] (else None)."""
    b, blocked = _prep(re, im, n1, n2)
    dev = re.device
    if dev.type == "cpu":
        return _stage_a_cpu(re, im, n1, n2, window, means, emit_sums)
    _fft._cuda(dev, "stage A")
    re, im = _kernel_planes(re, b), _kernel_planes(im, b)
    if re.stride() != im.stride():
        re, im = re.contiguous(), im.contiguous()
    N = n1 * n2
    lib = _build.load()
    w = _fft._window(window, N, dev) if window is not None else None
    m = (torch.as_tensor(means, dtype=torch.float32, device=dev)
         .reshape(b, 2).contiguous() if means is not None else None)
    dr = torch.empty((b, n1, n2), dtype=torch.float32, device=dev)
    di = torch.empty_like(dr)
    ct = _col_tile(n1)
    sums = None
    if emit_sums:
        sums = torch.empty((b, n2 // ct, 2), dtype=torch.float32,
                           device=dev)
    tw1 = _fft.twiddles(n1, dev)
    hi, lo = _twiddle_tables(N, str(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fft_big_stage_a_launch(
            re.data_ptr(), im.data_ptr(), b, int(re.stride(0)), int(blocked),
            n1, n2, ct, w.data_ptr() if w is not None else None,
            m.data_ptr() if m is not None else None, tw1[0].data_ptr(),
            tw1[1].data_ptr(), hi[0].data_ptr(), hi[1].data_ptr(),
            lo[0].data_ptr(), lo[1].data_ptr(), dr.data_ptr(),
            di.data_ptr(), sums.data_ptr() if sums is not None else None,
            stream)
    if rc != 0:
        raise RuntimeError(f"FFT stage A kernel launch failed: CUDA error "
                           f"{rc}")
    launches["stage_a"] += 1
    return dr, di, sums


def psd_big_planar(re, im, n1: int, n2: int, window=None, means=None,
                   sparse_demean: bool = False,
                   precision: str = "split_bf16"):
    """Sum over segments of |FFT_N((x - mean) * w)|^2, N = n1 * n2.

    ``re, im``: float32 planes, one N-point segment per row, as [segments,
    N], [segments, n1, n2] or pre-blocked [segments, n2/128, n1, 128].
    ``window``: optional [N] host array or tensor.  ``means``: optional
    [segments, 2] (re, im) means subtracted before windowing.
    ``sparse_demean``: demean by FFT linearity instead (stage A emits the
    raw sums, stage B subtracts m * W at the window's edge bins); needs a
    window whose spectrum is edge-sparse (:func:`sparse_window_bins`).
    Exact in exact arithmetic, but the transform then runs on the signal
    with its offset, so a large DC offset costs accuracy.  Returns
    ``acc[N]`` float32, natural bin order: the un-normalised Welch
    numerator."""
    n1, n2 = int(n1), int(n2)
    _fft._check_precision(precision)
    if sparse_demean and means is not None:
        raise ValueError("pass either means or sparse_demean, not both")
    sb = None
    if sparse_demean:
        if window is None:
            raise ValueError("sparse_demean requires a window")
        sb = sparse_window_bins(
            window.cpu().numpy() if isinstance(window, torch.Tensor)
            else window, n1, n2)
        if sb is None:
            raise ValueError(
                "window spectrum is not edge-sparse; pass means= "
                "instead (see sparse_window_bins)")
    b, _ = _prep(re, im, n1, n2)
    dev = re.device
    if dev.type == "cpu":
        return psd_big_plain(re, im, n1, n2, window, means, sparse_demean)
    _fft._cuda(dev, "the big PSD")
    dr, di, sums = stage_a(re, im, n1, n2, window, means,
                           emit_sums=sparse_demean)
    N = n1 * n2
    lib = _build.load()
    out = torch.empty(N, dtype=torch.float32, device=dev)
    tw2 = _fft.twiddles(n2, dev)
    sp_k = sp_w = m = None
    nsp = 0
    if sparse_demean:
        ks, wv = sb
        nsp = len(ks)
        sp_k = _build.device_constant(np.asarray(ks), dev, np.int32)
        sp_w = _build.device_constant(np.stack([wv.real, wv.imag], -1), dev)
        m = (sums.sum(dim=1) * (1.0 / N)).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fft_big_stage_b_psd_launch(
            dr.data_ptr(), di.data_ptr(), b, n1, n2, tw2[0].data_ptr(),
            tw2[1].data_ptr(), sp_k.data_ptr() if nsp else None,
            sp_w.data_ptr() if nsp else None, nsp,
            m.data_ptr() if nsp else None, out.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"PSD stage B kernel launch failed: CUDA error "
                           f"{rc}")
    launches["psd_stage_b"] += 1
    return out


def welch_numerator(re, im, window):
    """Factor N, take the per-segment means (one torch reduction over the
    planes) and return the accumulated |FFT(w (x - mean))|^2, the one
    Welch-numerator entry over this kernel.  Raises ValueError for an N
    without a two-factor decomposition."""
    if re.ndim == 4:
        fac = (int(re.shape[2]), int(re.shape[1]) * int(re.shape[3]))
        axes = (1, 2, 3)
    elif re.ndim == 3:
        fac = (int(re.shape[1]), int(re.shape[2]))
        axes = (1, 2)
    else:
        fac = factorize(int(re.shape[-1]))
        if fac is None:
            raise ValueError(
                f"N={re.shape[-1]} has no two-factor decomposition "
                "into 256..2048-point stages (see supported_big)")
        axes = (1,)
    means = torch.stack([re.mean(dim=axes), im.mean(dim=axes)], -1)
    return psd_big_planar(re, im, fac[0], fac[1], window=window,
                          means=means)


def fft_big_planar(re, im, n1: int, n2: int, precision: str = "split_bf16"):
    """Batched N-point FFT (N = n1 * n2) of float32 planes in any of the
    three layouts.  Returns ``(yr, yi)`` [segments, N] float32, natural
    bin order."""
    n1, n2 = int(n1), int(n2)
    _fft._check_precision(precision)
    b, _ = _prep(re, im, n1, n2)
    dev = re.device
    if dev.type == "cpu":
        return fft_big_plain(re, im, n1, n2)
    _fft._cuda(dev, "the big FFT")
    dr, di, _ = stage_a(re, im, n1, n2)
    N = n1 * n2
    lib = _build.load()
    yr = torch.empty((b, N), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    tw2 = _fft.twiddles(n2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fft_big_stage_b_fft_launch(
            dr.data_ptr(), di.data_ptr(), b, n1, n2, tw2[0].data_ptr(),
            tw2[1].data_ptr(), yr.data_ptr(), yi.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"FFT stage B kernel launch failed: CUDA error "
                           f"{rc}")
    launches["fft_stage_b"] += 1
    return yr, yi


def psd_big_plain(re, im, n1: int, n2: int, window=None, means=None,
                  sparse_demean: bool = False):
    """:func:`psd_big_planar`'s function in plain PyTorch, on any device:
    the natural-order segments, demean, window, ``torch.fft.fft`` over N,
    |.|^2, segment sum; with ``sparse_demean``, FFT(w x) - m W at the
    window's bins, m each segment's mean."""
    x = _natural(re, im, n1, n2)
    N = n1 * n2
    w = (_fft._window(window, N, x.device).to(x.real.dtype)
         if window is not None else None)
    if sparse_demean:
        ks, wv = sparse_window_bins(
            window.cpu().numpy() if isinstance(window, torch.Tensor)
            else window, n1, n2)
        m = x.mean(dim=1, keepdim=True)
        y = torch.fft.fft(x * w, dim=1)
        W = torch.zeros(N, dtype=x.dtype, device=x.device)
        W[torch.as_tensor(ks, device=x.device)] = torch.as_tensor(
            wv, dtype=x.dtype, device=x.device)
        y = y - m * W
    else:
        if means is not None:
            m = torch.as_tensor(means, device=x.device).to(x.real.dtype)
            x = x - torch.complex(m[:, 0], m[:, 1])[:, None]
        if w is not None:
            x = x * w
        y = torch.fft.fft(x, dim=1)
    return y.abs().square().sum(0)


def fft_big_plain(re, im, n1: int, n2: int):
    """:func:`fft_big_planar`'s function in plain PyTorch:
    ``torch.fft.fft`` over the natural-order segments."""
    y = torch.fft.fft(_natural(re, im, n1, n2), dim=1)
    return y.real.contiguous(), y.imag.contiguous()


def _stage_a_cpu(re, im, n1, n2, window, means, emit_sums):
    d = stage_a_plain(re, im, n1, n2, window, means)
    sums = None
    if emit_sums:
        x = _natural(re, im, n1, n2).reshape(-1, n1, n2 // _col_tile(n1),
                                             _col_tile(n1)).sum(dim=(1, 3))
        sums = torch.stack([x.real, x.imag], -1)
    return d.real.contiguous(), d.imag.contiguous(), sums


def stage_a_plain(re, im, n1: int, n2: int, window=None, means=None):
    """Stage A's function in plain PyTorch (D as [segments, n1, n2]): the
    reference the stage is held to on the card."""
    x = _natural(re, im, n1, n2)
    N = n1 * n2
    if means is not None:
        m = torch.as_tensor(means, device=x.device).to(x.real.dtype)
        x = x - torch.complex(m[:, 0], m[:, 1])[:, None]
    if window is not None:
        x = x * _fft._window(window, N, x.device).to(x.real.dtype)
    d = torch.fft.fft(x.reshape(-1, n1, n2), dim=1)
    return d * _four_step_twiddle(n1, n2, str(x.device)).to(d.dtype)
