"""Large-N FFT and Welch numerator by a four-step split: the CUDA kernel
K10 (three stages) and its plain versions.

``csrc/fft_big.cu`` replaces the TPU kernel
``comms_tpu/kernels/fft_big_pallas.py``: N = n1 * n2 with both factors in
256..2048 (N = 2^16..2^22), x[n] viewed as [n1, n2] (n = i1*n2 + i2).

* Stage A (``_stageA``): per segment and tile of ct columns, demean and
  window, the n1-point column FFT, the four-step twiddle W_N^{i2 k1}; D is
  written tile-blocked, [segment, n2/ct, n1, ct] (:func:`d_rows` gives
  [segment, n1, n2]).  It reads the three ingest layouts of the TPU
  kernel by index arithmetic: [B, N], [B, n1, n2] and the pre-blocked
  [B, n2/128, n1, 128].
* Stage B of :func:`psd_big_planar`: the n2-point row FFTs, |.|^2 summed
  in order over groups of segments (optionally the sparse demean; the
  next segment's rows load while this one transforms), then a second
  launch adds the groups' partial sums in order.
* Stage B of :func:`fft_big_planar`: the row FFTs, natural order
  X[k1 + n1 k2].

Every transform runs in registers, 16 points a thread
(``csrc/fft_reg.cuh``).  :func:`fft_stage_b` and :func:`psd_stage_b`
run one entry's stage B alone on stage A's D, as ``[segments, n2/ct, n1,
ct, 2]`` float32 (re, im) pairs.

:func:`welch_numerator` takes the per-segment means with one torch
reduction, as the JAX function does with one XLA reduction.  The TPU
kernel's ``_prep`` admits factors 4096..16384 that its stages do not
support; this port raises a ValueError for them.  Both ``precision``
values compute in float32 on the CUDA cores.

The wrappers launch the kernels for CUDA tensors and run the plain
versions for CPU tensors; any other device raises.  ``launches`` counts
the launches of each stage (the PSD's stage B is
``PSD_STAGE_B_LAUNCHES`` launches).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import fft as _fft
from comms_tpu_torch.runtime.metrics import scoped

__all__ = ["psd_big_planar", "fft_big_planar", "welch_numerator",
           "factorize", "supported_big", "sparse_window_bins",
           "psd_big_plain", "fft_big_plain", "stage_a", "stage_a_plain",
           "d_rows", "psd_stage_b", "fft_stage_b", "PSD_STAGE_B_LAUNCHES"]

_CT = 128          # lanes of the pre-blocked ingest layout
_FACTORS = (256, 512, 1024, 2048)
_TW_LO = 2048      # entries of the low four-step twiddle table
# Points of one block's tile (512 threads of 16 points; the PSD's stage B
# always), widened to 16384 (1024 threads) where that is needed for
# stage A's column runs and the FFT's natural-order row runs to be
# _MIN_RUN floats long: 32 bytes, one sector (on the H100 shorter runs
# were slower, and so were 64-byte runs at 1024 points).
_TILE = 8192
_MIN_RUN = 8
# The PSD's stage B splits the segments into groups until its grid holds
# at least this many blocks (one group from 2^20 points up: the fastest
# of 128, 256 and 512 on the H100).  A fixed count, so the order of the
# sums, and with it the bits, do not depend on the card.
_PSD_MIN_BLOCKS = 128
# The PSD's stage B: the row FFTs with partial sums, then their reduction.
PSD_STAGE_B_LAUNCHES = 2

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


def _pairs(w: np.ndarray, dev) -> torch.Tensor:
    """Complex float64 values as a [len, 2] (re, im) float32 table on
    ``dev`` (the kernels load each entry as one float2)."""
    return _build.device_constant(np.stack([w.real, w.imag], -1), dev)


@functools.lru_cache(maxsize=32)
def _twiddle_tables(N: int, dev: str):
    """[N / 2048, 2] of W_N^{2048 j} and [2048, 2] of W_N^j, float64 at
    integer indices, rounded to float32, on ``dev``."""
    j = np.arange(_TW_LO, dtype=np.int64)
    lo = np.exp((-2j * np.pi / N) * np.mod(j, N))
    h = np.arange(N // _TW_LO, dtype=np.int64)
    hi = np.exp((-2j * np.pi / N) * np.mod(h * _TW_LO, N))
    return _pairs(hi, dev), _pairs(lo, dev)


@functools.lru_cache(maxsize=8)
def _four_step_twiddle(n1: int, n2: int, dev: str) -> torch.Tensor:
    """Complex64 [n1, n2] of W_N^{(k1 i2) mod N} on ``dev`` (the plain
    stage A's twiddle)."""
    N = n1 * n2
    idx = np.mod(np.arange(n1)[:, None] * np.arange(n2)[None, :], N)
    tw = np.exp((-2j * np.pi / N) * idx)
    return torch.from_numpy(tw.astype(np.complex64)).to(dev)


def _col_tile(n1: int) -> int:
    """Stage A's column-tile width ct (32 at n1 = 256 .. 8 at 1024 and
    2048)."""
    return max(_MIN_RUN, _TILE // n1)


def _fft_rows(n2: int) -> int:
    """Rows k1 per block of the FFT's stage B (32 at n2 = 256 .. 8 at 1024
    and 2048)."""
    return max(_MIN_RUN, _TILE // n2)


def _psd_seg_per_block(nseg: int, n1: int, n2: int) -> int:
    """Segments per block of the PSD's stage B: groups of segments until
    the grid holds ``_PSD_MIN_BLOCKS`` blocks (each group writes one
    partial sum)."""
    row_groups = n1 * n2 // _TILE
    groups = min(nseg, max(1, -(-_PSD_MIN_BLOCKS // row_groups)))
    return -(-nseg // groups)


def d_rows(d, n1: int, n2: int):
    """Stage A's tile-blocked D [segments, n2/ct, n1, ct] as [segments, n1,
    n2] (a copy)."""
    b = d.shape[0]
    return d.permute(0, 2, 1, 3).reshape(b, n1, n2)


def _check_d(d, n1: int, n2: int) -> int:
    """Validate stage A's D for a stage B entry: contiguous float32
    [segments, n2/ct, n1, ct, 2], ct = ``_col_tile(n1)``.  Returns the
    segment count."""
    if n1 not in _FACTORS or n2 not in _FACTORS:
        raise ValueError(f"n1={n1}, n2={n2} must both be in the supported "
                         f"stage sizes 256..2048")
    ct = _col_tile(n1)
    if not isinstance(d, torch.Tensor) or d.dtype != torch.float32 \
            or d.ndim != 5 or tuple(d.shape[1:]) != (n2 // ct, n1, ct, 2) \
            or not d.is_contiguous():
        got = (f"{d.dtype} {tuple(d.shape)}" if isinstance(d, torch.Tensor)
               else type(d))
        raise ValueError(f"expected stage A's D, contiguous float32 "
                         f"[segments, {n2 // ct}, {n1}, {ct}, 2], got {got}")
    return int(d.shape[0])


def stage_a(re, im, n1: int, n2: int, window=None, means=None,
            emit_sums: bool = False):
    """Stage A on planes in any ingest layout: ``(dr, di, sums)``, D
    tile-blocked as [segments, n2 / ct, n1, ct], ct = ``_col_tile(n1)``
    (:func:`d_rows` gives [segments, n1, n2]; dr and di view one tensor
    of (re, im) pairs) and, with ``emit_sums``, the raw sums of each
    column tile [segments, n2 / ct, 2] (else None)."""
    d, sums = _stage_a_d(re, im, n1, n2, window, means, emit_sums)
    return d[..., 0], d[..., 1], sums


@scoped("kernel.fft_big")
def _stage_a_d(re, im, n1: int, n2: int, window=None, means=None,
               emit_sums: bool = False):
    """:func:`stage_a` with D as one float32 tensor of (re, im) pairs
    [segments, n2 / ct, n1, ct, 2], which the stage B entries take:
    ``(d, sums)``."""
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
    ct = _col_tile(n1)
    d = torch.empty((b, n2 // ct, n1, ct, 2), dtype=torch.float32,
                    device=dev)
    sums = None
    if emit_sums:
        sums = torch.empty((b, n2 // ct, 2), dtype=torch.float32,
                           device=dev)
    tw1 = _fft.pass_twiddles(n1, dev)
    hi, lo = _twiddle_tables(N, str(dev))
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fft_big_stage_a_launch(
            re.data_ptr(), im.data_ptr(), b, int(re.stride(0)), int(blocked),
            n1, n2, ct, w.data_ptr() if w is not None else None,
            m.data_ptr() if m is not None else None, tw1.data_ptr(),
            hi.data_ptr(), lo.data_ptr(), d.data_ptr(),
            sums.data_ptr() if sums is not None else None, stream)
    if rc != 0:
        raise RuntimeError(f"FFT stage A kernel launch failed: CUDA error "
                           f"{rc}")
    launches["stage_a"] += 1
    return d, sums


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
    _prep(re, im, n1, n2)
    dev = re.device
    if dev.type == "cpu":
        return psd_big_plain(re, im, n1, n2, window, means, sparse_demean)
    _fft._cuda(dev, "the big PSD")
    d, sums = _stage_a_d(re, im, n1, n2, window, means,
                         emit_sums=sparse_demean)
    return psd_stage_b(d, n1, n2, sb, sums)


@scoped("kernel.fft_big")
def psd_stage_b(d, n1: int, n2: int, sparse=None, sums=None):
    """The PSD's stage B alone on stage A's D (float32 [segments, n2/ct,
    n1, ct, 2] (re, im) pairs): ``out[N]``, natural order.  ``sparse``:
    :func:`sparse_window_bins`'s ``(ks, Wvals)`` with stage A's ``sums``,
    for the sparse demean."""
    b = _check_d(d, n1, n2)
    dev, N = d.device, n1 * n2
    if sparse is not None:
        want = (b, n2 // _col_tile(n1), 2)
        if not isinstance(sums, torch.Tensor) or sums.device != dev \
                or tuple(sums.shape) != want:
            raise ValueError(f"the sparse demean needs stage A's sums "
                             f"{want} on {dev}")
    if dev.type == "cpu":
        y = _stage_b_plain(d, n1, n2)
        if sparse is not None:
            ks, wv = sparse
            m = torch.complex(*(sums.sum(dim=1) / N).unbind(-1))
            y[:, torch.as_tensor(ks)] -= m[:, None] * torch.as_tensor(
                wv, dtype=y.dtype)
        return y.abs().square().sum(0)
    _fft._cuda(dev, "the big PSD's stage B")
    lib = _build.load()
    out = torch.empty(N, dtype=torch.float32, device=dev)
    spb = _psd_seg_per_block(b, n1, n2)
    part = torch.empty((-(-b // spb), n1, n2), dtype=torch.float32,
                       device=dev)
    tw2 = _fft.pass_twiddles(n2, dev)
    sp_k = sp_w = m = None
    nsp = 0
    if sparse is not None:
        ks, wv = sparse
        nsp = len(ks)
        sp_k = _build.device_constant(np.asarray(ks), dev, np.int32)
        sp_w = _build.device_constant(np.stack([wv.real, wv.imag], -1), dev)
        m = (sums.sum(dim=1) * (1.0 / N)).contiguous()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fft_big_stage_b_psd_launch(
            d.data_ptr(), b, n1, n2, _col_tile(n1), spb, tw2.data_ptr(),
            sp_k.data_ptr() if nsp else None,
            sp_w.data_ptr() if nsp else None, nsp,
            m.data_ptr() if nsp else None, part.data_ptr(), out.data_ptr(),
            stream)
    if rc != 0:
        raise RuntimeError(f"PSD stage B kernel launch failed: CUDA error "
                           f"{rc}")
    launches["psd_stage_b"] += PSD_STAGE_B_LAUNCHES
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
    _prep(re, im, n1, n2)
    dev = re.device
    if dev.type == "cpu":
        return fft_big_plain(re, im, n1, n2)
    _fft._cuda(dev, "the big FFT")
    d, _ = _stage_a_d(re, im, n1, n2)
    return fft_stage_b(d, n1, n2)


@scoped("kernel.fft_big")
def fft_stage_b(d, n1: int, n2: int):
    """The FFT's stage B alone on stage A's D (float32 [segments, n2/ct,
    n1, ct, 2] (re, im) pairs): ``(yr, yi)`` [segments, N], natural
    order."""
    b = _check_d(d, n1, n2)
    dev, N = d.device, n1 * n2
    if dev.type == "cpu":
        y = _stage_b_plain(d, n1, n2)
        return y.real.contiguous(), y.imag.contiguous()
    _fft._cuda(dev, "the big FFT's stage B")
    lib = _build.load()
    yr = torch.empty((b, N), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    tw2 = _fft.pass_twiddles(n2, dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fft_big_stage_b_fft_launch(
            d.data_ptr(), b, n1, n2, _col_tile(n1), _fft_rows(n2),
            tw2.data_ptr(), yr.data_ptr(), yi.data_ptr(), stream)
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


def _stage_b_plain(d, n1: int, n2: int):
    """Stage B's row FFTs of the tile-blocked D (re, im) pairs in plain
    PyTorch: complex [segments, N] in natural order X[k1 + n1 k2]."""
    y = torch.fft.fft(d_rows(torch.view_as_complex(d), n1, n2), dim=2)
    return y.transpose(1, 2).reshape(-1, n1 * n2)


def _stage_a_cpu(re, im, n1, n2, window, means, emit_sums):
    d = stage_a_plain(re, im, n1, n2, window, means)
    sums = None
    if emit_sums:
        x = _natural(re, im, n1, n2).reshape(-1, n1, n2 // _col_tile(n1),
                                             _col_tile(n1)).sum(dim=(1, 3))
        sums = torch.stack([x.real, x.imag], -1)
    return torch.view_as_real(d), sums


def stage_a_plain(re, im, n1: int, n2: int, window=None, means=None):
    """Stage A's function in plain PyTorch, D tile-blocked as [segments,
    n2 / ct, n1, ct] like the kernel's: the reference the stage is held to
    on the card."""
    x = _natural(re, im, n1, n2)
    N = n1 * n2
    if means is not None:
        m = torch.as_tensor(means, device=x.device).to(x.real.dtype)
        x = x - torch.complex(m[:, 0], m[:, 1])[:, None]
    if window is not None:
        x = x * _fft._window(window, N, x.device).to(x.real.dtype)
    d = torch.fft.fft(x.reshape(-1, n1, n2), dim=1)
    d = d * _four_step_twiddle(n1, n2, str(x.device)).to(d.dtype)
    ct = _col_tile(n1)
    return d.reshape(-1, n1, n2 // ct, ct).permute(0, 2, 1, 3).contiguous()
