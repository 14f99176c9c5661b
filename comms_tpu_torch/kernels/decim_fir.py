"""The decimating FIR: one CUDA kernel with two entries, and its plain
version.

    y[f] = sum_t taps[t] * x[f*D - t]     (real or complex taps)

over float32 re/im planes with a carried input context.  One kernel,
``csrc/decim_fir.cu``, serves the contracts of two TPU kernels:

* :func:`fir_decimate_planar` keeps the contract of
  ``comms_tpu/kernels/decim_fir_pallas.py::fir_decimate_planar_pallas``:
  taps up to :func:`max_taps`, a context of one row ``[1, D*128]`` of
  which the last MD-1 samples count (MD = D*ceil(T/D)), N a multiple of
  ``tile_rows*D*128``.  It also takes a batch of independent rows
  (``[B, N]`` planes and a ``[B, D*128]`` context), so that the band
  monitor filters all its channels in one launch.
* :func:`poly_fir_planar` (and its complex form :func:`poly_fir`) keeps
  the contract of ``comms_tpu/kernels/poly_fir_pallas.py::
  poly_fir_pallas_planar``: D in 2..8, taps up to D*128+1, a context of
  ``8*D*128`` samples, N a multiple of :func:`step_samples`.

On the H100 the kernel reads 8 bytes per input sample and does MD/D
multiply-adds per plane and output: memory bounds short filters, the
CUDA cores long ones.  Persistent blocks walk tiles of consecutive
outputs (:func:`partition` sets the plan), each tile's window copied
ahead into shared memory with ``cp.async``, each thread summing R
consecutive outputs from a ring of sample groups in registers; the
same launch writes the next call's context.  The source's header says
more.  Both ``mode`` values of the TPU kernel's entry ("split", its
bf16x3 products, and "bf16") compute in float32 on the CUDA cores here;
no caller passes "bf16".

The wrappers launch the kernel for CUDA tensors and run
:func:`fir_decimate_plain` for CPU tensors; any other device raises.
``launches`` counts the kernel launches of both entries (not the plain
runs).  The plain version is :func:`comms_tpu_torch.ops.fir.
fir_decimate_poly`, whose products run in full float32 (TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.ops import fir as _fir
from comms_tpu_torch.runtime.metrics import scoped

__all__ = ["fir_decimate_planar", "fir_decimate_block", "decim_ctx_zero",
           "max_taps", "poly_fir_planar", "poly_fir", "step_samples",
           "CTX_ROWS", "fir_decimate_plain", "partition",
           "outputs_per_thread"]

_LANES = 128
_POLY_ROWS = 64          # the K3 entry's block quantum, in rows of D*128
CTX_ROWS = 8             # the K3 entry's context, in rows of D*128
_SMEM_LIMIT = 232448     # bytes of shared memory a block may use (H100)
# The kernel's plan (csrc/decim_fir.cu): outputs a thread by D (entry 0
# for D above 8, kROfD there), threads a block (the first that gives
# _MIN_TILES tiles, two an SM; fewer only where shared memory needs it)
# and persistent blocks at most.
_R_OF_D = (1, 9, 7, 5, 5, 7, 3, 3, 3)
_THREADS = (128, 64)
_MIN_TILES = 264
_RUN_BLOCKS = 2112

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


def max_taps(dec: int) -> int:
    """Largest tap count of :func:`fir_decimate_planar` at decimation
    ``dec``: MD - 1 must fit the one-row context of ``dec*128``
    samples, so T <= dec*128, plus one at dec = 1 (MD = T there)."""
    return _LANES + 1 if dec == 1 else dec * _LANES


def decim_ctx_zero(dec: int, device="cuda"):
    """Zero carried context planes (stream start): one row of the
    ``dec*128`` input samples before the block."""
    z = torch.zeros((1, dec * _LANES), dtype=torch.float32, device=device)
    return z, z


def step_samples(dec: int) -> int:
    """Block quantum of :func:`poly_fir_planar`."""
    return _POLY_ROWS * dec * _LANES


def outputs_per_thread(dec: int) -> int:
    """Consecutive outputs each thread of the kernel sums (R)."""
    return _R_OF_D[dec] if dec < len(_R_OF_D) else _R_OF_D[0]


def partition(n_out: int, rows: int, dec: int, max_threads: int = 128,
              run_blocks: int | None = None):
    """The kernel's partition of ``rows`` rows of ``n_out`` outputs:
    ``(threads, tiles, blocks)``.  Tiles of R * ``threads`` consecutive
    outputs of one row (a row's last tile may be partial): 128 threads,
    or 64 when a call has fewer than 264 tiles of 128 threads; at most
    ``run_blocks`` (default ``_RUN_BLOCKS``) persistent blocks, block b
    walking tiles b, b + blocks, ...  ``max_threads`` caps the threads
    where a window would not fit shared memory."""
    R = outputs_per_thread(dec)
    for threads in _THREADS + (32,):
        if threads > max_threads:
            continue
        tiles = rows * -(-int(n_out) // (R * threads))
        if tiles >= _MIN_TILES or threads == _THREADS[-1]:
            break
    return threads, tiles, max(1, min(tiles, run_blocks or _RUN_BLOCKS))


def _launch_plan(lib, MD: int, dec: int, cplx: int, n_out: int, rows: int,
                 run_blocks: int | None = None):
    """``(threads, blocks)`` of a launch: :func:`partition` (at most
    ``run_blocks`` blocks) with the threads capped (halved from 128)
    until the window fits shared memory; raises where even 32 do not."""
    cap = max(_THREADS)
    while (cap > 32 and lib.decim_fir_smem_bytes(MD, dec, cap, cplx)
           > _SMEM_LIMIT):
        cap //= 2
    if lib.decim_fir_smem_bytes(MD, dec, cap, cplx) > _SMEM_LIMIT:
        raise ValueError(f"dec {dec} with {MD} taps does not fit the "
                         f"kernel's shared-memory window")
    threads, _, blocks = partition(n_out, rows, dec, cap, run_blocks)
    return threads, blocks


def _padded_taps(taps, dec: int):
    """(real part, imaginary part or None) float32, zero-padded to
    MD = dec*ceil(T/dec)."""
    t = np.asarray(taps)
    MD = dec * (-(-t.shape[0] // dec))
    re = np.zeros(MD, np.float32)
    re[:t.shape[0]] = t.real
    if not np.iscomplexobj(t) or not np.any(t.imag):
        return re, None
    im = np.zeros(MD, np.float32)
    im[:t.shape[0]] = t.imag
    return re, im


def _check_planes(xr, xi, ctx_r, ctx_i, ctx_len: int):
    for name, p in (("xr", xr), ("xi", xi), ("ctx_r", ctx_r),
                    ("ctx_i", ctx_i)):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(p)}")
        if p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"tensor, got {p.dtype}")
        if p.device != xr.device:
            raise ValueError(f"{name} is on {p.device}, xr on {xr.device}")
    if xr.shape != xi.shape or xr.ndim not in (1, 2):
        raise ValueError(f"xr and xi must share a shape [N] or [B, N], got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    rows = 1 if xr.ndim == 1 else xr.shape[0]
    for name, c in (("ctx_r", ctx_r), ("ctx_i", ctx_i)):
        if (c.shape[-1] != ctx_len or c.numel() != rows * ctx_len
                or (xr.ndim == 2 and c.shape[0] != rows)):
            raise ValueError(f"{name} must hold {ctx_len} samples per row, "
                             f"got shape {tuple(c.shape)}")


def _launch(xr, xi, taps, dec: int, ctx_r, ctx_i,
            run_blocks: int | None = None):
    """The kernel on CUDA planes ([N] or [B, N]) with their context
    ([..., L] per row), at most ``run_blocks`` blocks; returns (yr, yi,
    next ctx_r, next ctx_i), the next context (each row's last L
    samples, shaped as the context) written by the same launch.  The
    callers count the launch: ``kernels/fir`` launches it at D = 1."""
    dev = xr.device
    if dev.type != "cuda":
        raise ValueError(f"the decimating FIR runs on CUDA or CPU tensors, "
                         f"got {dev}")
    lib = _build.load()
    hr, hi = _padded_taps(taps, dec)
    MD = hr.shape[0]
    cplx = int(hi is not None)
    n_in = xr.shape[-1]
    rows = 1 if xr.ndim == 1 else xr.shape[0]
    threads, blocks = _launch_plan(lib, MD, dec, cplx, n_in // dec, rows,
                                   run_blocks)
    out_shape = xr.shape[:-1] + (n_in // dec,)
    yr = torch.empty(out_shape, dtype=torch.float32, device=dev)
    yi = torch.empty(out_shape, dtype=torch.float32, device=dev)
    nr, ni = torch.empty_like(ctx_r), torch.empty_like(ctx_i)
    th_r = _build.device_constant(hr, dev)
    th_i = _build.device_constant(hi, dev) if cplx else None
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.decim_fir_launch(
            xr.data_ptr(), xi.data_ptr(), ctx_r.data_ptr(),
            ctx_i.data_ptr(), ctx_r.shape[-1], th_r.data_ptr(),
            th_i.data_ptr() if cplx else None, MD, dec, cplx, n_in, rows,
            threads, blocks, yr.data_ptr(), yi.data_ptr(), nr.data_ptr(),
            ni.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"decimating FIR kernel launch failed: CUDA "
                           f"error {rc}")
    return yr, yi, nr, ni


def _run(xr, xi, taps, dec: int, ctx_r, ctx_i):
    """(yr, yi, next ctx_r, next ctx_i): the kernel for CUDA tensors, the
    plain version and copies of each row's last L samples for CPU ones."""
    global launches
    if xr.device.type == "cpu":
        L = ctx_r.shape[-1]
        return (*_plain(xr, xi, taps, dec, ctx_r, ctx_i),
                xr[..., -L:].reshape(ctx_r.shape).clone(),
                xi[..., -L:].reshape(ctx_i.shape).clone())
    out = _launch(xr, xi, taps, dec, ctx_r, ctx_i)
    launches += 1
    return out


@scoped("kernel.decim_fir")
def fir_decimate_planar(xr, xi, taps, dec: int, ctx_r, ctx_i,
                        tile_rows: int = 128, mode: str = "split"):
    """Decimating FIR on float32 re/im planes.

    ``xr/xi``: [N] (or [B, N], B independent rows) planes, N a multiple
    of ``tile_rows * dec * 128``.  ``ctx_r/ctx_i``: [1, dec*128] (or
    [B, dec*128]) planes with the input samples before this block
    (:func:`decim_ctx_zero` at stream start; only the last MD-1 count).
    ``taps``: host array, real or complex, T <= :func:`max_taps`.
    ``mode``: "split" or "bf16", both float32 here (see the module
    docstring).  Returns ``(yr, yi, next_ctx_r, next_ctx_i)`` with
    ``yr/yi`` [N // dec] (or [B, N // dec]) and the next context a copy
    of each row's last dec*128 samples (written by the kernel's launch
    on the card).
    """
    taps = np.asarray(taps)
    D = int(dec)
    T = taps.shape[0]
    if D < 1:
        raise ValueError("dec must be >= 1")
    if T > max_taps(D):
        raise ValueError(f"kernel supports taps <= {max_taps(D)} at "
                         f"dec={D}, got {T}")
    if mode not in ("split", "bf16"):
        raise ValueError(f"mode must be 'split' or 'bf16', got {mode!r}")
    if tile_rows < 8 or tile_rows % 8:
        raise ValueError("tile_rows must be a multiple of 8 (DMA halo "
                         "alignment)")
    W = D * _LANES
    _check_planes(xr, xi, ctx_r, ctx_i, W)
    N = int(xr.shape[-1])
    tile = tile_rows * W
    if N % tile:
        raise ValueError(f"N={N} must be a multiple of tile_rows*dec*128"
                         f"={tile} (pad upstream or pick a smaller "
                         f"tile_rows)")
    yr, yi, nr, ni = _run(xr, xi, taps, D, ctx_r, ctx_i)
    ctx_shape = (1, W) if xr.ndim == 1 else (xr.shape[0], W)
    return yr, yi, nr.reshape(ctx_shape), ni.reshape(ctx_shape)


def _block_planes(x, ctx, width: int):
    """Float32 planes of a block ``x`` [N] (complex64, or float32 beside
    a zero imaginary plane) and flat context planes of ``width``
    samples: the carried ``ctx`` at their end, zeros in front."""
    L = ctx.shape[0]
    if L > width:
        raise ValueError(f"a context of {L} samples does not fit the "
                         f"kernel's {width}")
    ctx = ctx.to(x.dtype)
    if x.is_complex():
        planes = (x.real, x.imag, ctx.real, ctx.imag)
    else:
        planes = (x, torch.zeros_like(x), ctx, torch.zeros_like(ctx))
    xr, xi, cr, ci = (p.contiguous() for p in planes)
    pad = torch.nn.functional.pad
    return xr, xi, pad(cr, (width - L, 0)), pad(ci, (width - L, 0))


def _block_result(x, taps, yr, yi, nr, ni, L: int):
    """``(y, tail)`` from a kernel's planes: ``y`` complex unless the
    stream and the taps are real, ``tail`` the last ``L`` samples of the
    next context in the stream's dtype."""
    y = (torch.complex(yr, yi)
         if x.is_complex() or np.iscomplexobj(taps) else yr)
    nr, ni = nr.reshape(-1), ni.reshape(-1)
    W = nr.shape[0]
    if x.is_complex():
        return y, torch.complex(nr[W - L:], ni[W - L:])
    return y, nr[W - L:].clone()


def fir_decimate_block(x, taps, dec: int, ctx, tile_rows: int = 8):
    """:func:`fir_decimate_planar` on a block: ``x`` [N] complex64 or
    float32 (N a multiple of ``tile_rows*dec*128``), host ``taps``
    (T <= :func:`max_taps`), ``ctx`` the carried MD-1 input samples
    (``ops.fir.fir_decimate_poly``'s state).  Returns ``(y[N // dec],
    new_ctx)``, ``y`` complex unless the stream and the taps are real,
    ``new_ctx`` the block's last MD-1 samples."""
    W = int(dec) * _LANES
    xr, xi, cr, ci = _block_planes(x, ctx, W)
    yr, yi, nr, ni = fir_decimate_planar(xr, xi, taps, dec, cr, ci,
                                         tile_rows=tile_rows)
    return _block_result(x, taps, yr, yi, nr, ni, ctx.shape[0])


@scoped("kernel.decim_fir")
def poly_fir_planar(re, im, taps, ctx_re, ctx_im, dec: int):
    """Decimating FIR with the TPU poly-FIR kernel's contract.

    Args:
      re, im: [N] float32 planes, N % step_samples(dec) == 0.
      taps: 1-D taps (real or complex, T <= dec*128 + 1), host numpy.
      ctx_re, ctx_im: [dec*128*CTX_ROWS] float32 carried input-tail
        planes (zeros at stream start; only the trailing samples the
        taps reach count).
      dec: decimation factor in [2, 8].

    Returns ``(yr[N//dec], yi[N//dec], new_ctx_re, new_ctx_im)``.
    """
    taps = np.asarray(taps)
    T = taps.shape[0]
    D = int(dec)
    if not 2 <= D <= 8:
        raise ValueError(f"dec must be in [2, 8], got {D}")
    roww = D * _LANES
    if T > roww + 1:
        raise ValueError(
            f"taps {T} > dec*128 + 1 = {roww + 1} unsupported (the "
            "window would reach beyond one previous slab row)")
    L = CTX_ROWS * roww
    for name, p in (("re", re), ("im", im)):
        if not isinstance(p, torch.Tensor) or p.ndim != 1:
            raise ValueError(f"{name} must be a 1-D tensor")
    N = re.shape[0]
    step = step_samples(D)
    if N % step:
        raise ValueError(f"N {N} must be a multiple of {step}")
    if ctx_re.shape[0] != L:
        raise ValueError(f"ctx must be {L} samples, got {ctx_re.shape[0]}")
    _check_planes(re, im, ctx_re, ctx_im, L)
    return _run(re, im, taps, D, ctx_re, ctx_im)


def poly_fir(x, taps, ctx, dec: int):
    """Complex form of :func:`poly_fir_planar`: ``x`` [N] and ``ctx``
    [dec*128*CTX_ROWS] complex64.  Returns ``(y[N//dec], new_ctx)``."""
    yr, yi, ncr, nci = poly_fir_planar(
        x.real.contiguous(), x.imag.contiguous(), taps,
        ctx.real.contiguous(), ctx.imag.contiguous(), dec)
    return torch.complex(yr, yi), torch.complex(ncr, nci)


def fir_decimate_plain(xr, xi, taps, dec: int, ctx_r, ctx_i):
    """The kernel's function in plain PyTorch, on any device: planes
    [N] or [B, N], context [..., L] with L >= MD-1 (its last MD-1
    samples count).  Returns ``(yr, yi)``.  The CPU path of both
    entries, and the reference the kernel is held to on the card."""
    return _plain(xr, xi, taps, int(dec), ctx_r, ctx_i)


def _plain(xr, xi, taps, dec, ctx_r, ctx_i):
    hr, hi = _padded_taps(taps, dec)
    h = hr if hi is None else (hr + 1j * hi).astype(np.complex64)
    Hb = _fir.decimating_branch_taps(h, dec)
    L = ctx_r.shape[-1]
    rows = xr.shape[:-1]
    cr = ctx_r.reshape(*rows, L)[..., L - (Hb.size - 1):]
    ci = ctx_i.reshape(*rows, L)[..., L - (Hb.size - 1):]
    y, _ = _fir.fir_decimate_poly(torch.complex(xr, xi), Hb,
                                  torch.complex(cr, ci))
    return y.real.contiguous(), y.imag.contiguous()
