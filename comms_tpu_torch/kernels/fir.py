"""The dense streaming FIR: one CUDA kernel, and its plain version.

    y[n] = sum_{k < T} taps[k] * x[n - k]        (real or complex taps)

over float32 re/im planes with a carried input context.  The kernel is
the decimating FIR's, ``csrc/decim_fir.cu``, at D = 1 (MD = T); here it
replaces the TPU kernel ``comms_tpu/kernels/fir_pallas.py::
fir_planar_pallas`` and keeps its contract: T <= :data:`MAX_TAPS`, a
context of ``[8, 128]`` planes (the 1024 samples before the block, of
which the last T-1 count; the kernel reads them as one row of 1024), N
a multiple of ``tile_rows * 128``.  :func:`fir_block` is the block
drop-in for ``ops.fir.fir_block`` (``fir_block_pallas``).

On the H100 the kernel moves 16 bytes per complex sample and does 2T
(real taps) or 4T (complex) multiply-adds: memory bounds it at the QPSK
matched filter's 32 taps.  Persistent blocks walk tiles of consecutive
outputs (``decim_fir.partition`` at D = 1, at most ``_RUN_BLOCKS``
blocks), each thread summing R consecutive outputs from a ring of
samples in registers; the same launch writes the next call's context,
so a call is one launch.  Each
output is one FMA chain over k = 0..T-1 in ascending order, so chopping
a stream reproduces the one-shot output bit for bit.  Both ``mode``
values of the TPU kernel ("split", its bf16x3 products, and "bf16")
compute in float32 on the CUDA cores here.

The wrappers launch the kernel for CUDA tensors and run
:func:`fir_plain` for CPU tensors; any other device raises.  ``launches``
counts this module's kernel launches (not the plain runs, and not in
``decim_fir.launches``).  The plain version is
:func:`comms_tpu_torch.ops.fir.fir_block` (float32 products, TF32 off).
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import decim_fir as _DF
from comms_tpu_torch.ops import fir as _fir
from comms_tpu_torch.runtime.metrics import scoped

__all__ = ["fir_planar", "fir_block", "planar_ctx_zero",
           "planar_ctx_from_tail", "fir_plain", "MAX_TAPS"]

_LANES = 128
_HALO_ROWS = 8
_CTX = _HALO_ROWS * _LANES
MAX_TAPS = _CTX + 1
# Blocks of a launch at most (32 an SM): twice the decimating FIR's.
# Short filters here are bound by their bytes, and more blocks than
# slots balance the SMs better (tools/k4_compare.py: 3% faster than 2112
# at 32 taps, level at 257 complex taps).
_RUN_BLOCKS = 4224

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


def planar_ctx_zero(device="cuda"):
    """Zero carried context planes (stream start)."""
    z = torch.zeros((_HALO_ROWS, _LANES), dtype=torch.float32,
                    device=device)
    return z, z


def planar_ctx_from_tail(xr, xi):
    """Context planes for the next block: the last 1024 samples of this
    block's planes (the block must hold at least 1024)."""
    return (xr[-_CTX:].reshape(_HALO_ROWS, _LANES),
            xi[-_CTX:].reshape(_HALO_ROWS, _LANES))


def _check_planes(xr, xi, ctx_r, ctx_i):
    for name, p in (("xr", xr), ("xi", xi), ("ctx_r", ctx_r),
                    ("ctx_i", ctx_i)):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(p)}")
        if p.dtype != torch.float32 or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous float32 "
                             f"tensor, got {p.dtype}")
        if p.device != xr.device:
            raise ValueError(f"{name} is on {p.device}, xr on {xr.device}")
    if xr.ndim != 1 or xr.shape != xi.shape:
        raise ValueError(f"xr and xi must be 1-D of one length, got "
                         f"{tuple(xr.shape)} and {tuple(xi.shape)}")
    for name, c in (("ctx_r", ctx_r), ("ctx_i", ctx_i)):
        if c.numel() != _CTX:
            raise ValueError(f"{name} must hold {_CTX} samples ([8, 128]), "
                             f"got shape {tuple(c.shape)}")


def _launch(xr, xi, taps, ctx_r, ctx_i):
    """The decimating-FIR kernel at D = 1 on CUDA planes [N] with their
    [8, 128] context, read as one row of 1024 samples; returns (yr, yi,
    next ctx_r, next ctx_i), the next context (the last 1024 samples,
    [8, 128]) written by the same launch."""
    global launches
    if xr.device.type != "cuda":
        raise ValueError(f"the FIR runs on CUDA or CPU tensors, got "
                         f"{xr.device}")
    yr, yi, nr, ni = _DF._launch(xr, xi, taps, 1, ctx_r.reshape(1, _CTX),
                                 ctx_i.reshape(1, _CTX), _RUN_BLOCKS)
    launches += 1
    return (yr, yi, nr.reshape(_HALO_ROWS, _LANES),
            ni.reshape(_HALO_ROWS, _LANES))


@scoped("kernel.fir")
def fir_planar(xr, xi, taps, ctx_r, ctx_i, tile_rows: int = 1024,
               mode: str = "split"):
    """Streaming FIR on float32 re/im planes.

    ``xr/xi``: [N] planes, N a multiple of ``tile_rows * 128``.
    ``ctx_r/ctx_i``: [8, 128] planes holding the 1024 input samples
    before this block (:func:`planar_ctx_zero` at stream start; only the
    last T-1 count).  ``taps``: host array, real or complex, T <=
    :data:`MAX_TAPS`.  ``mode``: "split" or "bf16", both float32 here.
    Returns ``(yr, yi, next_ctx_r, next_ctx_i)``, the next context the
    block's last 1024 samples as [8, 128] planes (written by the
    kernel's launch on the card).
    """
    taps = np.asarray(taps)
    T = taps.shape[0]
    if T > MAX_TAPS:
        raise ValueError(f"kernel supports taps <= {MAX_TAPS}, got {T}")
    if mode not in ("split", "bf16"):
        raise ValueError(f"mode must be 'split' or 'bf16', got {mode!r}")
    if tile_rows % 8 or tile_rows < 8:
        raise ValueError("tile_rows must be a positive multiple of 8")
    _check_planes(xr, xi, ctx_r, ctx_i)
    N = int(xr.shape[0])
    tile = tile_rows * _LANES
    if N % tile:
        raise ValueError(f"N={N} must be a multiple of "
                         f"tile_rows*128={tile} (pad upstream or pick a "
                         f"smaller tile_rows)")
    if xr.device.type != "cpu":
        return _launch(xr, xi, taps, ctx_r, ctx_i)
    yr, yi = fir_plain(xr, xi, taps, ctx_r, ctx_i)
    return (yr, yi, xr[-_CTX:].reshape(_HALO_ROWS, _LANES).clone(),
            xi[-_CTX:].reshape(_HALO_ROWS, _LANES).clone())


def _auto_tile_rows(N: int) -> int:
    """Largest tile_rows in [8, 1024] keeping pad waste under a tile."""
    rows = -(-N // _LANES)
    tr = 8
    while tr < 1024 and tr * 2 <= rows:
        tr *= 2
    return tr


def fir_block(x, taps, ctx, tile_rows: int | None = None,
              mode: str = "split"):
    """Drop-in for ``ops.fir.fir_block``: ``x`` [N] complex64, or
    float32 (its imaginary plane zero), host taps (T <= 1025), carried
    ``ctx`` [T-1] of the stream's dtype.  Returns ``(y[N], new_ctx)``,
    ``y`` complex unless the stream and the taps are real.  Pads the
    block to the tile and drops the pad; where there is none, the new
    context is the tail of the kernel's next one."""
    taps = np.asarray(taps)
    T = taps.shape[0]
    if T > MAX_TAPS:
        raise ValueError(f"kernel supports taps <= {MAX_TAPS} "
                         f"(the {_HALO_ROWS}-row halo), got {T}")
    N = int(x.shape[0])
    tr = _auto_tile_rows(N) if tile_rows is None else tile_rows
    tile = tr * _LANES
    Np = -(-N // tile) * tile
    xp = torch.nn.functional.pad(x, (0, Np - N)) if Np != N else x
    xr, xi, cr, ci = _DF._block_planes(xp, ctx, _CTX)
    yr, yi, nr, ni = fir_planar(xr, xi, taps, cr, ci, tile_rows=tr,
                                mode=mode)
    y, tail = _DF._block_result(x, taps, yr[:N], yi[:N], nr, ni, T - 1)
    if T == 1:
        return y, ctx
    if Np != N:
        tail = torch.cat([ctx.to(x.dtype), x])[-(T - 1):]
    return y, tail


def fir_plain(xr, xi, taps, ctx_r, ctx_i):
    """The kernel's function in plain PyTorch, on any device: planes
    [N] and the [8, 128] context planes (their last T-1 samples count).
    Returns ``(yr, yi)``.  The CPU path of the wrappers, and the
    reference the kernel is held to on the card."""
    taps = np.asarray(taps)
    taps = taps.astype(np.complex64 if np.iscomplexobj(taps) else np.float32)
    T = taps.shape[0]
    if T > 1:
        ctx = torch.complex(ctx_r.reshape(-1)[_CTX - (T - 1):],
                            ctx_i.reshape(-1)[_CTX - (T - 1):])
    else:
        ctx = xr.new_zeros(0, dtype=torch.complex64)
    y, _ = _fir.fir_block(torch.complex(xr, xi), taps, ctx)
    return y.real.contiguous(), y.imag.contiguous()
