"""Pulse shaping: fused zero-stuff upsample + FIR, as a polyphase product.

Counterpart of :mod:`comms_tpu.ops.pulse`.  Per input symbol the
reference emits ``sps`` samples, FIR(symbol) then FIR(0) x (sps-1), with
the FIR state carried across symbols and blocks.  The polyphase identity

    y[k*sps + p] = sum_m taps[m*sps + p] * sym[k - m]

makes that one matrix product on the symbol-rate stream,
``Y[k, p] = (W @ H)[k, p]``, with ``W`` the [K, M] symbol windows (M =
ceil(T/sps) past symbols, a ``Tensor.unfold`` view,
:func:`comms_tpu_torch.ops.fir._window_rows_strided`) and ``H`` the
[M, sps] phase-major tap matrix.  Carried state: the last M-1 symbols.
The product runs in the symbols' precision (complex64: float32, TF32
off).
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.ops.fir import _window_rows_strided

__all__ = [
    "polyphase_taps",
    "pulse_init_ctx",
    "pulse_shape_block",
    "pulse_shape_apply",
    "shape_dtype",
    "flipped_taps",
]

_NP_OF = {torch.complex64: np.complex64, torch.complex128: np.complex128,
          torch.float32: np.float32, torch.float64: np.float64}


def polyphase_taps(taps, sps: int) -> np.ndarray:
    """1-D taps[T] -> phase matrix H[M, sps], H[m, p] = taps[m*sps+p]
    (zero-padded so M = ceil(T/sps)).  Host numpy."""
    taps = np.asarray(taps)
    sps = int(sps)
    T = taps.shape[0]
    M = -(-T // sps)
    flat = np.zeros(M * sps, dtype=taps.dtype)
    flat[:T] = taps
    return flat.reshape(M, sps).copy()


def pulse_init_ctx(num_taps: int, sps: int, dtype=torch.complex64,
                   device="cuda"):
    """Zero symbol context of length M-1 (M = ceil(T/sps))."""
    M = -(-int(num_taps) // int(sps))
    return torch.zeros(max(M - 1, 0), dtype=dtype, device=device)


def shape_dtype(sym_dtype, phase_taps) -> torch.dtype:
    """Output dtype of :func:`pulse_shape_block` for symbols of
    ``sym_dtype`` and the host ``phase_taps``."""
    return torch.promote_types(
        sym_dtype, torch.from_numpy(np.zeros(0, phase_taps.dtype)).dtype)


def flipped_taps(phase_taps, device, dtype) -> torch.Tensor:
    """The [M, sps] matrix :func:`pulse_shape_block` multiplies by, on
    ``device`` in ``dtype`` (the output dtype): a caller that resolves it
    once passes it back as ``taps_dev=``."""
    return torch.from_numpy(
        np.flip(np.asarray(phase_taps), axis=0).astype(_NP_OF[dtype])
    ).to(device)


def pulse_shape_block(symbols, phase_taps, ctx, taps_dev=None):
    """Shape one block of symbols.  Returns ``(samples, new_ctx)`` with
    ``len(samples) == len(symbols) * sps``, on the symbols' device.

    ``phase_taps`` is the host [M, sps] matrix from
    :func:`polyphase_taps` (flipped here so the product reads a causal
    window); ``taps_dev``, where the caller holds it, is
    :func:`flipped_taps` of it on the symbols' device.
    """
    sym = symbols
    H = np.asarray(phase_taps)
    M, sps = H.shape
    K = sym.shape[0]
    out_dtype = shape_dtype(sym.dtype, H)
    Hd = (taps_dev if taps_dev is not None else
          _build.device_constant(np.flip(H, axis=0), sym.device,
                                 _NP_OF[out_dtype]))
    if M == 1:
        return (sym[:, None].to(out_dtype) * Hd[0][None, :]).reshape(
            K * sps), ctx
    sym_ext = torch.cat([ctx.to(sym.dtype), sym])     # [M-1 + K]
    new_ctx = sym_ext[-(M - 1):].clone()
    # W[k, j] = sym_ext[k + j] = sym[k - (M-1-j)] pairs with H[M-1-j]
    W = _window_rows_strided(sym_ext.to(out_dtype), K, 1, M)
    return (W @ Hd).reshape(K * sps), new_ctx


def pulse_shape_apply(symbols, taps, sps: int):
    """One-shot convenience: zero initial context."""
    sym = torch.as_tensor(symbols)
    H = polyphase_taps(np.asarray(taps), sps)
    ctx = pulse_init_ctx(np.asarray(taps).shape[0], sps, dtype=sym.dtype,
                         device=sym.device)
    y, _ = pulse_shape_block(sym, H, ctx)
    return y
