"""The 3xTF32 split of ``csrc/tf32x3.cuh`` in torch, for the CPU tests.

The kernels on the tensor cores (K5's panels) split each float32 operand
into TF32 halves, x = hi + lo, and form a product as three TF32 products,
hi*hi + hi*lo + lo*hi (the port's counterpart of the JAX package's
bf16x3 helper, ``comms_tpu/kernels/_bf16.py``).  This module mirrors the
rounding bit for bit on CPU tensors, so that a test can replay a kernel's
arithmetic without a card.  Nothing on the port's main path imports it.
"""

from __future__ import annotations

import torch

__all__ = ["tf32_round", "split", "dot3"]

_EXP = 0x7F800000
_HALF = 0x1000                  # half a TF32 unit in the last place
_KEEP = -0x2000                 # ~0x1FFF as int32: the 19 bits TF32 keeps


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits), to
    nearest with ties away from zero, as ``cvt.rna.tf32.f32`` rounds: half
    a unit added to the magnitude's bits, the low 13 bits cleared.  inf
    and NaN pass through; a value within half a unit of the largest
    float32 rounds to inf."""
    if x.dtype != torch.float32:
        raise ValueError(f"tf32_round takes float32, got {x.dtype}")
    bits = x.contiguous().view(torch.int32)
    special = (bits & _EXP) == _EXP
    return torch.where(special, bits, (bits + _HALF) & _KEEP).view(
        torch.float32)


def split(x: torch.Tensor):
    """``(hi, lo)``: hi = tf32(x), lo = tf32(x - hi); hi + lo holds x to
    about 2^-22 relative.  As in the kernel, lo is rounded by the integer
    ops alone (the residual of a finite x is finite)."""
    hi = tf32_round(x)
    r = (x - hi).contiguous().view(torch.int32)
    return hi, ((r + _HALF) & _KEEP).view(torch.float32)


def dot3(ah, al, bh, bl) -> torch.Tensor:
    """``a @ b`` from split operands, in the kernel's order: the cross
    terms lo*hi and hi*lo, then hi*hi (float32 products of TF32 values
    are exact, so only the sums round)."""
    return (al @ bh + ah @ bl) + ah @ bh
