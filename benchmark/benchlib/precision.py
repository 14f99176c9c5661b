"""The precisions a plain reference runs in.

``float64`` is the reference.  The others are its controls, the
reference computed below the float32 that the configurations state:

* ``tf32``: float32 arithmetic with both operands of every filter and
  DFT product rounded to TF32's 10-bit mantissa (round half away from
  zero, as the tensor cores take float32 operands), sums in float32;
* ``bfloat16``: every stage's input and output stored in bfloat16, the
  arithmetic in float32 (the halved bytes a memory-bound kernel could
  be tempted by).
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import torch


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 ``x`` rounded to TF32 (10 explicit mantissa bits)."""
    bits = x.contiguous().view(torch.int32)
    return torch.bitwise_and(bits + 0x1000, -0x2000).view(torch.float32)


def round_bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _same(x):
    return x


@dataclasses.dataclass(frozen=True)
class Prec:
    name: str
    dt: torch.dtype
    store: Callable = _same      # a stage's input and output
    operand: Callable = _same    # both factors of a product


PRECISIONS = {
    "float64": Prec("float64", torch.float64),
    "tf32": Prec("tf32", torch.float32, operand=round_tf32),
    "bfloat16": Prec("bfloat16", torch.float32, store=round_bf16),
}


def get(name: str) -> Prec:
    return PRECISIONS[name]
