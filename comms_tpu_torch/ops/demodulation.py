"""FM quadrature demodulation.

Counterpart of the FM part of :mod:`comms_tpu.ops.demodulation`:
``y[n] = arg(x[n] * conj(x[n-1]))`` with ``prev`` carried across blocks
(zero-initialized; arg(0) = 0), and the polynomial atan2 that the fused
FM kernel shares.

The complex product is written out on the re/im planes in the order
XLA evaluates a complex multiply, ``(ar*br - ai*bi, ar*bi + ai*br)``.
That order fixes the signs of zero products: at stream start
``prev = 0`` and atan2 of signed zeros is 0 or +-pi depending on them
(a first sample of -1-1j demodulates to pi), so a different order
would move the first audio samples.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["fast_atan2", "fast_angle", "fm_demod_init", "fm_demod_block"]


def fast_atan2(y, x):
    """Octant-reduced degree-15 odd-polynomial atan2 in float32, 8.8e-8
    rad max error; the same coefficients, Horner order, ``den + 1e-30``
    and sign-bit branches as the JAX package's ``fast_atan2`` and the
    fused FM kernel.  IEEE signed-zero faithful on the x<0 branch cuts
    (atan2(+-0, -0) = +-pi): ``signbit`` is exact for -0.0 and +-inf."""
    y = torch.as_tensor(y, dtype=torch.float32)
    x = torch.as_tensor(x, dtype=torch.float32)
    ax = x.abs()
    ay = y.abs()
    swap = ay > ax
    num = torch.minimum(ax, ay)
    den = torch.maximum(ax, ay)
    r = num / (den + 1e-30)
    r2 = r * r
    p = r2 * -4.831168387e-03 + 2.475678069e-02
    p = p * r2 + -6.021912799e-02
    p = p * r2 + 9.967923619e-02
    p = p * r2 + -1.404013889e-01
    p = p * r2 + 1.997368136e-01
    p = p * r2 + -3.333230283e-01
    p = p * r2 + 9.999999582e-01
    a = p * r
    a = torch.where(swap, np.pi / 2 - a, a)
    a = torch.where(torch.signbit(x), np.pi - a, a)
    return torch.where(torch.signbit(y), -a, a)


def fast_angle(z):
    """:func:`fast_atan2` of a complex tensor's (im, re)."""
    return fast_atan2(z.imag, z.real)


def fm_demod_init(dtype=torch.complex64, device="cpu"):
    """Carried ``prev`` sample, zero-initialized (analog.rs:44-47)."""
    return torch.zeros((), dtype=dtype, device=device)


def _mul_conj(ar, ai, br, bi):
    """Planes of (ar + j ai) * conj(br + j bi), in XLA's operation order
    (see module docstring)."""
    ci = -bi
    return ar * br - ai * ci, ar * ci + ai * br


def fm_demod_block(x, prev, fast: bool = False):
    """Quadrature FM demod of one block.  Returns ``(y, new_prev)``;
    y is real with the dtype of ``x.real``.

    ``fast``: use :func:`fast_atan2` (float32) instead of the exact
    ``torch.atan2``."""
    shifted = torch.cat([prev.reshape(1).to(x.dtype), x[:-1]])
    zre, zim = _mul_conj(x.real, x.imag, shifted.real, shifted.imag)
    y = fast_atan2(zim, zre) if fast else torch.atan2(zim, zre)
    return y.to(x.real.dtype), x[-1]
