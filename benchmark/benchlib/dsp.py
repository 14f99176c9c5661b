"""Plain building blocks the references share, written from their
definitions (plain PyTorch), in a precision of :mod:`benchlib.precision`."""

from __future__ import annotations

import torch


def decimate(x, taps, dec: int, p):
    """``y[j] = sum_t taps[t] x[j dec - t]`` along the last axis, zero
    samples before the start; the length a multiple of ``dec``."""
    T = taps.shape[0]
    n = x.shape[-1]
    h = p.operand(torch.tensor(taps, dtype=p.dt, device=x.device))
    xe = torch.cat([x.new_zeros(x.shape[:-1] + (T,)), p.operand(x)], -1)
    y = h[0] * xe[..., T:T + n:dec]
    for t in range(1, T):
        y = y + h[t] * xe[..., T - t:T - t + n:dec]
    return y


def demod(a, b):
    """Quadrature FM demod of planes ``a + i b`` along the last axis:
    atan2 of y[m] conj(y[m-1]), with y[-1] = 0."""
    pa = torch.cat([torch.zeros_like(a[..., :1]), a[..., :-1]], -1)
    pb = torch.cat([torch.zeros_like(b[..., :1]), b[..., :-1]], -1)
    return torch.atan2(b * pa - a * pb, a * pa + b * pb)
