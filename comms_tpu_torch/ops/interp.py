"""Fractional-delay interpolation (cubic Lagrange).

Counterpart of :mod:`comms_tpu.ops.interp`: four taps computed on the
host from the fractional shift mu, applied as an FIR with zero initial
state.  ``delay_signal(x, d)`` applies a total delay d = integer +
fraction; ``chip_smoke.py`` takes its interpolator weights for the
QPSK symbol kernel's checks from :func:`lagrange_taps`.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.ops import fir as _fir

__all__ = ["lagrange_taps", "fractional_delay", "delay_signal"]


def lagrange_taps(mu: float) -> np.ndarray:
    """4-tap cubic Lagrange fractional-delay filter (float64, host).

    Output y[n] = x interpolated at n - 1 - mu for mu in [0, 1): the
    filter's group delay is 1 + mu samples (the basepoint delay of a
    causal cubic)."""
    mu = float(mu)
    if not 0.0 <= mu < 1.0:
        raise ValueError(f"mu must be in [0, 1), got {mu}")
    t = 1.0 + mu
    taps = np.empty(4, dtype=np.float64)
    pts = [0.0, 1.0, 2.0, 3.0]
    for k in range(4):
        num = 1.0
        den = 1.0
        for j in range(4):
            if j != k:
                num *= t - pts[j]
                den *= pts[k] - pts[j]
        taps[k] = num / den
    return taps


def fractional_delay(x, mu: float):
    """Delay ``x`` by 1 + mu samples (cubic Lagrange), zero state; the
    output has the input's length (tail truncated)."""
    taps = lagrange_taps(mu)
    tp = taps.astype(np.complex64 if x.is_complex() else np.float32)
    y, _ = _fir.fir_block(x, tp, _fir.init_ctx(4, x.dtype, x.device))
    return y


def delay_signal(x, delay: float):
    """Apply a delay >= 0: the integer part by shifting in zeros, the
    fraction by cubic interpolation (which itself adds one sample,
    accounted for here).  Zero state, same length."""
    delay = float(delay)
    if delay < 0:
        raise ValueError("delay must be >= 0 (advance by slicing instead)")
    d_int = int(np.floor(delay))
    mu = delay - d_int
    if mu == 0.0:
        if d_int == 0:
            return x
        return torch.cat([x.new_zeros(d_int), x[:-d_int]])
    y = fractional_delay(x, mu)
    rem = d_int - 1
    if rem > 0:
        y = torch.cat([y.new_zeros(rem), y[:-rem]])
    elif rem < 0:  # delay < 1: advance by one sample
        y = torch.cat([y[1:], y.new_zeros(1)])
    return y
