"""Plain reference of ``fm_radio_rtlsdr``: the u8 convert, a decimating
low-pass, the quadrature FM demod and a second decimating low-pass,
written from comms-rs ``examples/fm_radio.rs`` alone (plain PyTorch; the
taps are the example's constants, from this configuration's file).

    x[n] = (u8 - 127.5) / 127.5                  (re and im)
    y[m] = sum_t h[t] x[5m - t]                  (63 taps, complex x)
    d[m] = atan2(Im, Re)(y[m] conj(y[m-1]))
    a[j] = sum_t h[t] d[5j - t]

with zero samples before the stream's start.  ``block_output`` gives
the audio ``[N/25]`` of ring block ``g``: it runs the chain from zero
state over the last ``check.tail_samples`` samples of the block before
and the block itself, which carries every state the block needs.
"""

from __future__ import annotations

import numpy as np
import torch

from benchlib import precision
from benchlib.dsp import decimate, demod


def block_output(ring: dict, g: int, cfg: dict, prec: str) -> torch.Tensor:
    """Audio ``[N/25]`` of ring block ``g`` in precision ``prec``."""
    p = precision.get(prec)
    iq = ring["iq"]
    R, N = iq.shape[:2]
    tail = cfg["check"]["tail_samples"]
    d1, d2 = cfg["dec1"], cfg["dec2"]
    f = p.store((iq[g % R].to(p.dt) - 127.5) / 127.5)
    if g == 0:
        head = f.new_zeros((tail, 2))
    else:
        head = p.store((iq[(g - 1) % R, N - tail:].to(p.dt) - 127.5) / 127.5)
    f = torch.cat([head, f])
    taps = np.asarray(cfg["lpf_taps"], np.float64)
    yr = p.store(decimate(f[:, 0], taps, d1, p))
    yi = p.store(decimate(f[:, 1], taps, d1, p))
    d = p.store(demod(yr, yi))
    audio = p.store(decimate(d, taps, d2, p))
    return audio[tail // (d1 * d2):]
