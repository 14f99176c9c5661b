"""An rtl-sdr recording of one FM carrier, as interleaved u8 IQ on the
device: ``[n, 2]`` bytes (re, im), the layout of the recorded file.

The carrier's instantaneous frequency (rad/sample) is ``offset + a1
sin(2 pi f1 t + p1) + a2 sin(2 pi f2 t + p2)``, the phases drawn from
the seed; the amplitude is ``amplitude`` around 127.5, with Gaussian
noise of ``noise`` per component, rounded and clipped to 0..255.  With
|frequency| <= 0.25 the phase step per sample after the first /5
decimation stays far from +-pi.  The phase is accumulated in float64 on
the device.  The ring's blocks are consecutive pieces of one recording.
"""

from __future__ import annotations

import math

import torch


def make(params: dict, blocks: int, block: int, seed: int, device) -> dict:
    """``{"iq": [blocks, block, 2]}`` uint8."""
    n = blocks * block
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    p = 2 * math.pi * torch.rand(2, generator=g, **f64)
    (a1, f1), (a2, f2) = params["tones"]
    t = torch.arange(n, **f64)
    w = (float(params["offset"])
         + a1 * torch.sin(t * (2 * math.pi * f1) + float(p[0]))
         + a2 * torch.sin(t * (2 * math.pi * f2) + float(p[1])))
    del t
    ph = torch.cumsum(w, 0)
    del w
    amp, sigma = float(params["amplitude"]), float(params["noise"])
    iq = torch.empty((n, 2), dtype=torch.uint8, device=device)
    for j, f in enumerate((torch.cos, torch.sin)):
        v = amp * f(ph) + 127.5 + sigma * torch.randn(n, generator=g, **f64)
        iq[:, j] = torch.clamp(torch.round(v), 0, 255).to(torch.uint8)
        del v
    return {"iq": iq.view(blocks, block, 2)}
