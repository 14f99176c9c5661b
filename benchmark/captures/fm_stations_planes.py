"""A wideband capture with one FM station at the centre of each of K
channels, as float32 re/im planes on the device.

Station c sits at c/K of the wideband rate, carries a tone drawn from
the seed in [tone_lo, tone_hi] cycles per channel frame with a random
phase, at a peak deviation of ``deviation`` of the channel spacing and
an amplitude of 1/K; complex Gaussian noise of ``noise`` per component
is added.  A station's phase moves by at most ``2 pi deviation`` a
channel frame, within +-pi for a deviation under 1/2.
The samples are computed in float64 on the device and stored as
float32.  The ring's blocks are consecutive pieces of one capture.
"""

from __future__ import annotations

import math

import torch


def make(params: dict, blocks: int, block: int, seed: int, device) -> dict:
    """``{"re": [blocks, block], "im": [blocks, block]}`` float32."""
    k = int(params["channels"])
    n = blocks * block
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    f64 = dict(dtype=torch.float64, device=device)
    lo, hi = float(params["tone_lo"]), float(params["tone_hi"])
    tones = lo + (hi - lo) * torch.rand(k, generator=g, **f64)
    phases = 2 * math.pi * torch.rand(2, k, generator=g, **f64)
    t = torch.arange(n, **f64)
    re = torch.zeros(n, **f64)
    im = torch.zeros(n, **f64)
    dev = 2 * math.pi * float(params["deviation"]) / k
    for c in range(k):
        # the carrier's phase from (c t mod k), exact in float64
        ph = torch.remainder(c * t, k) * (2 * math.pi / k)
        ph += dev * torch.cumsum(
            torch.sin(t * (2 * math.pi * float(tones[c]) / k)
                      + float(phases[0, c])), 0)
        ph += float(phases[1, c])
        re += torch.cos(ph)
        im += torch.sin(ph)
        del ph
    sigma = float(params["noise"])
    noise = torch.randn(2, n, generator=g, **f64)
    re = (re / k + sigma * noise[0]).float()
    im = (im / k + sigma * noise[1]).float()
    return {"re": re.view(blocks, block), "im": im.view(blocks, block)}
