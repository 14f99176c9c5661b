"""Plain reference of ``band_monitor_k64``: a polyphase DFT filterbank,
an atan2 FM demod of every channel and a decimating audio FIR, written
from the definitions alone (plain PyTorch and NumPy; nothing of the
program).

    channel k, frame m:  y[m, k] = sum_t h[t] x[mK - t] e^{2 pi i k t / K}
                         (the input mixed down by channel k's centre,
                         low-passed by the prototype h, kept every K)
    demod:               d[m] = atan2(Im, Re)(y[m] conj(y[m-1]))
    audio:               a[j] = sum_t g[t] d[j D - t]

with zero samples before the stream's start; ``h`` is designed here
from its definition, ``g`` is the configuration's ``audio_taps``.
``block_output`` gives the audio ``[K, N/K/D]`` of ring block ``g``: it
runs the chain from zero state over the last ``check.tail_samples``
samples of the block before and the block itself, which carries every
state the block needs (the prototype's T-1 samples, one frame, the
audio filter's taps).
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchlib import precision
from benchlib.dsp import decimate, demod


def hamming_sinc(rate: int, taps_per_branch: int) -> np.ndarray:
    """Hamming-windowed sinc low-pass, cutoff 1/(2 rate), unit DC gain,
    rate * taps_per_branch taps (float64)."""
    T = rate * taps_per_branch
    n = np.arange(T, dtype=np.float64) - (T - 1) / 2.0
    h = np.sinc(n / rate) * np.hamming(T)
    return h / h.sum()


def _chain_input(ring: dict, g: int, tail: int):
    R, N = ring["re"].shape
    cur = g % R
    if g == 0:
        z = ring["re"].new_zeros(tail)
        return torch.cat([z, ring["re"][cur]]), torch.cat([z, ring["im"][cur]])
    prev = (g - 1) % R
    return (torch.cat([ring["re"][prev, N - tail:], ring["re"][cur]]),
            torch.cat([ring["im"][prev, N - tail:], ring["im"][cur]]))


def channelize(xr, xi, K: int, M: int, p):
    """``(yr, yi)`` [frames, K] from planes of a whole number of frames."""
    dev, dt = xr.device, p.dt
    T = K * M
    F = xr.shape[0] // K
    H = p.operand(torch.tensor(hamming_sinc(K, M), dtype=dt,
                               device=dev)).view(M, K)

    def branches(x):
        # v[m, r] = sum_q H[q, r] x[(m - q) K - r], from rows
        # Z[j, r] = x[(j - M + 1) K - r] (frame j's samples, newest first)
        xe = torch.cat([x.new_zeros(T), p.operand(x)])
        Z = xe[1:1 + (F + M - 1) * K].view(F + M - 1, K).flip(1)
        v = H[0] * Z[M - 1:M - 1 + F]
        for q in range(1, M):
            v = v + H[q] * Z[M - 1 - q:M - 1 - q + F]
        return p.operand(v)

    vr, vi = branches(xr), branches(xi)
    kr = torch.remainder(torch.outer(torch.arange(K), torch.arange(K)), K)
    ang = (kr.to(torch.float64) * (2 * math.pi / K)).to(dev)
    C = p.operand(torch.cos(ang).to(dt))
    S = p.operand(torch.sin(ang).to(dt))
    return vr @ C - vi @ S, vr @ S + vi @ C


def block_output(ring: dict, g: int, cfg: dict, prec: str) -> torch.Tensor:
    """Audio ``[K, N/K/D]`` of ring block ``g`` in precision ``prec``."""
    p = precision.get(prec)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    K, M = cfg["num_channels"], cfg["taps_per_branch"]
    D = cfg["audio_dec"]
    tail = cfg["check"]["tail_samples"]
    xr, xi = _chain_input(ring, g, tail)
    xr, xi = p.store(xr.to(p.dt)), p.store(xi.to(p.dt))
    yr, yi = channelize(xr, xi, K, M, p)
    yr, yi = p.store(yr.T), p.store(yi.T)            # [K, frames]
    d = p.store(demod(yr, yi))
    audio = decimate(d, np.asarray(cfg["audio_taps"], np.float64), D, p)
    return p.store(audio)[:, tail // K // D:]
