"""A host copy of the lag-1 demod kernel's plan (comms_tpu_torch/csrc/
lag1_demod.cu), in numpy float32, for the tests: its tiles, the halo,
the 16-byte loads and the scalar loads a ragged or unaligned tile takes,
the products, the shared transpose, the masked stores and the next prev.
The atan2 is the plain version's polynomial (the kernel's differs by its
FMA contraction alone), so the replay equals the plain version bit for bit
where the plan is right.  It imports no jax; the constants are read from
the source."""

import re
from pathlib import Path

import numpy as np
import torch

from comms_tpu_torch.kernels import lag1_demod as LD
from comms_tpu_torch.ops import demodulation as demod

SRC = (Path(LD.__file__).resolve().parents[1] / "csrc"
       / "lag1_demod.cu").read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])


THREADS = _const("kThreads")
TILE = _const("kTile")
MAX_K = _const("kMaxK")
PER = TILE // THREADS
SMEM_BYTES = 4 * (2 * TILE + 2 * MAX_K)   # body and halo, both planes


def replay(yr, yi, prev, aligned=True):
    """``(d [K, F], next prev [K, 2], writes [K, F])`` of the kernel's
    plan over numpy float32 planes ``yr, yi`` [F, K] and ``prev`` [K, 2];
    ``writes`` counts the stores of each output."""
    F, K = yr.shape
    log2k = K.bit_length() - 1
    TF = TILE >> log2k
    fr, fi = yr.reshape(-1), yi.reshape(-1)
    d = np.full((K, F), np.nan, np.float32)
    writes = np.zeros((K, F), np.int64)
    nprev = np.full((K, 2), np.nan, np.float32)
    t = np.arange(THREADS)
    for blk in range(-(-F // TF)):
        j0 = blk * TF
        nf = min(TF, F - j0)
        n = nf * K
        base = j0 * K
        body = np.full(2 * TILE, np.nan, np.float32)
        halo = np.full(2 * MAX_K, np.nan, np.float32)
        src = prev.T if j0 == 0 else np.stack(
            [fr[base - K:base], fi[base - K:base]])
        halo[:K], halo[MAX_K:MAX_K + K] = src[0], src[1]
        for q in range(TILE // 4 // THREADS):
            for v in 4 * (t + q * THREADS):
                hi = v + 4 if aligned and v + 4 <= n else min(v + 4, n)
                body[v:hi] = fr[base + v:base + hi]
                body[TILE + v:TILE + hi] = fi[base + v:base + hi]
        e = (t[None, :] + THREADS * np.arange(PER)[:, None]).reshape(-1)
        e = e[e < n]
        k = e & (K - 1)
        a, c = body[e], body[TILE + e]
        first = e < K
        b = np.where(first, halo[k], body[np.maximum(e - K, 0)])
        dd = np.where(first, halo[MAX_K + k],
                      body[TILE + np.maximum(e - K, 0)])
        im = c * b - a * dd
        re_ = a * b + c * dd
        out = demod.fast_atan2(torch.from_numpy(im),
                               torch.from_numpy(re_)).numpy()
        if j0 + nf == F:
            tail = e >= n - K
            nprev[k[tail], 0], nprev[k[tail], 1] = a[tail], c[tail]
        ds = np.full(2 * TILE, np.nan, np.float32)
        ds[k * (TF + 1) + (e >> log2k)] = out
        o = np.arange(TILE)
        ko, jo = o // TF, o % TF
        keep = jo < nf
        d[ko[keep], j0 + jo[keep]] = ds[ko[keep] * (TF + 1) + jo[keep]]
        np.add.at(writes, (ko[keep], j0 + jo[keep]), 1)
    return d, nprev, writes


def transpose_banks(K):
    """Worst bank conflict of the transpose's shared writes (each warp
    writing its 32 consecutive samples) and of the stores' shared reads
    (32 consecutive outputs), over one full tile: ways, 1 is none."""
    log2k = K.bit_length() - 1
    TF = TILE >> log2k
    e = np.arange(TILE).reshape(-1, 32)
    w = ((e & (K - 1)) * (TF + 1) + (e >> log2k)) % 32
    o = np.arange(TILE).reshape(-1, 32)
    r = ((o // TF) * (TF + 1) + o % TF) % 32
    ways = [max(np.bincount(row, minlength=32)) for row in np.vstack([w, r])]
    return max(ways)
