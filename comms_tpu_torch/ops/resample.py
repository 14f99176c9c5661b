"""Decimation, zero-stuffing upsampling and rational P/Q resampling.

Counterpart of :mod:`comms_tpu.ops.resample` (the reference's
``src/util/resample_node.rs``):

* :func:`decimate_block` keeps every ``rate``-th sample from index 0,
  the index resetting each block (``DecimateNode``, rate 0/1 pass
  through); :func:`decimate_stream` carries the phase across blocks;
* :func:`upsample_block` follows each sample by ``rate - 1`` zeros
  (``UpsampleNode``);
* :func:`rational_taps` / :func:`rational_resample_block`: the polyphase
  rational resampler, zero-stuff by P, FIR, keep every Q, as P
  decimating FIRs on shifted inputs (:func:`comms_tpu_torch.ops.fir.
  fir_decimate_poly`).  ``rational_taps`` is host numpy and builds the
  JAX package's matrices.

The streaming decimator's offset is a 0-d int32 tensor on the stream's
device, as in the JAX package, so that states and checkpoints carry
across; the kept column is a gather, so the host reads nothing.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from comms_tpu_torch.ops import fir as _fir

__all__ = [
    "decimate_block",
    "decimate_stream",
    "decimate_stream_init",
    "upsample_block",
    "rational_taps",
    "rational_resample_init",
    "rational_resample_block",
]


def decimate_block(x, rate: int):
    """Per-block decimation, phase reset at block start (reference
    semantics).  Output length = ceil(len(x)/rate)."""
    rate = int(rate)
    if rate in (0, 1):
        return x
    return x[::rate]


def decimate_stream_init(device="cuda"):
    """Initial carried offset (0 = first sample kept)."""
    return torch.zeros((), dtype=torch.int32, device=device)


def decimate_stream(x, offset, rate: int):
    """Streaming decimation with carried phase: keeps ``x[offset::rate]``.
    The block length must be a multiple of ``rate``, so exactly
    ``N // rate`` samples come out for any offset in [0, rate).  Returns
    ``(y, new_offset)``; the offset stays on its device (a gather)."""
    rate = int(rate)
    if rate in (0, 1):
        return x, offset
    n = x.shape[0]
    if n % rate:
        raise ValueError(
            f"streaming decimation needs len(x) % rate == 0, got {n} % {rate}")
    frames = x.reshape(n // rate, rate)
    off = offset.to(device=x.device, dtype=torch.int64).reshape(1, 1)
    y = torch.gather(frames, 1, off.expand(n // rate, 1)).reshape(-1)
    new_offset = torch.remainder(offset.to(torch.int64) - n, rate)
    return y, new_offset.to(torch.int32)


def upsample_block(x, rate: int):
    """Zero-stuff by ``rate`` (resample_node.rs:120-131)."""
    rate = int(rate)
    if rate in (0, 1):
        return x
    out = x.new_zeros((x.shape[0], rate))
    out[:, 0] = x
    return out.reshape(-1)


def rational_taps(h, up: int, down: int):
    """Prototype lowpass h -> per-class coefficient matrices.

    Returns ``(C[P][M, Q], offsets[P], P)`` host-side (gcd-normalised P/Q),
    where class r of the output (m = r + k*P) is a decimate-by-Q FIR of
    the input at class offset ``offsets[r]`` with branch matrix C[r]:
    y[m] = sum_j h[m*Q mod P + j*P] * x[floor(m*Q/P) - j]."""
    h = np.asarray(h)
    g = math.gcd(int(up), int(down))
    P, Q = int(up) // g, int(down) // g
    mats, offsets = [], []
    for r in range(P):
        phase = (r * Q) % P
        offsets.append((r * Q - phase) // P)
        mats.append(_fir.decimating_branch_taps(h[phase::P], Q))
    return mats, offsets, P


def rational_resample_init(mats, dtype=torch.complex64, device="cuda"):
    """Carried input tail long enough for every class (max halo)."""
    halo = max(m.size - 1 for m in mats)
    return torch.zeros((halo,), dtype=dtype, device=device)


def rational_resample_block(x, mats, offsets, P: int, ctx):
    """Resample one block by P/Q (from :func:`rational_taps`).

    ``len(x) % Q == 0``; output length = len(x) * P / Q.  Returns
    ``(y, new_ctx)``; streaming-correct for any block chopping."""
    Q = mats[0].shape[1]
    N = x.shape[0]
    if N % Q:
        raise ValueError(f"block {N} not a multiple of down-rate {Q}")
    halo = ctx.shape[0]
    xe = torch.cat([ctx.to(x.dtype), x])
    new_ctx = xe[xe.shape[0] - halo:]
    # classes with positive start offsets slice up to Q-1 past the block
    # end; the pad's values never reach a valid output
    xe = torch.cat([xe, x.new_zeros(Q)])
    K = N // Q
    outs = []
    for r in range(P):
        hr = mats[r].size - 1
        start = halo + offsets[r]
        seg = xe[start - hr:start + N]
        yr, _ = _fir.fir_decimate_poly(seg[hr:], mats[r], seg[:hr])
        outs.append(yr)
    return torch.stack(outs, dim=1).reshape(K * P), new_ctx
