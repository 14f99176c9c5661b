"""Bytes and operations of a kernel launch, from its shape alone.

Each function counts what the function computed needs: every input byte
read once, every output byte written once (the carried context
included), and the arithmetic of the plain formula, whatever the kernel
reads again or pads.  A launch is described by a dict, as the served
paths (``paths/*.py``) list them; ``cost(kind, shape)`` dispatches on
the kernel's key.
"""

from __future__ import annotations

import math

F32 = 4


def decim_fir(rows: int, n: int, dec: int, taps: int, planes: int,
              complex_taps: bool = False, ctx: int = 0):
    """K2, the decimating FIR ``y[f] = sum_t h[t] x[f*dec - t]``.

    ``rows`` independent streams of ``n`` input samples each, ``planes``
    float32 planes a stream (1 for a real stream, 2 for re/im),
    ``taps`` taps (real, or complex with ``complex_taps``), ``ctx``
    carried input samples a plane read and written.  Returns ``(bytes,
    flops)``."""
    out = n // dec
    nbytes = F32 * rows * planes * (n + out + 2 * ctx)
    nbytes += F32 * taps * (2 if complex_taps else 1)
    if complex_taps and planes == 2:
        macs = 4 * taps          # a complex product a tap
    else:
        macs = planes * taps     # real taps on each plane
    return nbytes, 2 * macs * rows * out


def channelizer(n: int, k: int, taps_per_branch: int, ctx: int = 0):
    """K8, the polyphase DFT channelizer: ``n`` complex samples (two
    float32 planes) in, ``[n/k, k]`` complex out; ``k *
    taps_per_branch`` real prototype taps; ``ctx`` carried samples a
    plane read (the next context is the caller's copy of the block's
    tail, not the kernel's).  Operations: the branch filter's
    ``taps_per_branch`` real multiply-adds on each plane of each sample,
    and a ``k``-point complex FFT a frame at ``5 k log2 k`` flops.
    Returns ``(bytes, flops)``."""
    frames = n // k
    nbytes = F32 * (2 * n + 2 * frames * k + 2 * ctx
                    + k * taps_per_branch)
    branch = 2 * 2 * taps_per_branch * n
    fft = 5 * k * math.log2(k) * frames
    return nbytes, branch + fft


_COST = {"k2": decim_fir, "k8": channelizer}


def cost(kind: str, shape: dict):
    """``(bytes, flops)`` of one launch of kernel ``kind`` at ``shape``."""
    return _COST[kind](**shape)
