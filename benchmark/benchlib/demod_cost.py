"""Bytes and operations of a launch of the staged band monitor's lag-1
FM demod kernel (``lag1_demod_kernel``, ``csrc/lag1_demod.cu``), from its
shape alone, as :mod:`benchlib.kernels` counts the filters: every input
byte read once, every output byte written once, and the arithmetic of
the plain formula.  Kept apart from :mod:`benchlib.kernels`, whose table
names the filter kernels.

A launch demodulates a block's ``n`` channelized samples, ``k`` channels
of ``n / k`` frames: the two float32 planes in and d out (12 B a sample),
the carried previous frame read and the next one written (16 B a
channel).  A sample counts its float32 operations as written: the lag-1
product's imaginary and real parts (4 multiplies, 2 adds), then the
polynomial atan2: two absolute values, the octant compare, min and max,
``den + 1e-30``, the division, ``r * r``, seven Horner steps (a multiply
and an add each), ``p * r`` and the three reflections (``pi/2 - a``,
``pi - a``, ``-a``): 6 + 26 = 32 a sample.
"""

from __future__ import annotations

from benchlib import device

F32 = 4
DEMOD_FLOPS_A_SAMPLE = 6 + (2 + 1 + 2 + 1 + 1 + 1 + 7 * 2 + 1 + 3)


def lag1_demod(n: int, k: int):
    """``(bytes, flops)`` of one launch over ``n`` samples of ``k``
    channels."""
    return F32 * (3 * n + 4 * k), DEMOD_FLOPS_A_SAMPLE * n


def roofline_pct(run):
    """The demod kernel's share of its roofline over the traced segment:
    the bound time of its launch (``n`` and ``k`` from the served path's
    ``("k8", shape)`` entry, the channelizer whose output it reads, over
    :mod:`benchlib.device`'s peaks) over the profiler's time of the
    kernel's events, in %.  None where the trace holds no such kernel, or
    not exactly one launch a block."""
    tr = run.trace
    if tr is None:
        return None
    ev = [o for o in tr.device_ops if o.short == "lag1_demod_kernel"]
    shapes = [s for key, s in run.launches if key == "k8"]
    if len(shapes) != 1 or not ev or len(ev) != tr.blocks:
        return None
    bound, _ = device.bound_s(*lag1_demod(shapes[0]["n"], shapes[0]["k"]))
    return 100.0 * tr.blocks * bound / sum(o.seconds for o in ev)
