"""Bytes and operations of a launch of the recurrence kernels
(``csrc/recurrence.cu``), from its shape alone, as
:mod:`benchlib.kernels` counts the filters: every input byte read once,
every output byte written once, and the arithmetic of the plain
formula.  Kept apart from :mod:`benchlib.kernels`, whose table names the
filter kernels.

A Costas launch walks ``streams`` independent streams of ``steps``
symbols each: two float32 planes in, two out (16 B a step a stream),
and the carried ``(phase, freq)`` read and written (16 B a stream).  A
step of the order-4 loop, ``c = s e^{-j ph}``, ``e = arg(-c^4) / 4``,
``fr += beta e``, ``ph = (ph + fr) + alpha e``, counts its float32
operations as written: cos and sin of ph (1 each), the complex rotation
(4 multiplies, 2 adds), c^4 as two complex squarings (6 each: 4
multiplies and 2 adds, ``x^2 = (a^2 - b^2, ab + ba)``), the negations
and atan2 of -c^4 (2, and 1), the division by 4 (1), the frequency
update (2) and the phase update (3): 29 a step.
"""

from __future__ import annotations

from benchlib import device

F32 = 4
COSTAS_FLOPS_A_STEP = 2 + 6 + 2 * 6 + 3 + 1 + 2 + 3


def costas(streams: int, steps: int):
    """``(bytes, flops)`` of one Costas launch over ``streams`` streams of
    ``steps`` symbols."""
    nbytes = F32 * streams * (4 * steps + 4)
    return nbytes, COSTAS_FLOPS_A_STEP * streams * steps


def roofline_pct(run):
    """The Costas kernel's share of its roofline over the traced segment:
    the bound time of its launch (shape from the served path's
    ``("costas", shape)``, over :mod:`benchlib.device`'s peaks) over the
    profiler's time of the kernel's events, in %.  None where the trace
    holds no such kernel, or not exactly one launch a block."""
    tr = run.trace
    if tr is None:
        return None
    ev = [o for o in tr.device_ops if o.short == "costas_loop_kernel"]
    shapes = [s for k, s in run.launches if k == "costas"]
    if len(shapes) != 1 or len(ev) != tr.blocks:
        return None
    bound, _ = device.bound_s(*costas(**shapes[0]))
    return 100.0 * tr.blocks * bound / sum(o.seconds for o in ev)
