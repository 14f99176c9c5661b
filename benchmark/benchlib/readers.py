"""Helpers of the metric readers (``metrics/*.py``)."""

from __future__ import annotations

from benchlib import device, kernels


def roofline_pct(run, key: str, kernel: str):
    """A kernel's share of its roofline over the traced segment: the
    bound time of its launches (shapes from the served path, ``key``
    into :mod:`benchlib.kernels`) over the profiler's time of the
    kernel's events (bare name ``kernel``), in %.  None where the trace
    has no such kernel or its launches do not match the shapes."""
    tr = run.trace
    if tr is None:
        return None
    ev = [o for o in tr.device_ops if o.short == kernel]
    shapes = [s for k, s in run.launches if k == key]
    if not ev or not shapes or len(ev) != len(shapes) * tr.blocks:
        return None
    per_block = sum(device.bound_s(*kernels.cost(key, s))[0]
                    for s in shapes)
    return 100.0 * tr.blocks * per_block / sum(o.seconds for o in ev)
