"""demod_roofline: the staged band monitor's lag-1 demod kernel
(``lag1_demod_kernel``) at its launch shape, one launch a block: the
bound time (bytes and operations from ``benchlib.demod_cost.lag1_demod``
over the published peaks) over its profiler time, in %.  None unless the
trace holds exactly one launch a block."""

from benchlib.demod_cost import roofline_pct


def read(run):
    return roofline_pct(run)
