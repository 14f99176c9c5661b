"""costas_roofline: the Costas recurrence kernel (``costas_loop_kernel``)
at its launch shape, one launch a round for every carrier: the bound
time (bytes and operations from ``benchlib.recurrence_cost.costas`` over
the published peaks) over its profiler time, in %.  None unless the
trace holds exactly one launch a round.  The loop is bound by its chain
of dependent operations, which neither peak sees."""

from benchlib.recurrence_cost import roofline_pct


def read(run):
    return roofline_pct(run)
