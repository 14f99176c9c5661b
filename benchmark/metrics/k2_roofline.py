"""k2_roofline: K2 (``decim_fir_kernel``) at its launch shapes: the
bound time (bytes and operations from ``benchlib.kernels.decim_fir``
over the published peaks) over its profiler time, summed over its
launches, in %."""

from benchlib.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k2", "decim_fir_kernel")
