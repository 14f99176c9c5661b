"""k8_roofline: K8 (``channelize_kernel``) at its launch shapes: the
bound time (bytes and operations from ``benchlib.kernels.channelizer``
over the published peaks) over its profiler time, summed over its
launches, in %."""

from benchlib.readers import roofline_pct


def read(run):
    return roofline_pct(run, "k8", "channelize_kernel")
