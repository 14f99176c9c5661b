"""wrapper_host_ms: host ms a block inside the kernel wrappers'
``kernel.*`` spans (checks, allocations, constant lookups and the ctypes
launch), their union, from the traced segment."""

from benchlib.spans import union_ms


def read(run):
    return union_ms(run, "kernel.")
