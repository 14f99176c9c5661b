"""step_device_ms: device time a block of every kernel, copy and set in
the traced segment (the profiler's device events), in ms."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    return 1e3 * sum(o.seconds for o in tr.device_ops) / tr.blocks
