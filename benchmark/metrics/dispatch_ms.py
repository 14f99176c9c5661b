"""dispatch_ms: host time of the served step's call (it enqueues the
block's device work), mean over the window's blocks, in ms.  Host clock
around the step the benchmark hands the runner."""


def read(run):
    if not run.dispatch_s:
        return None
    return 1e3 * sum(run.dispatch_s) / len(run.dispatch_s)
