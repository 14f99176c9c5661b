"""idle_pct: share of the traced window (the host's span of the traced
segment, first hand-off to final drain) in which no kernel, copy or set
runs on the card, in %."""


def read(run):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)
