"""The program's own spans in a traced segment: the port opens them
(``runtime/metrics.named_scope``) on the profiler's host clock, so they
line up with the device's events.  Host time inside spans of a name, and
the device's idle time while the host is inside one.  Each helper gives
None where the trace holds no such span, as in a program without them,
or no device operation, as on the CPU, where the kernel spans wrap the
plain versions' arithmetic and not a launch."""

from __future__ import annotations

from benchlib.trace import _union, busy_us


def _spans(run, match):
    tr = run.trace
    if tr is None or not tr.device_ops:
        return None, []
    return tr, [o for o in tr.host_ops if match(o.name)]


def host_ms(run, name: str):
    """Host ms a block inside spans named ``name`` (summed)."""
    tr, ops = _spans(run, lambda n: n == name)
    if not ops:
        return None
    return sum(o.end_us - o.start_us for o in ops) / 1e3 / tr.blocks


def union_ms(run, prefix: str):
    """Host ms a block inside any span whose name starts with
    ``prefix``, overlaps counted once."""
    tr, ops = _spans(run, lambda n: n.startswith(prefix))
    if not ops:
        return None
    lo = min(o.start_us for o in ops)
    hi = max(o.end_us for o in ops)
    return busy_us(ops, lo, hi) / 1e3 / tr.blocks


def idle_pct_under(run, name: str):
    """Share of the traced window, in %, in which no device operation
    runs while the host is inside a span named ``name``."""
    tr, ops = _spans(run, lambda n: n == name)
    if not ops:
        return None
    lo, hi = tr.window.start_us, tr.window.end_us
    idle = sum((e - s) - busy_us(tr.device_ops, s, e)
               for s, e in _union(ops, lo, hi))
    return 100.0 * idle / (hi - lo)
