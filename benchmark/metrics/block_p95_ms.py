"""block_p95_ms: the 95th percentile over the window's blocks of each
block's time from its hand-off by the source to its delivery to the
sink, in ms.  Host clock."""

from benchlib.serve import percentile


def read(run):
    if not run.latencies_s:
        return None
    return 1e3 * percentile(run.latencies_s, 95)
