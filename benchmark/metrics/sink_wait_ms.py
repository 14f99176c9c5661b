"""sink_wait_ms: host ms a block inside the serving loop's
``stream.wait`` spans (``StreamRunner`` waiting on a block's event before
its drain), from the traced segment."""

from benchlib.spans import host_ms


def read(run):
    return host_ms(run, "stream.wait")
