"""sink_copy_ms: host ms a block inside the serving loop's
``stream.copy`` spans (``StreamRunner`` copying each output leaf out of
its pinned buffer into a new host array), from the traced segment."""

from benchlib.spans import host_ms


def read(run):
    return host_ms(run, "stream.copy")
