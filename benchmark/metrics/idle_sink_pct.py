"""idle_sink_pct: share of the traced window, in %, in which no
kernel, copy or set runs on the card while the host is inside
``stream.drain`` (the serving loop's wait, host copy and sink)."""

from benchlib.spans import idle_pct_under


def read(run):
    return idle_pct_under(run, "stream.drain")
