"""sink_lent_pct: share, in %, of the serving loop's ``stream.copy``
spans (``StreamRunner`` handing a block to the sink) that hold a
``stream.lend`` span (the block lent to the sink as its pinned D2H
buffers, not copied), from the traced segment.  0 where every block was
copied, as in a program that lends nothing; None where the trace holds
no ``stream.copy`` span or no device operation."""

from benchlib.spans import _spans


def read(run):
    tr, ops = _spans(run, lambda n: n in ("stream.copy", "stream.lend"))
    lends = [o for o in ops if o.name == "stream.lend"]
    copies = [o for o in ops if o.name == "stream.copy"]
    if not copies:
        return None
    held = sum(1 for c in copies
               if any(c.start_us <= o.start_us and o.end_us <= c.end_us
                      for o in lends))
    return 100.0 * held / len(copies)
