"""The benchmark's own library: the card and its peaks, the bytes and
operations of a kernel launch, the precisions a reference runs in, the
serving window, the trace reduction and the manifest's lookups.  It
imports nothing of the program; the served paths (``paths/*.py``) do."""
