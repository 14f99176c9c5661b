"""setup_s: from the start of the process (before torch is imported) to
the first timed block's hand-off: import, library load (and build, in a
checkout's first run), the input ring, the warm-up.  Host clock."""


def read(run):
    return run.setup_s
