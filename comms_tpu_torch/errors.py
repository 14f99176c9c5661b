"""Error taxonomy: parity with the reference's ``NodeError``
(``src/node/mod.rs:67-91``), adapted to exceptions.  A copy of
:mod:`comms_tpu.errors` (the port imports nothing of the JAX package).

The reference's four variants and their meaning here:

* ``DataError``      — a block failed validation (bad samples /
                       shapes); recoverable by skipping the block.
* ``PermanentError`` — the op can never succeed again (bad
                       construction, device lost).
* ``DataEnd``        — the stream is exhausted.  The reference's EOF
                       handling is sleep-forever-then-panic
                       (raw_iq.rs:56-70); here end-of-stream is an
                       explicit, catchable signal (or a None/empty
                       return on the iterator paths).
* ``CommError``      — a transport failure (socket closed mid-frame,
                       bad wire header).

All derive from ``CommsError`` so callers can catch the family.
"""

from __future__ import annotations

__all__ = [
    "CommsError",
    "DataError",
    "PermanentError",
    "DataEnd",
    "CommError",
]


class CommsError(Exception):
    """Base for framework errors (NodeError, node/mod.rs:67-73)."""


class DataError(CommsError):
    """Incorrect/unusable data; retry with the next block may work."""


class PermanentError(CommsError):
    """Unrecoverable; the pipeline should shut down."""


class DataEnd(CommsError):
    """No more data will ever arrive (explicit EOF)."""


class CommError(CommsError, ConnectionError):
    """Communication/transport failure."""
