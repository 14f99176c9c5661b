"""Native (C++) runtime components, loaded with ctypes.

This package's copy of :mod:`comms_tpu.native`.  ``loader.cpp`` is built
with g++ at first use, never at import, into ``build/comms_tpu_torch/
native/`` under a hash of its source (see :mod:`.loader`).
"""

from comms_tpu_torch.native.loader import (  # noqa: F401
    NativeBlockReader,
    NativeBlockWriter,
    native_available,
)
