"""ctypes bindings for the native streaming IO library.

This package's copy of :mod:`comms_tpu.native.loader`.
``NativeBlockReader`` overlaps disk reads with device work on a C++
thread (no GIL): Python borrows each filled block as a zero-copy numpy
view, ships it to the device, then releases the buffer back to the
ring.  ``NativeBlockWriter`` queues result blocks to a writer thread.

The library is compiled from ``loader.cpp`` with g++ at first use,
never at import, into ``build/comms_tpu_torch/native/`` at the
repository root (a directory git ignores).  Its file name carries a hash
of the source and the compiler flags, as the CUDA library's does
(:mod:`comms_tpu_torch.kernels._build`): a changed source builds anew,
an unchanged one is loaded as it is, and modification times are never
read.  Each build writes a temporary file in that directory and renames
it into place, so processes that build at once never load a half-written
library.  Where no toolchain is available, :func:`native_available`
says so and :func:`comms_tpu_torch.models.fm_receiver.run_file` reads
with numpy instead.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import Optional

import numpy as np

__all__ = ["NativeBlockReader", "NativeBlockWriter", "native_available",
           "library_path", "BUILD_DIR"]

_SRC = Path(__file__).resolve().parent / "loader.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / \
    "comms_tpu_torch" / "native"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-pthread"]

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None


def library_path() -> Path:
    """Where the library for the current ``loader.cpp`` lives (built or
    not): ``libcomms_io-<hash>.so``, the hash of the flags and source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libcomms_io-{h.hexdigest()[:16]}.so"


def _build(target: Path) -> None:
    """Compile ``loader.cpp`` into a temporary file beside ``target``,
    then rename it into place."""
    target.parent.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=target.parent)
    os.close(fd)
    try:
        subprocess.run(["g++", *CXX_FLAGS, str(_SRC), "-o", tmp],
                       check=True, capture_output=True, text=True)
        os.replace(tmp, target)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _bind(lib) -> None:
    lib.reader_open.restype = ctypes.c_void_p
    lib.reader_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                ctypes.c_uint32, ctypes.c_int]
    lib.reader_next.restype = ctypes.POINTER(ctypes.c_uint8)
    lib.reader_next.argtypes = [ctypes.c_void_p,
                                ctypes.POINTER(ctypes.c_uint64)]
    lib.reader_release.restype = None
    lib.reader_release.argtypes = [ctypes.c_void_p,
                                   ctypes.POINTER(ctypes.c_uint8)]
    lib.reader_close.restype = None
    lib.reader_close.argtypes = [ctypes.c_void_p]
    lib.writer_open.restype = ctypes.c_void_p
    lib.writer_open.argtypes = [ctypes.c_char_p, ctypes.c_uint64,
                                ctypes.c_uint32]
    lib.writer_submit.restype = None
    lib.writer_submit.argtypes = [ctypes.c_void_p,
                                  ctypes.POINTER(ctypes.c_uint8),
                                  ctypes.c_uint64]
    lib.writer_close.restype = None
    lib.writer_close.argtypes = [ctypes.c_void_p]


def _get_lib():
    """The loaded library, built first if its file is missing.  Raises
    RuntimeError (and keeps raising it) when it cannot be built."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None:
            return _lib
        if _build_error is not None:
            raise RuntimeError(f"native IO unavailable: {_build_error}")
        try:
            target = library_path()
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
        except subprocess.CalledProcessError as e:
            _build_error = e.stderr or str(e)
            raise RuntimeError(f"native IO unavailable: {_build_error}") \
                from e
        except OSError as e:     # no g++, an unwritable build directory
            _build_error = str(e)
            raise RuntimeError(f"native IO unavailable: {e}") from e
        _bind(lib)
        _lib = lib
        return lib


def native_available() -> bool:
    """Whether the library builds (or is built) and loads here."""
    try:
        _get_lib()
        return True
    except RuntimeError:
        return False


class NativeBlockReader:
    """Iterate fixed-size byte blocks from a file, read ahead on a C++
    thread into a ring of ``n_buffers`` buffers.  ``dtype``/``shape``
    reinterpret each block (e.g. ``dtype=np.uint8, shape=(-1, 2)`` for
    raw rtl-sdr IQ)."""

    def __init__(self, path, block_bytes: int, n_buffers: int = 3,
                 loop: bool = False, dtype=np.uint8, shape=None):
        self._lib = _get_lib()
        self._h = self._lib.reader_open(
            str(path).encode(), int(block_bytes), int(n_buffers),
            1 if loop else 0,
        )
        if not self._h:
            raise FileNotFoundError(path)
        self.block_bytes = int(block_bytes)
        self.dtype = np.dtype(dtype)
        self.shape = shape
        self._borrowed = None

    def next_block(self) -> Optional[np.ndarray]:
        """Borrow the next block (zero-copy).  Returns None at EOF.  The
        previous block is released first, so its view must not be read
        after this call."""
        self.release()
        n = ctypes.c_uint64()
        ptr = self._lib.reader_next(self._h, ctypes.byref(n))
        if not ptr or n.value == 0:
            return None
        self._borrowed = ptr
        arr = np.ctypeslib.as_array(ptr, shape=(n.value,)).view(self.dtype)
        if self.shape is not None:
            arr = arr.reshape(self.shape)
        return arr

    def release(self) -> None:
        if self._borrowed is not None:
            self._lib.reader_release(self._h, self._borrowed)
            self._borrowed = None

    def close(self) -> None:
        if self._h:
            self.release()
            self._lib.reader_close(self._h)
            self._h = None

    def __iter__(self):
        """Yields OWNED copies (safe to keep).  The zero-copy path is
        explicit ``next_block()``, consume, next call."""
        while True:
            b = self.next_block()
            if b is None:
                return
            yield b.copy()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


class NativeBlockWriter:
    """Queue result blocks to a C++ writer thread (copied once into the
    queue; its bounded depth gives back-pressure)."""

    def __init__(self, path, n_buffers: int = 4):
        self._lib = _get_lib()
        self._h = self._lib.writer_open(str(path).encode(), 0,
                                        int(n_buffers))
        if not self._h:
            raise OSError(f"cannot open {path} for writing")

    def write(self, arr) -> None:
        arr = np.ascontiguousarray(arr)
        ptr = arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
        self._lib.writer_submit(self._h, ptr, arr.nbytes)

    def close(self) -> None:
        if self._h:
            self._lib.writer_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
