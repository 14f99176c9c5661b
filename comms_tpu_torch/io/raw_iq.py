"""Raw IQ file I/O: interleaved int16 re/im, native endian.

This package's copy of :mod:`comms_tpu.io.raw_iq` (jax-free numpy; the
JAX package cannot be imported without jax).  The format is the
reference's ``src/io/raw_iq.rs``: a stream of ``Complex<i16>`` stored as
re, im int16 pairs in host byte order, so files written by either
framework diff directly.

Host-side numpy; block iteration feeds the block steps.  EOF handling
is explicit (the reference sleeps forever then panics, raw_iq.rs:56-70,
deliberately not reproduced): the final ragged block is dropped,
zero-padded or yielded short, per the ``tail`` policy.
"""

from __future__ import annotations

import io as _io
import os
from typing import Iterator, Optional, Union

import numpy as np

__all__ = [
    "read_iq",
    "write_iq",
    "iter_iq_blocks",
    "IQWriter",
    "float_to_iq_i16",
    "iq_i16_to_float",
]

Pathish = Union[str, os.PathLike]


def read_iq(src: Union[Pathish, bytes, _io.IOBase],
            count: int = -1) -> np.ndarray:
    """Read complex IQ from an i16-interleaved file/buffer.

    Returns complex64 (values are the raw integer magnitudes, not
    rescaled — matching IQInput which emits Complex<i16> verbatim,
    raw_iq.rs:49-74).
    """
    if isinstance(src, (bytes, bytearray)):
        raw = np.frombuffer(src, dtype=np.int16,
                            count=-1 if count < 0 else count * 2)
    elif hasattr(src, "read"):
        data = src.read(-1 if count < 0 else count * 4)
        raw = np.frombuffer(data, dtype=np.int16)
    else:
        raw = np.fromfile(src, dtype=np.int16,
                          count=-1 if count < 0 else count * 2)
    raw = raw[: (len(raw) // 2) * 2].reshape(-1, 2).astype(np.float32)
    return (raw[:, 0] + 1j * raw[:, 1]).astype(np.complex64)


def float_to_iq_i16(x, scale: float = 1.0) -> np.ndarray:
    """complex float -> interleaved i16 pairs, truncating toward zero
    like Rust's ``as i16`` cast (single_thread_bpsk.rs:42-48)."""
    x = np.asarray(x)
    re = np.trunc(np.real(x) * scale)
    im = np.trunc(np.imag(x) * scale)
    out = np.empty((len(re), 2), dtype=np.int16)
    out[:, 0] = np.clip(re, -32768, 32767).astype(np.int16)
    out[:, 1] = np.clip(im, -32768, 32767).astype(np.int16)
    return out.reshape(-1)


def iq_i16_to_float(raw: np.ndarray, scale: float = 1.0) -> np.ndarray:
    """Interleaved i16 -> complex64, optionally scaled."""
    raw = np.asarray(raw, dtype=np.float32).reshape(-1, 2)
    return ((raw[:, 0] + 1j * raw[:, 1]) * np.float32(scale)).astype(
        np.complex64
    )


def write_iq(dst: Union[Pathish, _io.IOBase], x,
             scale: float = 1.0) -> int:
    """Write complex samples as interleaved i16 (IQOutput/IQBatchOutput
    parity, raw_iq.rs:143-223).  Returns samples written."""
    out = float_to_iq_i16(x, scale)
    if hasattr(dst, "write"):
        dst.write(out.tobytes())
    else:
        with open(dst, "ab") as f:
            out.tofile(f)
    return len(out) // 2


class IQWriter:
    """Streaming sink: append blocks to a file (BufWriter parity)."""

    def __init__(self, path: Pathish, scale: float = 1.0):
        self.path = path
        self.scale = scale
        self._f = open(path, "wb")

    def write(self, x) -> int:
        out = float_to_iq_i16(x, self.scale)
        self._f.write(out.tobytes())
        return len(out) // 2

    def close(self):
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


def iter_iq_blocks(path: Pathish, block: int, tail: str = "drop",
                   scale: Optional[float] = None) -> Iterator[np.ndarray]:
    """Yield complex64 blocks of ``block`` samples from an IQ file.

    ``tail``: 'drop' (default), 'pad' (zero-fill final block), or
    'short' (yield the ragged remainder as-is).
    """
    if tail not in ("drop", "pad", "short"):
        raise ValueError(f"bad tail policy {tail!r}")
    nbytes = block * 4
    with open(path, "rb") as f:
        while True:
            data = f.read(nbytes)
            if not data:
                return
            n = len(data) // 4
            if n < block:
                if tail == "drop":
                    return
                x = read_iq(data[: n * 4])
                if scale is not None:
                    x = (x * np.float32(scale)).astype(np.complex64)
                if tail == "pad":
                    x = np.pad(x, (0, block - n))
                yield x
                return
            x = read_iq(data)
            if scale is not None:
                x = (x * np.float32(scale)).astype(np.complex64)
            yield x
