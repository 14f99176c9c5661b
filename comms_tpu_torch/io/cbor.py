"""CBOR block codec: wire interop with a live comms-rs peer.

A copy of :mod:`comms_tpu.io.cbor` (the port imports nothing of the
JAX package).

The reference's ZMQ nodes serialize every block with
``serde_cbor::ser::to_vec_packed`` and decode with ``from_slice``
(``src/io/zmq_node.rs:62,135``).  For the sample-block
types the reference actually sends, that wire format (RFC 7049) is:

* ``Vec<Complex<T>>`` — a definite-length CBOR array of 2-element
  arrays ``[re, im]``: num-complex 0.4 implements ``Serialize`` as
  ``(&self.re, &self.im).serialize(..)`` (a Rust tuple -> CBOR array),
  unaffected by packed mode (packing only renames struct/enum fields,
  and tuples have none).
* ``Vec<i16>`` / ``Vec<u8>`` — an array of minimally-encoded integers
  (major types 0/1).
* ``f32`` values — single-precision (``0xfa`` + 4 BE bytes) when
  finite; serde_cbor emits half-precision (``0xf9``) only for
  NaN/infinity.  f64 values that round-trip through f32 losslessly are
  written as f32 by serde_cbor; this encoder mirrors that.

No CBOR library exists in this environment, so this is a minimal
self-contained codec covering exactly the above (arrays, ints, floats
of all three widths, and — decode-only, defensively — maps with int or
text keys for any peer that serializes Complex as a named struct).

Fast paths: homogeneous ``complex64`` blocks encode/decode through one
numpy structured-array view (each element is the fixed 12-byte pattern
``82 fa <re> fa <im>``) instead of a per-sample Python loop — the case
the reference's ``qpsk_zmq`` example exchanges.
"""

from __future__ import annotations

import struct
from typing import Any, List

import numpy as np

from comms_tpu_torch.errors import CommError

__all__ = ["encode_block", "decode_block"]


# ------------------------------------------------------------- encode

def _enc_uint(major: int, n: int, out: List[bytes]) -> None:
    mb = major << 5
    if n < 24:
        out.append(struct.pack("B", mb | n))
    elif n < 1 << 8:
        out.append(struct.pack("BB", mb | 24, n))
    elif n < 1 << 16:
        out.append(struct.pack(">BH", mb | 25, n))
    elif n < 1 << 32:
        out.append(struct.pack(">BI", mb | 26, n))
    else:
        out.append(struct.pack(">BQ", mb | 27, n))


def _enc_int(v: int, out: List[bytes]) -> None:
    if v >= 0:
        _enc_uint(0, v, out)
    else:
        _enc_uint(1, -1 - v, out)


_F16_POS_INF = b"\xf9\x7c\x00"
_F16_NEG_INF = b"\xf9\xfc\x00"
_F16_NAN = b"\xf9\x7e\x00"


def _enc_float(v: float, out: List[bytes], single: bool) -> None:
    if np.isnan(v):
        out.append(_F16_NAN)
    elif np.isinf(v):
        out.append(_F16_POS_INF if v > 0 else _F16_NEG_INF)
    elif single or np.float64(np.float32(v)) == np.float64(v):
        out.append(struct.pack(">Bf", 0xFA, float(v)))
    else:
        out.append(struct.pack(">Bd", 0xFB, float(v)))


def encode_block(arr: np.ndarray) -> bytes:
    """Encode a 1-D sample block as the reference's CBOR wire format
    (``Vec<T>`` / ``Vec<Complex<T>>`` under ``to_vec_packed``)."""
    arr = np.ascontiguousarray(arr)
    if arr.ndim != 1:
        raise ValueError("CBOR block codec takes 1-D blocks")
    n = arr.shape[0]
    head: List[bytes] = []
    _enc_uint(4, n, head)

    if arr.dtype == np.complex64 and np.isfinite(arr).all():
        body = np.empty(n, dtype=[("h", "u1"), ("t1", "u1"), ("re", ">f4"),
                                  ("t2", "u1"), ("im", ">f4")])
        body["h"] = 0x82
        body["t1"] = 0xFA
        body["t2"] = 0xFA
        body["re"] = arr.real
        body["im"] = arr.imag
        return b"".join(head) + body.tobytes()

    out = head
    if np.issubdtype(arr.dtype, np.complexfloating):
        single = arr.dtype == np.complex64
        for z in arr:
            out.append(b"\x82")
            _enc_float(z.real, out, single)
            _enc_float(z.imag, out, single)
    elif np.issubdtype(arr.dtype, np.floating):
        single = arr.dtype == np.float32
        for v in arr:
            _enc_float(v, out, single)
    elif np.issubdtype(arr.dtype, np.integer):
        for v in arr:
            _enc_int(int(v), out)
    else:
        raise TypeError(f"unsupported CBOR block dtype {arr.dtype}")
    return b"".join(out)


# ------------------------------------------------------------- decode

# A network-facing decoder must FAIL CLOSED on adversarial payloads
# (the reference's recv path deserializes straight off the socket,
# zmq_node.rs:130-140): recursion is depth-bounded, every declared
# length is capped against the bytes actually present BEFORE any
# allocation, and all parse failures map to the CommError taxonomy.
_MAX_DEPTH = 64


class _Reader:
    __slots__ = ("buf", "pos")

    def __init__(self, buf: bytes):
        self.buf = buf
        self.pos = 0

    def take(self, n: int) -> bytes:
        b = self.buf[self.pos:self.pos + n]
        if len(b) != n:
            raise CommError("truncated CBOR payload")
        self.pos += n
        return b

    def remaining(self) -> int:
        return len(self.buf) - self.pos


def _read_len(r: _Reader, info: int) -> int:
    if info < 24:
        return info
    if info == 24:
        return r.take(1)[0]
    if info == 25:
        return struct.unpack(">H", r.take(2))[0]
    if info == 26:
        return struct.unpack(">I", r.take(4))[0]
    if info == 27:
        return struct.unpack(">Q", r.take(8))[0]
    raise CommError(f"unsupported CBOR length info {info}")


def _read_count(r: _Reader, info: int, per_item: int) -> int:
    """Declared element count, rejected up front if even minimal
    encodings (``per_item`` bytes each) cannot fit in the remaining
    buffer — a forged 2^64 length then fails in O(1), not at a 2^64
    allocation."""
    n = _read_len(r, info)
    if n * per_item > r.remaining():
        raise CommError(
            f"CBOR declares {n} elements but only {r.remaining()} "
            "bytes remain")
    return n


def _decode_item(r: _Reader, depth: int = 0) -> Any:
    if depth > _MAX_DEPTH:
        raise CommError(f"CBOR nesting exceeds {_MAX_DEPTH}")
    ib = r.take(1)[0]
    major, info = ib >> 5, ib & 0x1F
    if major == 0:
        return _read_len(r, info)
    if major == 1:
        return -1 - _read_len(r, info)
    if major == 2:  # byte string (a peer using serde_bytes)
        return np.frombuffer(r.take(_read_count(r, info, 1)),
                             dtype=np.uint8)
    if major == 3:
        try:
            return r.take(_read_count(r, info, 1)).decode("utf-8")
        except UnicodeDecodeError as e:
            raise CommError(f"invalid CBOR text: {e}") from None
    if major == 4:
        return [_decode_item(r, depth + 1)
                for _ in range(_read_count(r, info, 1))]
    if major == 5:
        return {_freeze(_decode_item(r, depth + 1)):
                _decode_item(r, depth + 1)
                for _ in range(_read_count(r, info, 2))}
    if major == 7:
        if info == 25:
            return _half_to_float(struct.unpack(">H", r.take(2))[0])
        if info == 26:
            return struct.unpack(">f", r.take(4))[0]
        if info == 27:
            return struct.unpack(">d", r.take(8))[0]
        if info in (20, 21):
            return info == 21
        if info == 22:
            return None
    raise CommError(f"unsupported CBOR item (major {major}, info {info})")


def _freeze(k: Any) -> Any:
    return k if isinstance(k, (int, str, bool)) else str(k)


def _half_to_float(h: int) -> float:
    return float(np.frombuffer(struct.pack("<H", h), dtype=np.float16)[0])


def _as_complex(el: Any) -> complex:
    if isinstance(el, (list, tuple)) and len(el) == 2:
        return complex(el[0], el[1])
    if isinstance(el, dict):  # named-struct peer: {re, im} or {0, 1}
        if "re" in el:
            return complex(el["re"], el["im"])
        if 0 in el:
            return complex(el[0], el[1])
    raise CommError(f"CBOR element is not a Complex encoding: {el!r}")


def decode_block(data: bytes, dtype=None) -> np.ndarray:
    """Decode one CBOR block.  Element shape picks the dtype:
    2-element arrays/maps -> ``complex64``, floats -> ``float32``,
    ints -> ``int32`` (pass ``dtype`` to override, e.g. ``np.int16``
    for a ``Vec<i16>`` peer).

    Fails closed: any malformed, truncated, over-deep, or
    length-forged payload raises :class:`CommError` (never a raw
    Python-level error) — see the fuzz test in ``tests/test_aux.py``."""
    try:
        return _decode_block(data, dtype)
    except CommError:
        raise
    except (ValueError, TypeError, OverflowError, MemoryError,
            RecursionError, struct.error) as e:
        raise CommError(f"malformed CBOR payload: {e!r}") from None


def _decode_block(data: bytes, dtype=None) -> np.ndarray:
    # Fast path: definite array of [0x82 0xfa re 0xfa im] (Vec<Complex
    # <f32>> with finite values) — one structured view, no loop.
    r = _Reader(data)
    ib = data[0] if data else 0
    if ib >> 5 == 4:
        r.take(1)
        n = _read_len(r, ib & 0x1F)
        body = data[r.pos:]
        if len(body) == 12 * n and n:
            v = np.frombuffer(body, dtype=[("h", "u1"), ("t1", "u1"),
                                           ("re", ">f4"), ("t2", "u1"),
                                           ("im", ">f4")])
            if ((v["h"] == 0x82).all() and (v["t1"] == 0xFA).all()
                    and (v["t2"] == 0xFA).all()):
                out = np.empty(n, np.complex64)
                out.real = v["re"]
                out.imag = v["im"]
                return out.astype(dtype) if dtype is not None else out
        r.pos = 0

    items = _decode_item(r)
    if r.pos != len(data):
        raise CommError("trailing bytes after CBOR item")
    if not isinstance(items, list):
        if isinstance(items, np.ndarray):  # byte string
            return items.astype(dtype) if dtype is not None else items
        raise CommError("CBOR payload is not a block (array)")
    if not items:
        return np.zeros(0, dtype=dtype if dtype is not None else np.float32)
    el = items[0]
    if isinstance(el, (list, dict)):
        out = np.array([_as_complex(e) for e in items], dtype=np.complex64)
    elif isinstance(el, float) or any(isinstance(e, float) for e in items):
        out = np.asarray(items, dtype=np.float32)
    else:
        out = np.asarray(items, dtype=np.int64)
        info = np.iinfo(np.int32)
        if out.min() >= info.min and out.max() <= info.max:
            out = out.astype(np.int32)
    return out.astype(dtype) if dtype is not None else out
