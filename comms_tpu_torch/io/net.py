"""Socket transport for sample blocks: the ZMQ path.

Counterpart of :mod:`comms_tpu.io.net`, with
functional parity with the reference's ``src/io/zmq_node.rs:9-141``
(``ZMQSend``/``ZMQRecv``): typed sample blocks serialized and moved
between processes over a socket, PUB/SUB or PUSH/PULL style.  The
reference serializes with CBOR (zmq_node.rs:62); here the default
wire format is a fixed 16-byte header (magic, dtype code, byte
length) + raw array bytes — zero-copy on both ends and dtype-checked,
which is both faster and stricter than CBOR for fixed-schema sample
streams.  Pass ``codec="cbor"`` for wire interop with a LIVE comms-rs
peer: blocks are then encoded exactly as ``serde_cbor::to_vec_packed``
emits them (:mod:`comms_tpu_torch.io.cbor`) — over the zmq backend the
message is the bare CBOR payload, byte-compatible with ``ZMQSend``/
``ZMQRecv``; over the tcp fallback it rides inside the length-prefixed
frame (that backend is stream-oriented and never talks to comms-rs).

If ``pyzmq`` is importable it is used (PUB binds / SUB connects+
subscribes-all, matching zmq_node.rs:47-49,115-118); otherwise a
plain-TCP fallback with identical framing provides PUSH/PULL
semantics, so the transport works where pyzmq is not installed.  Only
an ``ImportError`` selects the fallback: any other failure of the
import propagates.

Two differences from the JAX package, both about start and end of a
stream: the TCP receiver retries its connect until its ``timeout``
(default 30 s) runs out, so a receiver may start before its sender
binds, as a zmq receiver may; and a zmq sender closes with a 2 s linger,
not 0, so blocks it sent before the peer's handshake completed are
delivered rather than dropped.

This transport is host-boundary egress: it feeds visualization,
recording, or other processes from the host; blocks cross it as numpy
arrays.
"""

from __future__ import annotations

import errno
import os
import socket
import struct
import threading
import time
from typing import Optional, Tuple

import numpy as np

from comms_tpu_torch.errors import CommError
from comms_tpu_torch.io import cbor

try:  # optional, like the reference's zmq_node cargo feature
    import zmq as _zmq  # type: ignore

    HAVE_ZMQ = True
except ImportError:  # pragma: no cover - environment-dependent
    _zmq = None
    HAVE_ZMQ = False

__all__ = ["BlockSender", "BlockReceiver", "BlockRequester",
           "BlockReplier", "HAVE_ZMQ"]

_MAGIC = 0x43544655  # "CTFU"
_HEADER = struct.Struct("<IIQ")  # magic, dtype code, payload bytes

_DTYPE_CODES = {
    np.dtype(np.int16): 1,
    np.dtype(np.float32): 2,
    np.dtype(np.uint8): 3,
    np.dtype(np.int8): 4,
    np.dtype(np.float64): 5,
    np.dtype(np.int32): 6,
}
_CBOR_CODE = 100  # tcp-fallback frames carrying a CBOR payload
_SEND_LINGER_MS = 2000  # how long a closed zmq sender keeps undelivered blocks
_CODE_DTYPES = {v: k for k, v in _DTYPE_CODES.items()}


def _pack(arr: np.ndarray) -> bytes:
    arr = np.ascontiguousarray(arr)
    code = _DTYPE_CODES.get(arr.dtype)
    if code is None:
        raise TypeError(f"unsupported wire dtype {arr.dtype} "
                        "(complex crosses as float32 pairs)")
    return _HEADER.pack(_MAGIC, code, arr.nbytes) + arr.tobytes()


def _unpack_header(hdr: bytes) -> Tuple[int, int]:
    magic, code, nbytes = _HEADER.unpack(hdr)
    if magic != _MAGIC:
        raise CommError("bad frame magic")
    if code != _CBOR_CODE and code not in _CODE_DTYPES:
        raise CommError(f"unknown dtype code {code}")
    return code, nbytes


def _code_dtype(code: int) -> np.dtype:
    dt = _CODE_DTYPES.get(code)
    if dt is None:
        raise CommError(f"frame code {code} is not a raw dtype")
    return dt


def _resolve_codec(codec: str) -> str:
    if codec not in ("raw", "cbor"):
        raise ValueError(f"codec must be 'raw' or 'cbor', got {codec!r}")
    return codec


class BlockSender:
    """Sends 1-D sample blocks.  ``ZMQSend`` parity.

    endpoint: "tcp://host:port".  With pyzmq, ``sock_type`` "PUB"
    (binds) or "PUSH" (connects), as the reference constructs
    (zmq_node.rs:41-55).  The TCP fallback always binds and streams
    to the first accepted client.

    ``backend``: "zmq", "tcp", or None (auto: zmq when importable).
    The two backends are NOT wire-compatible (ZMTP handshake vs raw
    frames) — both peers must use the same one; pin it explicitly
    when the endpoints may run in different environments.

    ``codec``: "raw" (default, this framework's zero-copy framing) or
    "cbor" (the reference's serde_cbor wire format — use with the zmq
    backend to interoperate with a running comms-rs graph).
    """

    def __init__(self, endpoint: str, sock_type: str = "PUB",
                 backend: str | None = None, codec: str = "raw",
                 flags: int = 0):
        self.endpoint = endpoint
        self.backend = _resolve_backend(backend)
        self.codec = _resolve_codec(codec)
        self.flags = int(flags)
        if self.flags and self.backend != "zmq":
            raise CommError("socket flags need the zmq backend")
        host, port = _parse_tcp(endpoint)
        if self.backend == "zmq":
            ctx = _zmq.Context.instance()
            st = getattr(_zmq, sock_type)
            self._sock = ctx.socket(st)
            if sock_type == "PUB":
                self._sock.bind(endpoint)
            else:
                self._sock.connect(endpoint)

            def _zsend(data: bytes, _s=self._sock, _f=self.flags):
                _s.send(data, _f)

            self._send = _zsend
        else:
            self._srv = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
            self._srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self._srv.bind((host, port))
            self._srv.listen(1)
            self._conn: Optional[socket.socket] = None
            self._lock = threading.Lock()

            def send(data: bytes):
                with self._lock:
                    if self._conn is None:
                        self._conn, _ = self._srv.accept()
                    self._conn.sendall(data)

            self._send = send

    def send(self, arr) -> None:
        arr = np.asarray(arr)
        if self.codec == "cbor":
            payload = cbor.encode_block(arr)
            if self.backend == "zmq":  # bare CBOR: comms-rs compatible
                self._send(payload)
            else:
                self._send(_HEADER.pack(_MAGIC, _CBOR_CODE, len(payload))
                           + payload)
            return
        self._send(_pack(arr))

    def close(self):
        if self.backend == "zmq":
            # a bounded linger: blocks sent before the peer's handshake
            # completed are still delivered (closing with linger 0 drops
            # them), and an absent peer holds the context at most this long
            self._sock.close(_SEND_LINGER_MS)
        else:
            if self._conn is not None:
                self._conn.close()
            self._srv.close()


class BlockReceiver:
    """Receives 1-D sample blocks.  ``ZMQRecv`` parity (SUB
    connects-and-subscribes-all, zmq_node.rs:115-118)."""

    def __init__(self, endpoint: str, sock_type: str = "SUB",
                 timeout: Optional[float] = None,
                 backend: str | None = None, codec: str = "raw",
                 dtype=None, flags: int = 0):
        self.endpoint = endpoint
        self.backend = _resolve_backend(backend)
        self.codec = _resolve_codec(codec)
        self.dtype = dtype  # optional decode override for codec="cbor"
        self.flags = int(flags)
        if self.flags and self.backend != "zmq":
            raise CommError("socket flags need the zmq backend")
        host, port = _parse_tcp(endpoint)
        if self.backend == "zmq":
            ctx = _zmq.Context.instance()
            st = getattr(_zmq, sock_type)
            self._sock = ctx.socket(st)
            if sock_type == "SUB":
                self._sock.connect(endpoint)
                self._sock.setsockopt_string(_zmq.SUBSCRIBE, "")
            else:
                self._sock.bind(endpoint)
            if timeout is not None:
                self._sock.setsockopt(_zmq.RCVTIMEO, int(timeout * 1000))
        else:
            self._sock = _connect_tcp(host, port, timeout)

    def recv(self) -> np.ndarray:
        if self.backend == "zmq":
            data = self._sock.recv(self.flags)
            if self.codec == "cbor":  # bare CBOR: comms-rs compatible
                return cbor.decode_block(data, dtype=self.dtype)
            code, nbytes = _unpack_header(data[: _HEADER.size])
            if len(data) - _HEADER.size != nbytes:
                raise CommError(
                    f"frame payload {len(data) - _HEADER.size} bytes "
                    f"!= header nbytes {nbytes}"
                )
            return np.frombuffer(data[_HEADER.size:],
                                 dtype=_code_dtype(code))
        hdr = self._recv_exact(_HEADER.size)
        code, nbytes = _unpack_header(hdr)
        payload = self._recv_exact(nbytes)
        if code == _CBOR_CODE:
            if self.codec != "cbor":
                raise CommError("peer sent a CBOR frame; construct the "
                                "receiver with codec='cbor'")
            return cbor.decode_block(payload, dtype=self.dtype)
        return np.frombuffer(payload, dtype=_code_dtype(code))

    def _recv_exact(self, n: int) -> bytes:
        chunks = []
        while n:
            c = self._sock.recv(n)
            if not c:
                raise CommError("peer closed mid-frame")
            chunks.append(c)
            n -= len(c)
        return b"".join(chunks)

    def close(self):
        if self.backend == "zmq":
            self._sock.close(0)
        else:
            self._sock.close()


class BlockRequester:
    """REQ side of a request-reply block exchange (zmq backend only).

    The reference's constructor accepts ANY ``zmq::SocketType`` plus a
    flags word (``zmq_node.rs:44-46,112``); its one-directional
    ZMQSend/ZMQRecv wrappers leave the REQ/REP state machine to the
    caller.  Here the round trip is explicit: ``ask(block) -> reply
    block`` — useful as a serving RPC (send a sample block, get the
    processed block back)."""

    def __init__(self, endpoint: str, timeout: Optional[float] = None,
                 codec: str = "raw", dtype=None, flags: int = 0):
        if not HAVE_ZMQ:
            raise CommError("REQ/REP needs the zmq backend")
        self.codec = _resolve_codec(codec)
        self.dtype = dtype
        self.flags = int(flags)
        ctx = _zmq.Context.instance()
        self._sock = ctx.socket(_zmq.REQ)
        if timeout is not None:
            self._sock.setsockopt(_zmq.RCVTIMEO, int(timeout * 1000))
        self._sock.connect(endpoint)

    def ask(self, arr) -> np.ndarray:
        arr = np.asarray(arr)
        if self.codec == "cbor":
            self._sock.send(cbor.encode_block(arr), self.flags)
            return cbor.decode_block(self._sock.recv(self.flags),
                                     dtype=self.dtype)
        self._sock.send(_pack(arr), self.flags)
        data = self._sock.recv(self.flags)
        code, nbytes = _unpack_header(data[: _HEADER.size])
        return np.frombuffer(data[_HEADER.size:],
                             dtype=_code_dtype(code))

    def close(self):
        self._sock.close(0)


class BlockReplier:
    """REP side: ``serve_once(fn)`` receives a block, applies ``fn``,
    sends the result back.  Binds, as a reference REP node would."""

    def __init__(self, endpoint: str, timeout: Optional[float] = None,
                 codec: str = "raw", dtype=None, flags: int = 0):
        if not HAVE_ZMQ:
            raise CommError("REQ/REP needs the zmq backend")
        self.codec = _resolve_codec(codec)
        self.dtype = dtype
        self.flags = int(flags)
        ctx = _zmq.Context.instance()
        self._sock = ctx.socket(_zmq.REP)
        if timeout is not None:
            self._sock.setsockopt(_zmq.RCVTIMEO, int(timeout * 1000))
        self._sock.bind(endpoint)

    def serve_once(self, fn) -> None:
        data = self._sock.recv(self.flags)
        if self.codec == "cbor":
            block = cbor.decode_block(data, dtype=self.dtype)
            out = np.asarray(fn(block))
            self._sock.send(cbor.encode_block(out), self.flags)
            return
        code, nbytes = _unpack_header(data[: _HEADER.size])
        block = np.frombuffer(data[_HEADER.size:],
                              dtype=_code_dtype(code))
        out = np.asarray(fn(block))
        self._sock.send(_pack(out), self.flags)

    def close(self):
        self._sock.close(0)


def _resolve_backend(backend: str | None) -> str:
    if backend is None:
        return "zmq" if HAVE_ZMQ else "tcp"
    if backend == "zmq" and not HAVE_ZMQ:
        raise CommError("backend='zmq' requested but pyzmq is not "
                        "importable")
    if backend not in ("zmq", "tcp"):
        raise ValueError(f"backend must be 'zmq', 'tcp', or None, "
                         f"got {backend!r}")
    return backend


def _connect_tcp(host: str, port: int, timeout: Optional[float]):
    """A TCP connection to ``(host, port)`` whose reads time out after
    ``timeout`` s; a refused connect is retried until ``timeout`` (30 s
    when None) has passed, then raises :class:`CommError`."""
    deadline = time.monotonic() + (30.0 if timeout is None else timeout)
    while True:
        sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        sock.settimeout(timeout)
        rc = sock.connect_ex((host, port))
        if rc == 0:
            return sock
        sock.close()
        if rc != errno.ECONNREFUSED or time.monotonic() >= deadline:
            raise CommError(f"cannot connect to {host}:{port}: "
                            f"{os.strerror(rc)}")
        time.sleep(0.02)


def _parse_tcp(endpoint: str) -> Tuple[str, int]:
    if not endpoint.startswith("tcp://"):
        raise ValueError(f"only tcp:// endpoints supported, got {endpoint}")
    host, _, port = endpoint[6:].partition(":")
    return host or "127.0.0.1", int(port)
