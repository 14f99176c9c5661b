"""The port's socket transport and CBOR codec against the JAX package's
(mirrors tests/test_aux.py's net and CBOR tests): raw and CBOR blocks
over both backends, REQ/REP, the codec's reference byte layouts, its
fail-closed decoder (raising the port's ``CommError``), and CBOR across
the packages: bytes from one package's encoder equal the other's and
decode there to the same array.

Every socket test takes its port from the OS (a socket bound to port 0)
and receives in a thread with a timeout, so no test can hang the suite.
The zmq backend's tests skip, inside the test, where pyzmq is not
importable; the TCP backend needs nothing."""

import socket
import struct
import threading

import numpy as np
import pytest

from comms_tpu.io import cbor as jcbor
from comms_tpu_torch import errors as terr
from comms_tpu_torch.io import cbor
from comms_tpu_torch.io import net

TIMEOUT = 10


def _free_port() -> int:
    """A port the OS hands out, outside 57400-57499, where the JAX
    package's transport tests bind fixed ports (they may run alongside)."""
    while True:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if not 57400 <= port <= 57499:
            return port


def _need(backend):
    if backend == "zmq" and not net.HAVE_ZMQ:
        pytest.skip("pyzmq is not importable")


def _loopback(backend, codec, payloads, **rx_kw):
    """Send ``payloads`` from a sender to a receiver thread; returns what
    the receiver got."""
    ep = f"tcp://127.0.0.1:{_free_port()}"
    zmq = backend == "zmq"
    sender = net.BlockSender(ep, sock_type="PUSH" if zmq else "PUB",
                             codec=codec, backend=backend)
    results = []

    def rx():
        r = net.BlockReceiver(ep, sock_type="PULL" if zmq else "SUB",
                              timeout=TIMEOUT, codec=codec, backend=backend,
                              **rx_kw)
        for _ in payloads:
            results.append(r.recv())
        r.close()

    th = threading.Thread(target=rx, daemon=True)
    th.start()
    for p in payloads:
        sender.send(p)
    th.join(timeout=TIMEOUT)
    sender.close()
    assert not th.is_alive()
    return results


@pytest.mark.parametrize("backend", ["tcp", "zmq"])
def test_net_transport_roundtrip(backend):
    _need(backend)
    payloads = [np.arange(100, dtype=np.int16),
                np.linspace(0, 1, 64).astype(np.float32)]
    results = _loopback(backend, "raw", payloads)
    assert len(results) == 2
    assert np.array_equal(results[0], payloads[0])
    assert results[0].dtype == np.int16
    assert np.array_equal(results[1], payloads[1])


def test_net_rejects_complex():
    with pytest.raises(TypeError):
        net._pack(np.zeros(4, np.complex64))


def test_tcp_receiver_may_start_before_its_sender():
    # the TCP receiver retries a refused connect until its timeout (the
    # zmq receiver's connect is lazy): start it first, then the sender
    ep = f"tcp://127.0.0.1:{_free_port()}"
    results = []

    def rx():
        r = net.BlockReceiver(ep, timeout=TIMEOUT, backend="tcp")
        results.append(r.recv())
        r.close()

    th = threading.Thread(target=rx, daemon=True)
    th.start()
    sender = net.BlockSender(ep, backend="tcp")
    sender.send(np.arange(8, dtype=np.float32))
    th.join(timeout=TIMEOUT)
    sender.close()
    assert np.array_equal(results[0], np.arange(8, dtype=np.float32))


def test_zmq_sender_closed_before_its_peer_binds_still_delivers():
    # the port's zmq sender closes with a bounded linger (the JAX
    # package's closes with none and drops what the handshake had not
    # carried yet): a receiver that binds after the close gets the block
    _need("zmq")
    ep = f"tcp://127.0.0.1:{_free_port()}"
    sender = net.BlockSender(ep, sock_type="PUSH", backend="zmq")
    sender.send(np.arange(5, dtype=np.float32))
    sender.close()
    r = net.BlockReceiver(ep, sock_type="PULL", backend="zmq",
                          timeout=TIMEOUT)
    got = r.recv()
    r.close()
    np.testing.assert_array_equal(got, np.arange(5, dtype=np.float32))


def test_tcp_receiver_gives_up_with_comm_error():
    port = _free_port()          # nothing listens there
    with pytest.raises(terr.CommError):
        net.BlockReceiver(f"tcp://127.0.0.1:{port}", timeout=0.2,
                          backend="tcp")


# ------------------------------------------------------- CBOR interop

def test_cbor_roundtrip_complex64():
    rng = np.random.default_rng(0)
    z = (rng.normal(size=300) + 1j * rng.normal(size=300)
         ).astype(np.complex64)
    out = cbor.decode_block(cbor.encode_block(z))
    assert out.dtype == np.complex64
    np.testing.assert_array_equal(out, z)


def test_cbor_roundtrip_nonfinite_complex():
    z = np.array([1 + 2j, complex(np.nan, np.inf),
                  complex(-np.inf, 0.5)], np.complex64)
    out = cbor.decode_block(cbor.encode_block(z))
    assert out.dtype == np.complex64
    np.testing.assert_array_equal(np.isnan(out.real), np.isnan(z.real))
    assert out[1].imag == np.inf and out[2].real == -np.inf
    assert out[0] == z[0] and out[2].imag == np.float32(0.5)


def test_cbor_roundtrip_int16_and_f32():
    v = np.array([0, 1, 23, 24, 255, 256, -1, -24, -25, -32768, 32767],
                 np.int16)
    out = cbor.decode_block(cbor.encode_block(v), dtype=np.int16)
    assert out.dtype == np.int16
    np.testing.assert_array_equal(out, v)
    f = np.linspace(-2, 2, 37).astype(np.float32)
    out = cbor.decode_block(cbor.encode_block(f))
    assert out.dtype == np.float32
    np.testing.assert_array_equal(out, f)


def _f32(v):
    return b"\xfa" + struct.pack(">f", v)


def test_cbor_decodes_reference_style_payload():
    payload = (b"\x82"
               + b"\x82" + _f32(1.5) + _f32(-2.0)
               + b"\x82" + _f32(0.0) + _f32(3.25))
    np.testing.assert_array_equal(
        cbor.decode_block(payload),
        np.array([1.5 - 2.0j, 3.25j], np.complex64))
    ints = b"\x85\x0a\x18\x64\x19\x7f\xff\x29\x39\x7f\xff"
    np.testing.assert_array_equal(
        cbor.decode_block(ints, dtype=np.int16),
        np.array([10, 100, 32767, -10, -32768], np.int16))
    named = b"\x81\xa2\x62re" + _f32(1.0) + b"\x62im" + _f32(-1.0)
    np.testing.assert_array_equal(cbor.decode_block(named),
                                  np.array([1 - 1j], np.complex64))


def test_cbor_encode_matches_reference_bytes():
    z = np.array([1.5 - 2.0j, 3.25j], np.complex64)
    want = (b"\x82" + b"\x82" + _f32(1.5) + _f32(-2.0)
            + b"\x82" + _f32(0.0) + _f32(3.25))
    assert cbor.encode_block(z) == want


def test_cbor_decoder_fails_closed():
    adversarial = [
        b"",
        b"\x9b" + struct.pack(">Q", 1 << 60),
        b"\x5b" + struct.pack(">Q", 1 << 60),
        b"\x81" * 100_000 + b"\x00",
        b"\xbb" + struct.pack(">Q", 1 << 40),
        b"\x82\xfa\x00",
        b"\x63\xff\xff\xff",
        b"\x1c",
        b"\xff",
        b"\x82\x00",
    ]
    for payload in adversarial:
        with pytest.raises(terr.CommError):
            cbor.decode_block(payload)
    # random bytes and every strict prefix of a valid payload: decode
    # succeeds or raises the port's CommError, nothing else
    rng = np.random.default_rng(42)
    bufs = [rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()
            for n in (1, 3, 17, 64, 257) for _ in range(40)]
    good = cbor.encode_block(np.array([1 + 2j, 3 - 4j], np.complex64))
    bufs += [good[:k] for k in range(1, len(good))]
    for buf in bufs:
        try:
            cbor.decode_block(buf)
        except terr.CommError:
            pass
    with pytest.raises(terr.CommError):
        cbor.decode_block(b"\x81" * 65 + b"\x00")
    assert cbor._decode_item(cbor._Reader(b"\x81" * 64 + b"\x00")) is not None


def test_error_taxonomy_matches_jax():
    from comms_tpu import errors as jerr

    assert terr.__all__ == jerr.__all__
    for name in terr.__all__:
        t, j = getattr(terr, name), getattr(jerr, name)
        assert [b.__name__ for b in t.__mro__] == \
            [b.__name__ for b in j.__mro__]
    assert issubclass(terr.CommError, ConnectionError)


@pytest.mark.parametrize("block", [
    (np.arange(64, dtype=np.float32)
     + 1j * np.ones(64, np.float32)).astype(np.complex64),
    np.array([1 + 2j, complex(np.nan, np.inf), complex(-np.inf, 0.5)],
             np.complex64),
    np.arange(-50, 50, dtype=np.int16),
    np.linspace(-2, 2, 37).astype(np.float32),
    np.array([0, 70000, -70000, 2 ** 31 - 1], np.int64),
])
def test_cbor_across_the_packages(block):
    # the port's bytes equal JAX's for the same array, and each package
    # decodes the other's bytes to the same array
    tb, jb = cbor.encode_block(block), jcbor.encode_block(block)
    assert tb == jb
    for dt in (None, block.dtype):
        got = cbor.decode_block(jb, dtype=dt)
        want = jcbor.decode_block(tb, dtype=dt)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("backend", ["tcp", "zmq"])
def test_net_transport_cbor_loopback(backend):
    _need(backend)
    payloads = [(np.arange(64, dtype=np.float32)
                 + 1j * np.ones(64, np.float32)).astype(np.complex64),
                np.arange(-50, 50, dtype=np.int16)]
    results = _loopback(backend, "cbor", payloads)
    assert len(results) == 2
    assert results[0].dtype == np.complex64
    np.testing.assert_array_equal(results[0], payloads[0])
    np.testing.assert_array_equal(results[1].astype(np.int16), payloads[1])


def test_tcp_raw_receiver_refuses_a_cbor_frame():
    ep = f"tcp://127.0.0.1:{_free_port()}"
    sender = net.BlockSender(ep, codec="cbor", backend="tcp")
    th = threading.Thread(
        target=lambda: sender.send(np.arange(4, dtype=np.float32)),
        daemon=True)
    th.start()
    r = net.BlockReceiver(ep, timeout=TIMEOUT, codec="raw", backend="tcp")
    with pytest.raises(terr.CommError, match="CBOR"):
        r.recv()
    r.close()
    th.join(timeout=TIMEOUT)
    sender.close()


@pytest.mark.parametrize("codec", ["raw", "cbor"])
def test_net_req_rep_roundtrip(codec):
    _need("zmq")
    ep = f"tcp://127.0.0.1:{_free_port()}"
    dt = np.float32 if codec == "cbor" else None
    rep = net.BlockReplier(ep, timeout=TIMEOUT, codec=codec, dtype=dt)
    th = threading.Thread(target=lambda: rep.serve_once(lambda b: b * 2),
                          daemon=True)
    th.start()
    req = net.BlockRequester(ep, timeout=TIMEOUT, codec=codec, dtype=dt)
    block = np.linspace(-1, 1, 32).astype(np.float32)
    out = req.ask(block)
    th.join(timeout=TIMEOUT)
    np.testing.assert_allclose(out, block * 2, atol=1e-6)
    req.close()
    rep.close()


def test_net_flags_need_zmq_backend():
    port = _free_port()
    with pytest.raises(terr.CommError):
        net.BlockSender(f"tcp://127.0.0.1:{port}", backend="tcp", flags=1)
    with pytest.raises(terr.CommError):
        net.BlockReceiver(f"tcp://127.0.0.1:{port}", backend="tcp",
                          flags=1)
    with pytest.raises(ValueError):
        net.BlockSender(f"tcp://127.0.0.1:{port}", backend="udp")
    with pytest.raises(ValueError):
        net.BlockSender(f"udp://127.0.0.1:{port}", backend="tcp")
