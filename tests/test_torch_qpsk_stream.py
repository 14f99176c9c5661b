"""The port's QPSK network loopback against the JAX package's (mirrors
tests/test_models.py's raw and CBOR loopbacks): ``stream_blocks`` sends
the port's QPSK transmitter blocks (the pair path, on the CPU here) to
``receive_blocks`` in a thread, over each backend and codec; the blocks
received equal the transmitter's own output and, bit for bit, the blocks
the JAX package's loopback receives from the same seed (its
transmitter's output, which its loopback tests hold equal to what it
receives; at these 256-bit blocks no sample shows the pair path's 1-LSB
difference from JAX that tests/test_torch_tx.py allows).  The sender
and the receiver start together in threads: the port's TCP receiver
waits for the sender to bind, and its zmq sender lingers for blocks sent
before the handshake completed.

Ports come from the OS, the receiver runs in a thread with a timeout;
the zmq backend's cases skip, inside the test, where pyzmq is not
importable."""

import socket
import threading

import numpy as np
import pytest

from comms_tpu.models import qpsk_tx as jtx
from comms_tpu_torch.io import net
from comms_tpu_torch.models import qpsk_stream as tqs
from comms_tpu_torch.models import qpsk_tx as ttx

TIMEOUT = 30
BITS = 256
SEED = 5


def _free_port() -> int:
    """A port the OS hands out, outside 57400-57499, where the JAX
    package's transport tests bind fixed ports (they may run alongside)."""
    while True:
        with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
            s.bind(("127.0.0.1", 0))
            port = s.getsockname()[1]
        if not 57400 <= port <= 57499:
            return port


def _loop(codec, backend, nblk):
    """``stream_blocks`` to ``receive_blocks``, each in a thread joined
    with a timeout; returns (samples sent, blocks received, config)."""
    ep = f"tcp://127.0.0.1:{_free_port()}"
    cfg = ttx.QpskTxConfig(bits_per_block=BITS)
    results, sent = [], []

    def tx():
        sent.append(tqs.stream_blocks(ep, nblk, cfg, seed=SEED, codec=codec,
                                      backend=backend, device="cpu"))

    def rx():
        results.extend(tqs.receive_blocks(ep, nblk, codec=codec,
                                          backend=backend, timeout=TIMEOUT))

    threads = [threading.Thread(target=f, daemon=True) for f in (tx, rx)]
    for th in threads:
        th.start()
    for th in threads:
        th.join(timeout=TIMEOUT)
        assert not th.is_alive()
    return sent[0], results, cfg


def _jax_blocks(nblk):
    """The blocks the JAX package's loopback receives from SEED: its
    transmitter's output as pairs / scale, which its own loopback tests
    (tests/test_models.py:174, :200) hold equal to what it receives.  Its
    loopback is not run here: its zmq sender closes with no linger, so it
    can drop blocks sent before the handshake completes, and its TCP
    receiver fails if it connects before the sender binds."""
    cfg = jtx.QpskTxConfig(bits_per_block=BITS)
    block, st = jtx.make_block_fn(cfg), jtx.init_state(cfg, SEED)
    out = []
    for _ in range(nblk):
        iq, st = block(st)
        z = np.asarray(iq).astype(np.float32) / cfg.scale
        out.append((z[:, 0] + 1j * z[:, 1]).astype(np.complex64))
    return out


@pytest.mark.parametrize("backend", ["tcp", "zmq"])
@pytest.mark.parametrize("codec", ["raw", "cbor"])
def test_qpsk_stream_loopback_matches_jax(codec, backend):
    if backend == "zmq" and not net.HAVE_ZMQ:
        pytest.skip("pyzmq is not importable")
    sent, got, cfg = _loop(codec, backend, 2)
    assert sent == 2 * (BITS // 2) * 4
    assert len(got) == 2 and all(b.dtype == np.complex64 for b in got)
    # payload parity with the port's transmitter run directly
    block = ttx.make_block_fn(cfg)
    st = ttx.init_state(cfg, SEED, "cpu")
    for g in got:
        iq, st = block(st)
        z = iq.numpy().astype(np.float32) / cfg.scale
        np.testing.assert_array_equal(
            g, (z[:, 0] + 1j * z[:, 1]).astype(np.complex64))
    # the JAX package's blocks from the same seed, bit for bit
    for g, w in zip(got, _jax_blocks(2)):
        np.testing.assert_array_equal(g, w)


def test_stream_blocks_rejects_a_bad_codec():
    with pytest.raises(ValueError, match="codec"):
        tqs.stream_blocks(f"tcp://127.0.0.1:{_free_port()}", 1,
                          ttx.QpskTxConfig(bits_per_block=BITS),
                          codec="json", backend="tcp", device="cpu")
