"""QPSK over the network transport: the ``qpsk_zmq`` example.

Counterpart of :mod:`comms_tpu.models.qpsk_stream`, with chain parity
with the reference's ``examples/qpsk_zmq.rs:33-70``: bits -> QPSK
symbols -> zero-stuff x4 -> RRC(32, 4, 0.25) -> PUSH socket; a peer
process receives and deserializes.  The transmitter is the port's
:func:`comms_tpu_torch.models.qpsk_tx.make_block_fn` on ``device``
(the card by default); each block is read back to the host and sent.
Blocks default to framed float32 re/im pairs
(:mod:`comms_tpu_torch.io.net`), which a receiver turns back into
complex with ``host_pairs_to_complex``; ``codec="cbor"`` speaks the
reference's wire format (complex64 blocks, serde_cbor packed layout).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from comms_tpu_torch.io import net
from comms_tpu_torch.models import qpsk_tx
from comms_tpu_torch.runtime import boundary

__all__ = ["stream_blocks", "receive_blocks"]


def stream_blocks(endpoint: str, num_blocks: int,
                  cfg: Optional[qpsk_tx.QpskTxConfig] = None,
                  seed: int = 0, sock_type: str = "PUSH",
                  backend: str | None = None,
                  codec: str = "raw", device="cuda") -> int:
    """Generate QPSK sample blocks on ``device`` and send them over
    ``endpoint``.  With ``codec="raw"`` blocks are sent as flat float32
    re/im pairs (the i16 output rescaled by 1/scale, the reference's
    pre-quantization Complex<f32> payload); ``codec="cbor"`` sends
    complex64 blocks in the reference's serde_cbor wire format.  Returns
    samples sent."""
    cfg = cfg or qpsk_tx.QpskTxConfig()
    block = qpsk_tx.make_block_fn(cfg)
    state = qpsk_tx.init_state(cfg, seed, device)
    sender = net.BlockSender(endpoint, sock_type=sock_type,
                             backend=backend, codec=codec)
    sent = 0
    try:
        for _ in range(num_blocks):
            iq, state = block(state)
            pairs = iq.cpu().numpy().astype(np.float32) / cfg.scale
            if codec == "cbor":
                z = (pairs[:, 0] + 1j * pairs[:, 1]).astype(np.complex64)
                sender.send(z)              # wire: Vec<Complex<f32>>
            else:
                sender.send(pairs.reshape(-1))  # wire: flat f32 pairs
            sent += pairs.shape[0]
    finally:
        sender.close()
    return sent


def receive_blocks(endpoint: str, num_blocks: int,
                   sock_type: str = "PULL", timeout: float = 30.0,
                   backend: str | None = None, codec: str = "raw"):
    """Receive QPSK blocks; returns a list of complex64 numpy arrays."""
    rx = net.BlockReceiver(endpoint, sock_type=sock_type,
                           timeout=timeout, backend=backend,
                           codec=codec)
    out = []
    try:
        for _ in range(num_blocks):
            blk = rx.recv()
            if codec == "cbor":
                out.append(np.asarray(blk, np.complex64))
            else:
                out.append(boundary.host_pairs_to_complex(
                    blk.reshape(-1, 2)))
    finally:
        rx.close()
    return out
