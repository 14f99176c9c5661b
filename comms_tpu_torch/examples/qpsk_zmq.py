"""QPSK over the network transport (two processes).

Counterpart of ``examples/qpsk_zmq.py``, in parity with the reference's
``examples/qpsk_zmq.rs``: the sender makes QPSK sample blocks on the
device and pushes them over a socket; the receiver deserializes them and
reports.  The transport is zmq where ``pyzmq`` is installed, else plain
TCP (``io/net``).

Usage:
  python -m comms_tpu_torch.examples.qpsk_zmq recv tcp://127.0.0.1:5556 [blocks] [codec] &
  python -m comms_tpu_torch.examples.qpsk_zmq send tcp://127.0.0.1:5556 [blocks] [codec] [--device cpu]

Codec "cbor" speaks the reference's serde_cbor wire format, so "send"
can feed a comms-rs ZMQRecv (and "recv" take a ZMQSend) directly.
"""

from __future__ import annotations

from comms_tpu_torch.examples import _cli
from comms_tpu_torch.models import qpsk_stream


def parser():
    p = _cli.parser(__doc__)
    p.add_argument("role", choices=("send", "recv"))
    p.add_argument("endpoint")
    p.add_argument("blocks", nargs="?", type=int, default=10)
    p.add_argument("codec", nargs="?", default="raw",
                   choices=("raw", "cbor"))
    return p


def main(argv=None):
    """Returns the samples sent ("send") or the received blocks, complex64
    numpy arrays ("recv", which runs on the host)."""
    args = parser().parse_args(argv)
    if args.role == "send":
        n = qpsk_stream.stream_blocks(args.endpoint, args.blocks,
                                      codec=args.codec, device=args.device)
        print(f"sent {n} samples")
        return n
    got = qpsk_stream.receive_blocks(args.endpoint, args.blocks,
                                     codec=args.codec)
    print(f"received {sum(len(b) for b in got)} samples "
          f"in {len(got)} blocks")
    return got


if __name__ == "__main__":
    main()
