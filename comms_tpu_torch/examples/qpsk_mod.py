"""QPSK transmit chain -> qpsk_out.bin.

Counterpart of ``examples/qpsk_mod.py``, in parity with the reference's
``examples/single_thread_qpsk.rs`` (random bits -> QPSK -> RRC -> x8192
-> i16 IQ file), with the mixer's optional upconversion (``dphase``), on
``models/qpsk_tx``.  The file's bytes equal the JAX package's.

Usage: python -m comms_tpu_torch.examples.qpsk_mod [num_blocks]
       [out_path] [dphase] [--device cpu]
"""

from __future__ import annotations

from comms_tpu_torch.examples import _cli
from comms_tpu_torch.models import qpsk_tx


def parser():
    p = _cli.parser(__doc__)
    p.add_argument("num_blocks", nargs="?", type=int, default=10)
    p.add_argument("out", nargs="?", default="qpsk_out.bin")
    p.add_argument("dphase", nargs="?", type=float, default=0.0)
    return p


def main(argv=None) -> int:
    """Returns the samples written."""
    args = parser().parse_args(argv)
    cfg = qpsk_tx.QpskTxConfig(dphase=args.dphase)
    n = qpsk_tx.run_to_file(args.out, args.num_blocks, cfg,
                            device=args.device)
    print(f"wrote {n} samples to {args.out}")
    return n


if __name__ == "__main__":
    main()
