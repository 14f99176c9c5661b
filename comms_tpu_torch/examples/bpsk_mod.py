"""BPSK transmit chain -> bpsk_out.bin.

Counterpart of ``examples/bpsk_mod.py``, in parity with the reference's
``examples/bpsk_mod.rs`` and ``single_thread_bpsk.rs`` (random bits ->
BPSK -> RRC(32, sps 4, 0.25) -> x8192 -> i16 IQ file), on
``models/bpsk_tx``.  The file's bytes equal the JAX package's.

Usage: python -m comms_tpu_torch.examples.bpsk_mod [num_blocks]
       [out_path] [--device cpu]
"""

from __future__ import annotations

from comms_tpu_torch.examples import _cli
from comms_tpu_torch.models import bpsk_tx


def parser():
    p = _cli.parser(__doc__)
    p.add_argument("num_blocks", nargs="?", type=int, default=10)
    p.add_argument("out", nargs="?", default="bpsk_out.bin")
    return p


def main(argv=None) -> int:
    """Returns the samples written."""
    args = parser().parse_args(argv)
    n = bpsk_tx.run_to_file(args.out, args.num_blocks, device=args.device)
    print(f"wrote {n} samples to {args.out}")
    return n


if __name__ == "__main__":
    main()
