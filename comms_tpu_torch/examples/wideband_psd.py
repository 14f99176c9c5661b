"""Wideband spectral monitor: one Welch PSD of 2^16 bins (by default)
computed over an 8-shard mesh, its frequency axis sharded end to end
(``parallel/wideband.make_sharded_psd``, the distributed FFT's
consumer).

Counterpart of ``examples/wideband_psd.py``.  The reference's only
spectral tool is a single-thread FFT node (its ``src/fft/mod.rs:73-96``).
The mesh's 8 shards share the one device (``sharding.time_mesh(8,
device=...)``); the JAX script's ``--native`` switch and its virtual
8-device CPU platform have no counterpart.  Prints the top-power bins of
a synthetic three-carrier band and checks them.

Usage: python -m comms_tpu_torch.examples.wideband_psd [fft_size_log2]
       [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.examples import _cli
from comms_tpu_torch.parallel import sharding as sh
from comms_tpu_torch.parallel import wideband

SHARDS = 8
CARRIERS = (0.11, 0.37, 0.68)          # fractions of fs


def parser():
    p = _cli.parser(__doc__)
    p.add_argument("fft_size_log2", nargs="?", type=int, default=16)
    return p


def main(argv=None):
    """Returns the recovered carrier bins (sorted)."""
    args = parser().parse_args(argv)
    F, B = 1 << args.fft_size_log2, 4
    mesh = sh.time_mesh(SHARDS, device=args.device)
    psd_fn = wideband.make_sharded_psd(F, mesh)

    # three carriers plus noise across the band.
    rng = np.random.default_rng(0)
    t = np.arange(B * F)
    x = sum(np.exp(2j * np.pi * f * t) for f in CARRIERS)
    x = (x + 0.1 * (rng.normal(size=B * F) + 1j * rng.normal(size=B * F))
         ).astype(np.complex64)
    pairs = np.stack([x.real, x.imag], -1).reshape(B, F, 2)

    psd = psd_fn(torch.from_numpy(pairs).to(args.device)).cpu().numpy()
    top = sorted(np.argsort(psd)[-len(CARRIERS):].tolist())
    print(f"{F}-bin PSD over {mesh.axis_size('time')} shards; "
          f"top bins: {top}")
    expect = sorted(int(round(f * F)) for f in CARRIERS)
    if top != expect:
        raise SystemExit(f"carriers not recovered: {top} != {expect}")
    print(f"carriers recovered at bins {expect} — OK")
    return top


if __name__ == "__main__":
    main()
