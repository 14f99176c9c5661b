"""Sharded fused FM chain demo: the single-kernel FM receiver on every
shard of a mesh, bit-identical to the sequential stream.

Counterpart of ``examples/fused_sharded_fm.py``: the whole-graph
concurrency of the reference (its ``src/node/mod.rs:275-284``) over
shards.  Each shard runs the complete chain (the FM kernel on a CUDA
device) on its time slice; one ring exchange of the raw u8 tail per
boundary (the ring halo kernel) is the only communication
(``parallel/fused_wideband``).  The shards share the one device
(``sharding.time_mesh(n, device=...)``); the JAX script's ``--native``
switch and its virtual 8-device CPU platform have no counterpart.  The
result is checked bit for bit against the same stream through the
one-device fused step.

Usage: python -m comms_tpu_torch.examples.fused_sharded_fm [n_shards]
       [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.examples import _cli
from comms_tpu_torch.kernels import fm_chain as K
from comms_tpu_torch.models import fm_receiver
from comms_tpu_torch.parallel import fused_wideband
from comms_tpu_torch.parallel import sharding as sh


def parser():
    p = _cli.parser(__doc__)
    p.add_argument("n_shards", nargs="?", type=int, default=8)
    return p


def main(argv=None) -> bool:
    """Returns whether the sharded audio equals the sequential stream's
    (it raises SystemExit where it does not)."""
    args = parser().parse_args(argv)
    n, dev = args.n_shards, args.device
    per_shard = K.IN_PER_STEP
    N = n * per_shard

    mesh = sh.time_mesh(n, device=dev)
    step = fused_wideband.make_sharded_fused_step(mesh, block=N)

    rng = np.random.default_rng(0)
    re = torch.from_numpy(rng.integers(0, 256, size=N, dtype=np.uint8))
    im = torch.from_numpy(rng.integers(0, 256, size=N, dtype=np.uint8))
    re, im = re.to(dev), im.to(dev)
    audio, _ = step(fm_receiver.fused_init_state(dev), re, im)
    print(f"{n} shards x {per_shard} samples -> {audio.shape[0]} "
          f"audio samples")

    # the sequential oracle: the same stream through the fused block step
    cfg = fm_receiver.FmReceiverConfig(block=per_shard)
    blk = fm_receiver.make_fused_block_fn(cfg)
    st = fm_receiver.fused_init_state(dev)
    chunks = []
    for b in range(n):
        a, st = blk(st, re[b * per_shard:(b + 1) * per_shard],
                    im[b * per_shard:(b + 1) * per_shard])
        chunks.append(a)
    exact = torch.equal(audio, torch.cat(chunks))
    print(f"sharded == sequential stream: {'BIT-EXACT' if exact else 'NO'}")
    if not exact:
        raise SystemExit("the sharded stream differs from the sequential one")
    return exact


if __name__ == "__main__":
    main()
