"""Weak-scaling harness: samples/s at 1..N shards of the sharded chain.

Counterpart of :mod:`comms_tpu.parallel.scaling`: the sharded wideband
chain (:mod:`.wideband`) at a fixed per-shard block over growing meshes,
throughput and efficiency against the smallest mesh.  The port's mesh is
in-process: on a machine with one card every shard of the mesh shares
it, so the record measures how the shards contend for the one card, not
how the chain scales across cards (the JAX harness says the same of its
virtual CPU mesh).  Times are host clocks around work that ends in a
device synchronisation.

    python -m comms_tpu_torch.parallel.scaling [--out FILE] [--device D]
"""

from __future__ import annotations

import time
from typing import Optional, Sequence

import numpy as np
import torch

from comms_tpu_torch.parallel import sharding as sh
from comms_tpu_torch.parallel import wideband

__all__ = ["weak_scaling", "main"]


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def weak_scaling(taps, per_shard: int = 1 << 20,
                 shard_counts: Optional[Sequence[int]] = None,
                 iters: int = 10, reps: int = 3,
                 device="cuda") -> list[dict]:
    """Run the sharded wideband chain at each shard count with constant
    per-shard work.  Returns one record per mesh size with Gsps and the
    efficiency against the first mesh."""
    if shard_counts is None:
        shard_counts = (1, 2, 4, 8)
    results = []
    base = None
    for n in shard_counts:
        mesh = sh.time_mesh(n, device=device)
        block = per_shard * n
        cfg = wideband.WidebandConfig(taps, block=block, dec1=5, dec2=5)
        step = wideband.make_sharded_step(cfg, mesh)
        state = wideband.init_state(cfg, device=device)
        rng = np.random.default_rng(0)
        pairs = torch.from_numpy(
            rng.normal(size=(block, 2)).astype(np.float32)).to(device)

        (audio, freq), state = step(state, pairs)
        _sync(device)
        best = float("inf")
        for _ in range(reps):
            t0 = time.perf_counter()
            s = state
            for _ in range(iters):
                (audio, freq), s = step(s, pairs)
            _sync(device)
            best = min(best, (time.perf_counter() - t0) / iters)
        gsps = block / best / 1e9
        per_shard_gsps = gsps / n
        if base is None:
            base = per_shard_gsps
        results.append({"shards": n, "block": block, "gsps": gsps,
                        "per_shard_gsps": per_shard_gsps,
                        "efficiency": per_shard_gsps / base})
    return results


def main(argv=None):
    """One-command weak-scaling run; prints one JSON record per mesh and,
    with ``--out``, writes the artifact labelled with its device."""
    import argparse
    import json

    from comms_tpu_torch.models.fm_receiver import FM_LPF_TAPS

    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default=None, help="write JSON artifact here")
    ap.add_argument("--per-shard", type=int, default=102400)  # % 25 == 0
    ap.add_argument("--iters", type=int, default=3)
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = torch.device(args.device)
    kind = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu")
    results = weak_scaling(FM_LPF_TAPS, per_shard=args.per_shard,
                           iters=args.iters, reps=args.reps,
                           device=args.device)
    artifact = {
        "device": str(dev), "device_kind": kind,
        "per_shard": args.per_shard,
        "note": ("IN-PROCESS MESH: every shard shares the one "
                 f"{kind}; 'efficiency' measures how the shards contend "
                 "for it (expect ~1/shards where one shard fills the "
                 "device), not halo overhead across cards"),
        "results": results,
    }
    for rec in results:
        print(json.dumps(rec))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(artifact, f, indent=1)
        print(f"wrote {args.out}")


if __name__ == "__main__":
    main()
