"""Batched multi-stream FM serving: B radio clients a round.

Counterpart of ``examples/multi_stream_serving.py``.  The reference
serves N independent flowgraphs as N thread sets (its
``src/node/mod.rs:275-284``); here one ``BatchedStreamRunner`` round
(``mode="unroll"``, bit-identical to B separate runs) carries a block of
every stream.  On a CUDA device each block runs the fused FM chain (the
FM kernel) at 16 x 102,400 samples; elsewhere the tensor chain at
102,400 samples.

Usage: python -m comms_tpu_torch.examples.multi_stream_serving
       cap1.u8 [cap2.u8 ...] [--device cpu]
       (each capture is raw interleaved u8 IQ; each gets its own
        receiver state and its own WAV output, <capture>.wav)
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.examples import _cli
from comms_tpu_torch.io import audio as caudio
from comms_tpu_torch.models import fm_receiver
from comms_tpu_torch.runtime import BatchedStreamRunner


def parser():
    p = _cli.parser(__doc__)
    p.add_argument("captures", nargs="+")
    return p


def _blocks(path, block):
    """Per-stream source: planar u8 blocks from an interleaved file
    (the rounds stop at the shortest capture)."""
    raw = np.fromfile(path, dtype=np.uint8)
    raw = raw[: 2 * (raw.size // 2)].reshape(-1, 2)
    if raw.shape[0] < block:
        raise SystemExit(f"{path}: shorter than one block ({block})")
    for b in range(raw.shape[0] // block):
        seg = raw[b * block:(b + 1) * block]
        yield (np.ascontiguousarray(seg[:, 0]),
               np.ascontiguousarray(seg[:, 1]))


def main(argv=None):
    """Returns the runner's ThroughputMeter."""
    args = parser().parse_args(argv)
    paths = args.captures
    device = torch.device(args.device)
    on_cuda = device.type == "cuda"
    block = (16 * fm_receiver.FUSED_BLOCK_QUANTUM if on_cuda
             else 25 * 4096)
    cfg = fm_receiver.FmReceiverConfig(block=block)
    if on_cuda:                      # the fused chain (the FM kernel)
        fblk = fm_receiver.make_fused_block_fn(cfg)

        def step(st, x):
            return fblk(st, x[0], x[1])
        states = [fm_receiver.fused_init_state(device) for _ in paths]
    else:                            # the tensor chain (same semantics)
        blk = fm_receiver.make_block_fn(cfg)

        def step(st, x):
            return blk(st, torch.stack(x, dim=-1))
        states = [fm_receiver.init_state(cfg, device) for _ in paths]

    sinks = [caudio.WavSink(p + ".wav", channels=1, sample_rate=45600)
             for p in paths]
    try:
        runner = BatchedStreamRunner(
            step, states,
            sources=[_blocks(p, block) for p in paths],
            sinks=[(lambda a, s=s: s.write(
                a / (np.max(np.abs(a)) or 1.0))) for s in sinks],
            depth=4, mode="unroll", device=device)
        meter = runner.run()
        print(meter)
        for p in paths:
            print(f"{p} -> {p}.wav")
    finally:
        for s in sinks:
            s.close()
    return meter


if __name__ == "__main__":
    main()
