"""Polyphase channelizer demo (64 channels by default).

Counterpart of ``examples/channelizer_demo.py``: a multi-tone test
signal through ``models/channelizer`` (on the channelizer kernel on a
CUDA device), then the per-channel power map: each tone lands in its own
channel.

Usage: python -m comms_tpu_torch.examples.channelizer_demo
       [num_channels] [--device cpu]
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.examples import _cli
from comms_tpu_torch.models import channelizer


def parser():
    p = _cli.parser(__doc__)
    p.add_argument("num_channels", nargs="?", type=int, default=64)
    return p


def main(argv=None):
    """Returns ``(tones, detected)``, both sorted channel lists."""
    args = parser().parse_args(argv)
    K = args.num_channels
    cfg = channelizer.ChannelizerConfig(num_channels=K, block=K * 2048)
    block = channelizer.make_block_fn(cfg)
    state = channelizer.init_state(cfg, args.device)

    n = np.arange(cfg.block)
    tones = [3, K // 2, K - 5]
    x = sum(np.exp(2j * np.pi * c * n / K) for c in tones)
    pairs = np.stack([x.real, x.imag], -1).astype(np.float32)

    yp, state = block(state, torch.from_numpy(pairs).to(args.device))
    yp = yp.cpu().numpy()
    power = (yp[..., 0] ** 2 + yp[..., 1] ** 2).mean(axis=0)
    top = sorted(np.argsort(power)[-len(tones):].tolist())
    print(f"tones at channels {sorted(tones)}; detected {top}")
    return sorted(tones), top


if __name__ == "__main__":
    main()
