"""Wideband FM band monitor: channelize a capture and demodulate every
channel at once.

Counterpart of ``examples/fm_band_monitor.py``: one block of the capture
through ``models/fm_band_monitor``'s staged step (the channelizer
kernel, the demod, the decimating-FIR kernel for the audio where the
block meets their quanta on a CUDA device); each of the K channels'
audio, scaled to its peak, goes to ``fm_ch<k>.wav`` in the working
directory.

Usage: python -m comms_tpu_torch.examples.fm_band_monitor
       capture.f32pairs [K] [--device cpu]

The capture is raw float32 re/im pairs at the wideband rate.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.examples import _cli
from comms_tpu_torch.io import audio as caudio
from comms_tpu_torch.models import fm_band_monitor as fbm


def parser():
    p = _cli.parser(__doc__)
    p.add_argument("capture")
    p.add_argument("num_channels", nargs="?", type=int, default=16)
    return p


def main(argv=None) -> np.ndarray:
    """Returns the audio, [K, samples] float32."""
    args = parser().parse_args(argv)
    K = args.num_channels
    raw = np.fromfile(args.capture, dtype=np.float32).reshape(-1, 2)

    cfg = fbm.BandMonitorConfig(num_channels=K,
                                block=(len(raw) // (K * 4)) * K * 4)
    block = fbm.make_block_fn(cfg)
    x = torch.from_numpy(raw[: cfg.block]).to(args.device)
    audio, _ = block(fbm.init_state(cfg, args.device), x)
    audio = audio.cpu().numpy()

    for k in range(K):
        a = audio[k]
        peak = np.max(np.abs(a)) or 1.0
        with caudio.WavSink(f"fm_ch{k}.wav", channels=1,
                            sample_rate=44100) as sink:
            sink.write(a / peak)
    print(f"wrote {K} channel WAVs ({audio.shape[1]} samples each)")
    return audio


if __name__ == "__main__":
    main()
