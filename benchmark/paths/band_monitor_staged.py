"""Served path: the staged band monitor, ``fm_band_monitor.
make_planar_block_fn`` (K8, the channel-major [K, frames] demod as
tensor operations, K2 on the audio), the step the fm_band_monitor
example runs.  A block is a pair of float32 planes; its output is the
audio [K, N/K/D]."""

from __future__ import annotations

import numpy as np

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.models import fm_band_monitor as bm


class Served:
    def __init__(self, cfg: dict, device):
        self.device = device
        K, D = cfg["num_channels"], cfg["audio_dec"]
        self.cfg = bm.BandMonitorConfig(
            num_channels=K, taps_per_branch=cfg["taps_per_branch"],
            block=cfg["block_samples"], audio_dec=D,
            audio_taps=np.asarray(cfg["audio_taps"], np.float64))
        if device.type == "cuda":
            _build.load()
        self.samples = self.cfg.block
        self.step_planes = bm.make_planar_block_fn(self.cfg)

    def step(self, state, x):
        return self.step_planes(state, *x)

    def init_state(self):
        return bm.init_state(self.cfg, self.device)

    @staticmethod
    def item(ring: dict, i: int):
        return ring["re"][i], ring["im"][i]

    def launches(self) -> list:
        """The port's kernel launches a block, with their shapes."""
        c = self.cfg
        K, M, D = c.num_channels, c.taps_per_branch, c.audio_dec
        T = c.audio_taps.shape[0]
        md = D * -(-T // D)
        return [("k8", dict(n=c.block, k=K, taps_per_branch=M,
                            ctx=K * M - 1)),
                ("k2", dict(rows=K // 2, n=c.frames_per_block, dec=D,
                            taps=T, planes=2, ctx=md - 1))]
