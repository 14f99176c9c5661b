"""Served path: the FM receiver on the composable runtime,
``fm_receiver.make_pipeline()`` (``pipe.step``): the u8 convert, a
``FirDecimate`` on K2, ``FmDemod(fast=True)``, a second ``FirDecimate``
on K2.  A block is the recording's u8 [N, 2]; its output the audio
[N/25]."""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.models import fm_receiver as fm
from comms_tpu_torch.runtime import block as rb


class Served:
    def __init__(self, cfg: dict, device):
        self.device = device
        self.cfg = fm.FmReceiverConfig(block=cfg["block_samples"],
                                       dec1=cfg["dec1"], dec2=cfg["dec2"])
        if device.type == "cuda":
            _build.load()
        self.samples = self.cfg.block
        self.pipe = fm.make_pipeline(self.cfg)
        self.step = self.pipe.step

    def init_state(self):
        return self.pipe.init_state(device=self.device)

    @staticmethod
    def item(ring: dict, i: int):
        return ring["iq"][i]

    def launches(self) -> list:
        """K2 once for each FirDecimate whose block takes the kernel."""
        out = []
        n, dtype = self.cfg.block, torch.uint8
        for op in self.pipe.ops:
            if isinstance(op, rb.FirDecimate):
                taps = op._taps_np        # the dtype the op was made with
                real = not np.iscomplexobj(taps) or not np.any(taps.imag)
                if rb.takes_kernel(dtype, n, taps.real if real else taps,
                                   op.dec):
                    out.append(("k2", dict(
                        rows=1, n=n, dec=op.dec, taps=taps.shape[0],
                        planes=2 if dtype.is_complex else 1,
                        complex_taps=not real, ctx=op.halo)))
                n //= op.dec
            dtype = op.out_dtype(dtype)
        return out
