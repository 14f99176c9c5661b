"""Automatic gain control.

Counterpart of :mod:`comms_tpu.ops.agc`.  Two forms:

* :func:`agc_block` — feedforward block AGC: one gain per block from the
  block's RMS, smoothed across blocks with a one-pole carried state.
  Two reductions, plain PyTorch.
* :func:`agc_scan` — the per-sample loop AGC (log-domain error): on CUDA
  tensors one launch of the recurrence kernel (``kernels.recurrence``)
  walks the block, on CPU tensors its plain version does.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import recurrence as _rec

__all__ = ["agc_init", "agc_block", "agc_scan"]


def agc_init(gain: float = 1.0, device="cuda"):
    """Carried smoothed gain (float32 0-d tensor on ``device``)."""
    return torch.tensor(float(np.float32(gain)), dtype=torch.float32,
                        device=device)


def agc_block(x, gain, target_rms: float = 1.0, alpha: float = 0.5,
              eps: float = 1e-12):
    """Feedforward AGC over one block.

    ``g_block = target / rms(x)``; the carried gain is the one-pole
    smoothing ``g' = (1-alpha) * g + alpha * g_block``; the block is
    scaled by the smoothed gain.  Returns ``(y, g')``."""
    rms = torch.sqrt(torch.mean(x.abs() ** 2) + eps)
    g_blk = float(np.float32(target_rms)) / rms.to(torch.float32)
    g = (1.0 - alpha) * gain + alpha * g_blk
    return x * g.to(x.real.dtype), g


def agc_scan(x, gain, target_rms: float = 1.0, rate: float = 1e-2):
    """Per-sample log-domain AGC: ``g *= exp(rate * log(target/|y|))``,
    ``y = x * g``, over a complex64 block.  Returns ``(y, final_gain)``."""
    if x.dtype != torch.complex64:
        raise ValueError(f"x must be complex64, got {x.dtype}")
    v = torch.view_as_real(x)
    g = torch.as_tensor(gain, dtype=torch.float32, device=x.device)
    yr, yi, g = _rec.agc_scan(v[:, 0], v[:, 1], g, target_rms, rate)
    return torch.complex(yr, yi), g
