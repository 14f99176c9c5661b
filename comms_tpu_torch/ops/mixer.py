"""Carrier de-rotation by a frequency held in a tensor.

Counterpart of ``derotate_traced`` / ``derotate_traced_planar`` of
:mod:`comms_tpu.ops.mixer` (the rest of that module comes with the
transmit slice).  ``y[k] = x[k] * exp(-j*(phase0 + freq*k))`` where
``freq`` is an estimate on the device: cos/sin are taken on two small
vectors, a row angle ``freq*128*r + phase0`` for r < ceil(N/128) and a
column angle ``freq*s`` for s < 128, and combined on [R, 128] planes by
the angle-addition identity.  The split and its float32 rounding are
the JAX package's, operation for operation, so the tests can hold the
two to 1e-6.
"""

from __future__ import annotations

import torch

__all__ = ["derotate_traced", "derotate_traced_planar", "scalar"]


def scalar(v, device) -> torch.Tensor:
    """``v`` as a 0-d float32 tensor on ``device``: a tensor is cast in
    place, a number is written by a fill kernel (no host-to-device copy,
    which would synchronise)."""
    if isinstance(v, torch.Tensor):
        return v.to(device=device, dtype=torch.float32)
    return torch.full((), float(v), dtype=torch.float32, device=device)


def derotate_traced_planar(xr, xi, freq, phase0=0.0):
    """``(yr, yi)`` = planes of ``(xr + j*xi) * exp(-j*(phase0 +
    freq*k))``; ``freq`` and ``phase0`` are numbers or 0-d tensors on
    the planes' device (they stay there: nothing is read on the
    host)."""
    n = xr.shape[0]
    R = -(-n // 128)
    pad = R * 128 - n
    dev = xr.device
    freq = scalar(freq, dev)
    phase0 = scalar(phase0, dev)
    a = (freq * 128.0 * torch.arange(R, dtype=torch.float32, device=dev)
         + phase0)
    b = freq * torch.arange(128, dtype=torch.float32, device=dev)
    ca, sa = torch.cos(a)[:, None], torch.sin(a)[:, None]
    cb, sb = torch.cos(b)[None, :], torch.sin(b)[None, :]
    c = ca * cb - sa * sb               # cos(phase0 + freq*k)
    s = sa * cb + ca * sb               # sin(phase0 + freq*k)
    x2r = torch.nn.functional.pad(xr, (0, pad)).reshape(R, 128)
    x2i = torch.nn.functional.pad(xi, (0, pad)).reshape(R, 128)
    yr = x2r * c + x2i * s              # x * (c - j*s)
    yi = x2i * c - x2r * s
    return yr.reshape(-1)[:n], yi.reshape(-1)[:n]


def derotate_traced(x, freq, phase0=0.0):
    """Complex form of :func:`derotate_traced_planar`."""
    yr, yi = derotate_traced_planar(x.real.contiguous(),
                                    x.imag.contiguous(), freq, phase0)
    return torch.complex(yr, yi)
