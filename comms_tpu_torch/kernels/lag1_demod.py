"""The staged band monitor's lag-1 FM demod: one CUDA kernel, and its
plain version.

    yr, yi [F, K] frame-major, prev [K, 2]
      -> d [K, F] channel-major, d[k, j] = arg(y[j, k] * conj(y[j-1, k])),
         y[-1] = prev; and the next prev, frame F - 1

It sits between the channelizer (K8), whose frame-major planes it reads,
and the decimating FIR (K2), whose one launch reads ``d[:K/2]`` and
``d[K/2:]`` as the re and im planes of K/2 rows.  It replaces no TPU
kernel: the JAX package's staged demod
(``comms_tpu/models/fm_band_monitor.py::_planar_core``) is plain jnp.

The kernel, ``csrc/lag1_demod.cu``, reads 8 bytes and writes 4 a sample,
so device memory bounds it; each block takes 4096 samples (4096/K frames
by every channel), with the frame before them as its halo, and writes
them channel-major through a shared transpose.  The products are rounded
as the plain version rounds them (the signs of zero products at stream
start match); the polynomial atan2 (``csrc/atan2_poly.cuh``) contracts to
FMAs, so d differs from plain by a few ulp of pi.  ``fast=False`` takes
CUDA's ``atan2f`` there, which is what ``torch.atan2`` computes.  The
source's header says more.

:func:`lag1_demod` launches the kernel for CUDA tensors and runs
:func:`lag1_demod_plain` for CPU tensors; any other device raises.  It
never falls back: a CUDA tensor gets the kernel or an exception.
``launches`` counts the kernel launches (not the plain runs).
"""

from __future__ import annotations

import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.ops import demodulation as _demod
from comms_tpu_torch.runtime.metrics import scoped

__all__ = ["lag1_demod", "lag1_demod_plain"]

_MAX_K = 128

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


def _check_shapes(yr, yi, prev):
    """(frames, channels) of the planes, after the checks that either
    route needs: float32 tensors, [F, K] planes and a [K, 2] prev, all on
    one device."""
    for name, p in (("yr", yr), ("yi", yi), ("prev", prev)):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(p)}")
        if p.dtype != torch.float32:
            raise ValueError(f"{name} must be float32, got {p.dtype}")
        if p.device != yr.device:
            raise ValueError(f"{name} is on {p.device}, yr on {yr.device}")
    if yr.ndim != 2 or yr.shape != yi.shape or yr.shape[0] < 1:
        raise ValueError(f"yr and yi must share a shape [frames, K], got "
                         f"{tuple(yr.shape)} and {tuple(yi.shape)}")
    F, K = yr.shape
    if tuple(prev.shape) != (K, 2):
        raise ValueError(f"prev must be [{K}, 2], got {tuple(prev.shape)}")
    return F, K


@scoped("kernel.lag1_demod")
def lag1_demod(yr, yi, prev, fast: bool = True):
    """Lag-1 FM demod of every channel of a channelized block.

    Args:
      yr, yi: [F, K] float32 frame-major planes (the channelizer's
        output), contiguous; K a power of two dividing 128.
      prev: [K, 2] float32 (re, im) of the frame before the block (zeros
        at stream start), contiguous.
      fast: the polynomial atan2 (default); False: the exact one.

    Returns ``(d[K, F], next_prev[K, 2])``, d channel-major and
    contiguous.  On a CUDA device one launch writes both, on the current
    stream, and is not waited for.
    """
    global launches
    F, K = _check_shapes(yr, yi, prev)
    for name, p in (("yr", yr), ("yi", yi), ("prev", prev)):
        if not p.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if K > _MAX_K or K & (K - 1):
        raise ValueError(f"K {K} must be a power of two dividing "
                         f"{_MAX_K}")
    dev = yr.device
    if dev.type == "cpu":
        return _plain(yr, yi, prev, fast)
    if dev.type != "cuda":
        raise ValueError(f"lag1_demod runs on CUDA or CPU tensors, got "
                         f"{dev}")
    lib = _build.load()
    d = torch.empty((K, F), dtype=torch.float32, device=dev)
    nprev = torch.empty((K, 2), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.lag1_demod_launch(
            yr.data_ptr(), yi.data_ptr(), prev.data_ptr(), F, K, int(fast),
            d.data_ptr(), nprev.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"lag1 demod kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return d, nprev


def lag1_demod_plain(yr, yi, prev, fast: bool = True):
    """:func:`lag1_demod`'s function in plain PyTorch, on any device and
    any K and layout (the CPU path of the wrapper, the staged step's
    tensor route, and the reference the kernel is held to on the card)."""
    _check_shapes(yr, yi, prev)
    return _plain(yr, yi, prev, fast)


def _plain(yr, yi, prev, fast):
    # Channel-major planes [K, frames]; d[j] from y[j] and y[j-1] in the
    # fused kernel's products and order (the signs of zero products at
    # stream start depend on it).
    at2 = _demod.fast_atan2 if fast else torch.atan2
    rt = yr.T.contiguous()
    it = yi.T.contiguous()
    a, b = rt[:, 1:], rt[:, :-1]
    c, d_ = it[:, 1:], it[:, :-1]
    d_int = at2(c * b - a * d_, a * b + c * d_)
    d0 = at2(it[:, 0] * prev[:, 0] - rt[:, 0] * prev[:, 1],
             rt[:, 0] * prev[:, 0] + it[:, 0] * prev[:, 1])
    d = torch.cat([d0[:, None], d_int], dim=1)
    return d, torch.stack([rt[:, -1], it[:, -1]], dim=-1)
