"""The fused FM receive chain: one CUDA kernel, and its plain version.

    planar u8 IQ -> (x-127.5)/127.5 -> 63-tap FIR /5 -> quadrature demod
                 -> 63-tap FIR /5 -> f32 audio [N/25]

Counterpart of :mod:`comms_tpu.kernels.fm_chain_pallas`, with its
contract: ``fm_chain_fused(re_u8, im_u8, ctx, taps1, taps2)`` over
planar u8 planes whose length is a multiple of ``IN_PER_STEP``, the
stream context ``ctx`` given by the caller (see :func:`zero_ctx`), and
no state returned (the model recomputes it from the raw tail).

The kernel, ``csrc/fm_chain.cu``, replaces the TPU kernel
``comms_tpu/kernels/fm_chain_pallas.py::fm_chain_fused``.  On the H100
it reads 2 bytes and does ~28 float32 multiply-adds per input sample:
its bound is the CUDA cores' FMA rate (0.025 ms at N = 26,214,400,
against 0.017 ms of bytes).  Persistent thread blocks walk tiles of
256 audio outputs (64 for calls too small to fill the card), keep every
intermediate in shared memory, copy the next tile's u8 window in
(``cp.async``) while the current one computes, convert bytes without a
division (exact for all 256 values), and run both FIRs in register-
blocked windows: a thread computes 7 (then 3) consecutive outputs of
one plane from five rotating windows, one shared-memory load per 4.7
FMAs.  Each output's FMA chain keeps its order, so the audio is
bit-identical to the first (one output a thread) form of the kernel.
The source's header says more.

:func:`fm_chain_fused` launches the kernel for CUDA tensors and runs
:func:`fm_chain_plain` for CPU tensors; any other device raises.  It
never falls back: a CUDA tensor gets the kernel or an exception.
``launches`` counts the kernel launches (not the plain runs).

The plain version is built from this package's ``fir_decimate_poly``,
the demod expression in the kernel's order and ``fast_atan2``.  Its
float32 products run in full float32:
``torch.backends.cuda.matmul.allow_tf32`` must stay False (PyTorch's
default), since TF32 would put ~1e-3 of error into the comparison.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.ops import demodulation, fir
from comms_tpu_torch.runtime.metrics import scoped

__all__ = ["fm_chain_fused", "fm_chain_plain", "zero_ctx", "IN_PER_STEP",
           "CTX_X", "CTX_D"]

IN_PER_STEP = 102400     # input samples per block quantum (public contract)
CTX_X = 20480            # raw-domain input tail per plane in ``ctx``
CTX_D = 5120             # demodulated tail in ``ctx``
_DEC = 5
_NUM_TAPS = 63

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


def zero_ctx(device="cuda"):
    """Stream-start context: raw-domain 127.5 (converted-domain 0) input
    tails, a zero demod tail and a zero previous mid sample."""
    f32 = torch.float32
    return {
        "xre": torch.full((CTX_X,), 127.5, dtype=f32, device=device),
        "xim": torch.full((CTX_X,), 127.5, dtype=f32, device=device),
        "d": torch.zeros(CTX_D, dtype=f32, device=device),
        "prev": torch.zeros(2, dtype=f32, device=device),
    }


def _taps_f32(taps, name: str) -> np.ndarray:
    t = np.ascontiguousarray(np.asarray(taps, np.float64).astype(np.float32))
    if t.shape != (_NUM_TAPS,):
        raise ValueError(f"{name} must hold {_NUM_TAPS} taps, got "
                         f"shape {t.shape}")
    return t


def _check(re_u8, im_u8, ctx, taps1, taps2):
    """Validate the operands; returns the taps as float32 numpy."""
    for name, p in (("re_u8", re_u8), ("im_u8", im_u8)):
        if not isinstance(p, torch.Tensor):
            raise TypeError(f"{name} must be a tensor, got {type(p)}")
        if p.dtype != torch.uint8 or p.ndim != 1 or not p.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 1-D uint8 "
                             f"tensor, got {p.dtype} {tuple(p.shape)}")
    if re_u8.shape != im_u8.shape or re_u8.device != im_u8.device:
        raise ValueError("re_u8 and im_u8 differ in length or device")
    N = re_u8.shape[0]
    if N == 0 or N % IN_PER_STEP:
        raise ValueError(f"N {N} must be a positive multiple of "
                         f"{IN_PER_STEP}")
    for key, n in (("xre", CTX_X), ("xim", CTX_X), ("d", CTX_D),
                   ("prev", 2)):
        v = ctx[key]
        if (not isinstance(v, torch.Tensor) or v.dtype != torch.float32
                or tuple(v.shape) != (n,) or not v.is_contiguous()):
            raise ValueError(f"ctx[{key!r}] must be a contiguous float32 "
                             f"tensor of shape ({n},)")
        if v.device != re_u8.device:
            raise ValueError(f"ctx[{key!r}] is on {v.device}, the planes "
                             f"on {re_u8.device}")
    return _taps_f32(taps1, "taps1"), _taps_f32(taps2, "taps2")


@scoped("kernel.fm_chain")
def fm_chain_fused(re_u8, im_u8, ctx, taps1, taps2):
    """Run the fused chain over planar u8 planes.

    Args:
      re_u8, im_u8: [N] uint8 planar IQ planes, N % 102400 == 0.
      ctx: dict of float32 tensors on the planes' device: 'xre', 'xim'
        ([20480] input tails in the RAW u8 scale; 127.5 at stream
        start), 'd' ([5120] demod tail) and 'prev' ([2] last mid
        sample).  See :func:`zero_ctx`.
      taps1/taps2: the two 63-tap LPFs (host arrays; run in float32).

    Returns audio[N/25] float32 on the planes' device.  On a CUDA device
    the kernel is launched on the current stream and not waited for.
    """
    global launches
    h1, h2 = _check(re_u8, im_u8, ctx, taps1, taps2)
    dev = re_u8.device
    if dev.type == "cpu":
        return _plain(re_u8, im_u8, ctx, h1, h2)
    if dev.type != "cuda":
        raise ValueError(f"fm_chain_fused runs on CUDA or CPU tensors, "
                         f"got {dev}")
    lib = _build.load()
    n_audio = re_u8.shape[0] // (_DEC * _DEC)
    out = torch.empty(n_audio, dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fm_chain_launch(
            re_u8.data_ptr(), im_u8.data_ptr(),
            ctx["xre"].data_ptr(), ctx["xim"].data_ptr(),
            ctx["d"].data_ptr(), ctx["prev"].data_ptr(),
            h1.ctypes.data, h2.ctypes.data,
            out.data_ptr(), n_audio, stream)
    if rc != 0:
        raise RuntimeError(f"fm_chain kernel launch failed: CUDA error {rc}")
    launches += 1
    return out


def fm_chain_plain(re_u8, im_u8, ctx, taps1, taps2):
    """:func:`fm_chain_fused`'s function in plain PyTorch, on any device
    (the CPU path of the wrapper, and the reference the kernel is held
    to on the card)."""
    h1, h2 = _check(re_u8, im_u8, ctx, taps1, taps2)
    return _plain(re_u8, im_u8, ctx, h1, h2)


def _convert(raw):
    return (raw.to(torch.float32) - 127.5) / 127.5


def _plain(re_u8, im_u8, ctx, h1, h2):
    Hb1 = fir.decimating_branch_taps(h1, _DEC)
    Hb2 = fir.decimating_branch_taps(h2, _DEC)
    L1, L2 = Hb1.size - 1, Hb2.size - 1
    x = torch.complex(_convert(re_u8), _convert(im_u8))
    cx = torch.complex(_convert(ctx["xre"][-L1:]), _convert(ctx["xim"][-L1:]))
    mid, _ = fir.fir_decimate_poly(x, Hb1, cx)
    mr, mi = mid.real, mid.imag
    lr = torch.cat([ctx["prev"][0:1], mr[:-1]])
    li = torch.cat([ctx["prev"][1:2], mi[:-1]])
    # The kernel's order (products, then one sum each), which fixes the
    # signs of zero products at stream start.
    zre = mr * lr + mi * li
    zim = mi * lr - mr * li
    d = demodulation.fast_atan2(zim, zre)
    audio, _ = fir.fir_decimate_poly(d, Hb2, ctx["d"][-L2:])
    return audio
