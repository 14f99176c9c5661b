"""The polyphase DFT channelizer: one CUDA kernel, and its plain version.

    f32 re/im planes [N] -> K-channel spectrum yr, yi [N/K, K]

Counterpart of :mod:`comms_tpu.kernels.channelizer_pallas`, with its
contract: ``channelize_planar(re, im, prototype, ctx_re, ctx_im,
num_channels)`` over planes whose length is a multiple of
:func:`step_samples`, K dividing 128, at most 16 taps per branch, and a
carried input context of ``CTX_SAMPLES`` of which the trailing T-1
count (T = K*M, the prototype length).

The kernel, ``csrc/channelizer.cu``, replaces the TPU kernel
``comms_tpu/kernels/channelizer_pallas.py::channelize_pallas_planar``.
On the H100 it moves 16 bytes per complex sample and does 2M branch
multiply-adds and a K-point FFT (about 5 log2(K)/2 flops) per sample, so
device memory bounds it.  Each block walks every B-th tile of 4096/K
frames (:func:`partition`, fixed by the shape), copying its next window
with ``cp.async`` while it computes; the blocks in flight cover
consecutive tiles, so the look-back comes from L2 and device memory sees
the input and the spectrum about once.  The branch sums are
register-blocked over 16 frames a thread and
the DFT is a register FFT (the branch-reversal phase folded into a
relabelling of the branches).  The FFT rounds otherwise than the direct
sum of the plain version: they agree to ~1e-6 of the largest output.
The source's header says more.

:func:`channelize_planar` launches the kernel for CUDA tensors and runs
:func:`channelize_plain` for CPU tensors; any other device raises.  It
never falls back: a CUDA tensor gets the kernel or an exception.
``launches`` counts the kernel launches (not the plain runs).  The
plain version is :mod:`comms_tpu_torch.ops.channelizer`'s banded
product and block-diagonal DFT product, in full float32 (TF32 off).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.ops import channelizer as _chan
from comms_tpu_torch.ops import fir as _fir
from comms_tpu_torch.runtime.metrics import scoped

__all__ = ["channelize_planar", "channelize", "channelize_plain",
           "partition", "step_samples", "CTX_SAMPLES", "K"]

K = 64                         # default (the BASELINE configuration)
_LANES = 128
_ROWS = 128
CTX_SAMPLES = 1024             # carried input samples (>= T-1 for M <= 16)

# Kernel launches since import (or since a caller reset it to 0).
launches = 0

# A call's tiles are spread over at most this many blocks (8 for each of
# the 264 blocks the H100 holds at once), block b walking tiles b, b +
# blocks, ...  A fixed count, so that the partition follows from the
# shape alone, not from the card.
_RUN_BLOCKS = 2112


def partition(n_frames: int, num_channels: int):
    """The kernel's partition of ``n_frames`` spectrum frames:
    ``(tile_frames, run, blocks)``: tiles of 4096/K frames, ``blocks``
    blocks, block b walking tiles b, b + blocks, ... (``run`` of them at
    most)."""
    T = 4096 // int(num_channels)
    tiles = int(n_frames) // T
    blocks = max(1, min(tiles, _RUN_BLOCKS))
    return T, -(-tiles // blocks), blocks


def step_samples() -> int:
    """Block quantum: N must be a multiple of this (16384 samples)."""
    return _ROWS * _LANES


def _check_plane(name, p):
    if not isinstance(p, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(p)}")
    if p.dtype != torch.float32 or p.ndim != 1 or not p.is_contiguous():
        raise ValueError(f"{name} must be a contiguous 1-D float32 tensor, "
                         f"got {p.dtype} {tuple(p.shape)}")


def validate(num_channels: int, prototype, n: int):
    """The TPU kernel's constraints, with its messages.  Returns
    ``(k, M, h)``: channels, taps per branch and the float64 prototype."""
    k = int(num_channels)
    if k < 2 or _LANES % k:
        raise ValueError(f"num_channels {k} must divide 128")
    h = np.asarray(prototype, np.float64)
    if h.shape[0] % k:
        raise ValueError(f"prototype length must be a multiple of {k}")
    M = h.shape[0] // k
    if M > 16:
        raise ValueError(f"taps_per_branch {M} > 16 unsupported")
    if k * M > CTX_SAMPLES + 1:
        raise ValueError(
            f"prototype length {k * M} exceeds the {CTX_SAMPLES}-"
            "sample halo zone")
    if n % step_samples():
        raise ValueError(f"N {n} must be a multiple of {step_samples()}")
    return k, M, h


def _check(re, im, prototype, ctx_re, ctx_im, num_channels):
    _check_plane("re", re)
    _check_plane("im", im)
    if re.shape != im.shape or re.device != im.device:
        raise ValueError("re and im differ in length or device")
    k, M, h = validate(num_channels, prototype, re.shape[0])
    for name, c in (("ctx_re", ctx_re), ("ctx_im", ctx_im)):
        _check_plane(name, c)
        if c.shape[0] != CTX_SAMPLES:
            raise ValueError(f"ctx must be {CTX_SAMPLES} samples")
        if c.device != re.device:
            raise ValueError(f"{name} is on {c.device}, the planes on "
                             f"{re.device}")
    return k, M, h


def branch_matrix(h: np.ndarray, k: int) -> np.ndarray:
    """C [M, K] float32, as the TPU kernel rounds it."""
    return _fir.decimating_branch_taps(h, k).astype(np.float32)


@functools.lru_cache(maxsize=16)
def root_table(k: int) -> np.ndarray:
    """[K, 2] float32 (re, im) of exp(-2j*pi*n/K), made in float64."""
    w = np.exp(-2j * np.pi * np.arange(k) / k)
    return np.stack([w.real, w.imag], axis=-1).astype(np.float32)


@scoped("kernel.channelizer")
def channelize_planar(re, im, prototype, ctx_re, ctx_im,
                      num_channels: int = K):
    """Run the channelizer over f32 planes.

    Args:
      re, im: [N] float32 planes, N % step_samples() == 0.
      prototype: length K*M real lowpass (M <= 16), host numpy.
      ctx_re, ctx_im: [CTX_SAMPLES] float32 carried input-tail planes on
        the planes' device (zeros at stream start; only the trailing T-1
        samples matter).
      num_channels: K, dividing 128.

    Returns ``(yr[N//K, K], yi[N//K, K], new_ctx_re, new_ctx_im)``, the
    new context a copy of the planes' last CTX_SAMPLES.  On a CUDA
    device the kernel is launched on the current stream and not waited
    for.
    """
    global launches
    k, M, h = _check(re, im, prototype, ctx_re, ctx_im, num_channels)
    dev = re.device
    if dev.type == "cpu":
        return _plain(re, im, h, k, ctx_re, ctx_im)
    if dev.type != "cuda":
        raise ValueError(f"channelize_planar runs on CUDA or CPU tensors, "
                         f"got {dev}")
    lib = _build.load()
    frames = re.shape[0] // k
    yr = torch.empty((frames, k), dtype=torch.float32, device=dev)
    yi = torch.empty((frames, k), dtype=torch.float32, device=dev)
    C = _build.device_constant(branch_matrix(h, k), dev)
    roots = _build.device_constant(root_table(k), dev)
    _, _, blocks = partition(frames, k)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.channelize_launch(
            re.data_ptr(), im.data_ptr(), ctx_re.data_ptr(),
            ctx_im.data_ptr(), CTX_SAMPLES, C.data_ptr(), roots.data_ptr(),
            k, M, frames, blocks, yr.data_ptr(), yi.data_ptr(), stream)
    if rc != 0:
        raise RuntimeError(f"channelizer kernel launch failed: CUDA error "
                           f"{rc}")
    launches += 1
    return yr, yi, re[-CTX_SAMPLES:].clone(), im[-CTX_SAMPLES:].clone()


def channelize(x, prototype, ctx, num_channels: int = K):
    """Complex form of :func:`channelize_planar`: ``x`` [N] and ``ctx``
    [CTX_SAMPLES] complex64.  Returns ``(y[N//K, K], new_ctx)``."""
    yr, yi, ncr, nci = channelize_planar(
        x.real.contiguous(), x.imag.contiguous(), prototype,
        ctx.real.contiguous(), ctx.imag.contiguous(), num_channels)
    return torch.complex(yr, yi), torch.complex(ncr, nci)


def channelize_plain(re, im, prototype, ctx_re, ctx_im,
                     num_channels: int = K):
    """:func:`channelize_planar`'s function in plain PyTorch, on any
    device (the CPU path of the wrapper, and the reference the kernel is
    held to on the card)."""
    k, _, h = _check(re, im, prototype, ctx_re, ctx_im, num_channels)
    return _plain(re, im, h, k, ctx_re, ctx_im)


def _plain(re, im, h, k, ctx_re, ctx_im):
    C = branch_matrix(h, k)
    Tm1 = C.size - 1
    yr, yi, _, _ = _chan.channelize_block_planar(
        re, im, C, ctx_re[CTX_SAMPLES - Tm1:], ctx_im[CTX_SAMPLES - Tm1:])
    return yr, yi, re[-CTX_SAMPLES:].clone(), im[-CTX_SAMPLES:].clone()
