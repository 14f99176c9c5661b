"""64-channel polyphase channelizer model (the BASELINE configuration).

Counterpart of :mod:`comms_tpu.models.channelizer`: wideband IQ in, K
channel streams out, one block at a time, through the channelizer
kernel (:mod:`comms_tpu_torch.kernels.channelizer`) or the tensor path
(:mod:`comms_tpu_torch.ops.channelizer`).  The carried state is the
last T-1 input samples as float32 (re, im) pairs on either path, so the
two are interchangeable mid-stream.
"""

from __future__ import annotations

import numpy as np
import torch

from comms_tpu_torch.kernels import channelizer as _CK
from comms_tpu_torch.ops import channelizer as chan

__all__ = ["ChannelizerConfig", "make_block_fn", "make_planar_block_fn",
           "init_state", "state_from_jax"]


def _kernel_constraints_hold(cfg) -> bool:
    """The constraints under which the JAX package picks its Pallas
    kernel (``_auto_use_pallas``): K | 128, block % 16384 == 0 and a
    prototype whose T-1 look-back fits the carried context."""
    T = cfg.num_channels * cfg.taps_per_branch
    return (128 % cfg.num_channels == 0
            and cfg.block % _CK.step_samples() == 0
            and T - 1 <= _CK.CTX_SAMPLES)


def _auto_use_kernel(cfg, device) -> bool:
    """Default route: the kernel for CUDA tensors when its constraints
    hold, the tensor path otherwise."""
    return torch.device(device).type == "cuda" and _kernel_constraints_hold(
        cfg)


def _check_kernel_config(cfg) -> None:
    """Build-time errors of the kernel route (the JAX package's)."""
    if 128 % cfg.num_channels:
        raise ValueError("channelizer kernel needs K | 128")
    if cfg.block % _CK.step_samples():
        raise ValueError(
            f"channelizer kernel needs block % {_CK.step_samples()}"
            f" == 0, got {cfg.block}")
    T = cfg.num_channels * cfg.taps_per_branch
    if T - 1 > _CK.CTX_SAMPLES:
        raise ValueError(
            f"channelizer kernel carries at most {_CK.CTX_SAMPLES} "
            f"context samples; prototype length {T} (K="
            f"{cfg.num_channels} x M={cfg.taps_per_branch}) exceeds "
            "it — reduce taps_per_branch or use the tensor path")


class ChannelizerConfig:
    def __init__(self, num_channels: int = 64, taps_per_branch: int = 8,
                 block: int = 1 << 18, prototype=None):
        self.num_channels = int(num_channels)
        self.taps_per_branch = int(taps_per_branch)
        self.block = int(block)
        if self.block % self.num_channels:
            raise ValueError("block must be a multiple of num_channels")
        h = (np.asarray(prototype) if prototype is not None
             else chan.design_prototype(num_channels, taps_per_branch))
        self.prototype = h
        self.Hb = chan.branch_taps(h.astype(np.float32), self.num_channels)

    @property
    def frames_per_block(self) -> int:
        return self.block // self.num_channels


def init_state(cfg: ChannelizerConfig, device="cuda"):
    """Carried input tail as [T-1, 2] float32 pairs."""
    T = cfg.num_channels * cfg.taps_per_branch
    return torch.zeros((T - 1, 2), dtype=torch.float32, device=device)


def state_from_jax(state, device="cuda"):
    """The JAX package's :func:`init_state`-shaped state (a numpy array)
    as this package's state on ``device``."""
    return torch.tensor(np.asarray(state, np.float32), device=device)


def _planar_step(cfg: ChannelizerConfig, use_kernel):
    """``(state, re, im) -> (yr, yi, state)``, the route chosen per call
    when ``use_kernel`` is None."""
    if use_kernel:
        _check_kernel_config(cfg)
    T = cfg.num_channels * cfg.taps_per_branch
    pad = _CK.CTX_SAMPLES - (T - 1)

    def kernel_step(state, re, im):
        zc = re.new_zeros(pad)
        yr, yi, _, _ = _CK.channelize_planar(
            re, im, cfg.prototype, torch.cat([zc, state[:, 0]]),
            torch.cat([zc, state[:, 1]]), num_channels=cfg.num_channels)
        # N >= 16384 > T - 1: the next state is the block's tail (stack
        # copies it, so it never aliases a block buffer a caller reuses)
        new_state = torch.stack([re[-(T - 1):], im[-(T - 1):]], dim=-1)
        return yr, yi, new_state

    def tensor_step(state, re, im):
        yr, yi, nre, nim = chan.channelize_block_planar(
            re, im, cfg.Hb, state[:, 0], state[:, 1])
        return yr, yi, torch.stack([nre, nim], dim=-1)

    def step(state, re, im):
        uk = use_kernel
        if uk is None:
            uk = _auto_use_kernel(cfg, re.device)
        return (kernel_step if uk else tensor_step)(state, re, im)

    return step


def make_block_fn(cfg: ChannelizerConfig, use_kernel=None):
    """``(state, iq_pairs[N, 2]) -> (y_pairs[frames, K, 2], state)``.

    ``use_kernel=True`` routes through the channelizer kernel (K | 128,
    taps_per_branch <= 16, block % 16384 == 0; an unmet constraint
    raises here); False through the tensor path; None (default) picks
    the kernel for CUDA tensors when those constraints hold, the tensor
    path otherwise.
    """
    step = _planar_step(cfg, use_kernel)

    def block(state, iq_pairs):
        yr, yi, new_state = step(state, iq_pairs[:, 0].contiguous(),
                                 iq_pairs[:, 1].contiguous())
        return torch.stack([yr, yi], dim=-1), new_state

    return block


def make_planar_block_fn(cfg: ChannelizerConfig, use_kernel=None):
    """Plane-native variant: ``(state, re[N], im[N]) -> ((yre[frames, K],
    yim[frames, K]), state)``, with no relayout on either side of the
    kernel.  State and ``use_kernel`` as :func:`make_block_fn`."""
    step = _planar_step(cfg, use_kernel)

    def block(state, re, im):
        yr, yi, new_state = step(state, re, im)
        return (yr, yi), new_state

    return block
