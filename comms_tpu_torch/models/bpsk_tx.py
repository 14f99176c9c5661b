"""BPSK transmitter: the reference's golden config on the card.

Counterpart of :mod:`comms_tpu.models.bpsk_tx`, the chain of the
reference's ``examples/single_thread_bpsk.rs``:

    random bits (4096 a block) -> BPSK (2b-1) -> zero-stuff x4
    -> RRC(32 taps, sps=4, beta=0.25) -> scale 8192 -> i16 IQ file

Two block paths, as in the JAX package:

* :func:`make_block_fn`, the pair layout: bits from one threefry draw
  per bit (:func:`comms_tpu_torch.ops.random.random_bits_block`), the
  polyphase pulse product on complex symbols, i16 (re, im) rows;
* :func:`make_block_fn_fast`, the production path: 32 bits per threefry
  word and the whole chain as one exact banded product plus elementwise
  quantize/pack (:mod:`comms_tpu_torch.ops.txshape`); int32 words whose
  little-endian bytes are the i16 file.

Both draw the JAX package's bit streams from the same seed (the key is
a bit-exact threefry port), and the states carry across from the JAX
package (:func:`state_from_jax`, :func:`fast_state_from_jax`).
:func:`make_pipeline` is the pair path on the runtime layer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from comms_tpu_torch.ops import modulation, pulse, taps, txshape
from comms_tpu_torch.ops import random as crandom

__all__ = ["BpskTxConfig", "make_block_fn", "make_pipeline",
           "make_block_fn_fast", "init_state", "init_state_fast",
           "state_from_jax", "fast_state_from_jax", "run_to_file"]

SYMS_PER_BLOCK = 4096
SPS = 4
NUM_TAPS = 32
BETA = 0.25
SCALE = 8192.0


class BpskTxConfig:
    """Static parameters, precomputed on the host in float64."""

    def __init__(self, syms_per_block: int = SYMS_PER_BLOCK, sps: int = SPS,
                 num_taps: int = NUM_TAPS, beta: float = BETA,
                 scale: float = SCALE):
        self.syms_per_block = int(syms_per_block)
        self.sps = int(sps)
        self.num_taps = int(num_taps)
        self.beta = float(beta)
        self.scale = float(scale)
        t = taps.rrc_taps(num_taps, float(sps), beta).astype(np.complex64)
        self.phase_taps = pulse.polyphase_taps(t, sps)
        self._shape_mats = None

    @property
    def samples_per_block(self) -> int:
        return self.syms_per_block * self.sps

    @property
    def ctx_len(self) -> int:
        """Symbols of pulse context (M - 1)."""
        return max(-(-self.num_taps // self.sps) - 1, 0)

    @property
    def shape_mats(self) -> txshape.TxShapeMats:
        """Fused bits->samples operands (lazy, host)."""
        if self._shape_mats is None:
            t = taps.rrc_taps(self.num_taps, float(self.sps), self.beta)
            self._shape_mats = txshape.tx_shape_matrices(
                t, self.sps, bits_per_sym=1)
        return self._shape_mats


def trunc_i16(x):
    """Rust ``as i16``: truncate toward zero, saturate."""
    return torch.clamp(torch.trunc(x), -32768.0, 32767.0).to(torch.int16)


def init_state(cfg: BpskTxConfig, seed: int = 0, device="cuda"):
    """``(key, pulse_ctx_pairs[M-1, 2] float32)`` on ``device``."""
    return (crandom.source_init(seed, device),
            torch.zeros((cfg.ctx_len, 2), dtype=torch.float32,
                        device=device))


def state_from_jax(state, device="cuda"):
    """The JAX package's :func:`init_state`-shaped state ``(key uint32[2],
    ctx_pairs)`` as numpy arrays -> this package's state on ``device``;
    the streams then continue identically."""
    key, ctx = state
    return (crandom.key_from_words(key, device),
            torch.tensor(np.asarray(ctx, np.float32), device=device))


def make_block_fn(cfg: BpskTxConfig):
    """``block(state) -> (iq_i16[N, 2], new_state)`` on the state's
    device; the int16 rows (re, im) are the file's bytes."""
    H = cfg.phase_taps

    def block(state):
        key, ctx_pairs = state
        bits, key = crandom.random_bits_block(key, cfg.syms_per_block)
        sym = modulation.bpsk_bit_mod_example(bits)
        ctx = torch.complex(ctx_pairs[:, 0], ctx_pairs[:, 1])
        y, ctx = pulse.pulse_shape_block(sym, H, ctx)
        new_ctx_pairs = torch.stack([ctx.real, ctx.imag], dim=-1)
        iq = torch.stack([trunc_i16(y.real * cfg.scale),
                          trunc_i16(y.imag * cfg.scale)], dim=-1)
        return iq, (key, new_ctx_pairs)

    return block


def make_pipeline(cfg: Optional[BpskTxConfig] = None, seed: int = 0):
    """The same chain on the runtime layer: a source-headed
    :class:`comms_tpu_torch.runtime.Pipeline` (the reference's bpsk_mod
    graph, examples/bpsk_mod.rs:124-161).  ``pipe.step(state)`` from
    ``pipe.init_state()`` equals :func:`make_block_fn` from
    :func:`init_state` with the same seed, bit for bit."""
    from comms_tpu_torch.runtime import (BpskMod, Lambda, Pipeline,
                                         PulseShape, RandomBitSource)

    cfg = cfg or BpskTxConfig()
    t = taps.rrc_taps(cfg.num_taps, float(cfg.sps),
                      cfg.beta).astype(np.complex64)

    def quantize(y):
        return torch.stack([trunc_i16(y.real * cfg.scale),
                            trunc_i16(y.imag * cfg.scale)], dim=-1)

    return Pipeline([
        RandomBitSource(cfg.syms_per_block, seed),
        BpskMod(example_convention=True),
        PulseShape.make(t, cfg.sps),
        Lambda(quantize, result_dtype=torch.int16),
    ])


def init_state_fast(cfg: BpskTxConfig, seed: int = 0, device="cuda"):
    """State of :func:`make_block_fn_fast`: ``(key, ctx_bits)``.  The
    start context bits are 0.5, the bit whose symbol ``2b - 1`` is 0:
    the reference's zero FIR state."""
    return (crandom.source_init(seed, device),
            torch.full((cfg.shape_mats.ctx_bits,), 0.5, dtype=torch.float32,
                       device=device))


def fast_state_from_jax(state, device="cuda"):
    """The JAX package's :func:`init_state_fast` state ``(key uint32[2],
    ctx_bits)`` as numpy arrays -> this package's state on ``device``."""
    key, ctx = state
    return (crandom.key_from_words(key, device),
            torch.tensor(np.asarray(ctx, np.float32), device=device))


def make_block_fn_fast(cfg: BpskTxConfig):
    """Production tx path: ``block(state) -> (iq_packed_i32[N],
    new_state)``.  Differs from :func:`make_block_fn` by the bit stream
    (packed threefry words) and by float32 rounding (<= 1 i16 LSB)."""
    mats = cfg.shape_mats

    def block(state):
        key, ctx = state
        bits, key = crandom.random_bits_packed_block(key, cfg.syms_per_block)
        yre, yim, ctx, n_valid = txshape.tx_shape_block(bits, ctx, mats)
        packed = txshape.quantize_pack_iq(yre, yim, cfg.scale, n_valid)
        return packed, (key, ctx)

    return block


def write_blocks(path, block, state, num_blocks: int) -> int:
    """Run ``num_blocks`` blocks from ``state`` and write each block's
    int16 pairs (or packed int32 words) to ``path``.  Returns samples
    written."""
    written = 0
    with open(path, "wb") as f:
        for _ in range(num_blocks):
            out, state = block(state)
            arr = out.cpu().numpy()
            f.write(np.ascontiguousarray(arr).tobytes())
            written += arr.shape[0]
    return written


def run_to_file(path, num_blocks: int, cfg: Optional[BpskTxConfig] = None,
                seed: int = 0, fast: bool = False, device="cuda") -> int:
    """File-driven entry (the reference's bpsk_out.bin).  Returns samples
    written.  ``fast=True`` takes :func:`make_block_fn_fast`."""
    cfg = cfg or BpskTxConfig()
    if fast:
        return write_blocks(path, make_block_fn_fast(cfg),
                            init_state_fast(cfg, seed, device), num_blocks)
    return write_blocks(path, make_block_fn(cfg),
                        init_state(cfg, seed, device), num_blocks)
