"""QPSK transmitter with mixer upconversion.

Counterpart of :mod:`comms_tpu.models.qpsk_tx`, the chain of the
reference's ``examples/single_thread_qpsk.rs`` (4096 bits -> 2048 QPSK
symbols -> zero-stuff x4 -> RRC(32, 4, 0.25) -> scale 8192 -> i16 file)
plus a closed-form phase-ramp mixer after the pulse shaping.

The pair path (:func:`make_block_fn`) maps consecutive bit pairs to
symbols, shapes them by the polyphase product and mixes by the host
ramp; the fast path (:func:`make_block_fn_fast`) is one exact banded
product on the packed bit stream, the planar mixer from host angle
tables, and the int32 pack (:mod:`comms_tpu_torch.ops.txshape`).  The
carried mixer phase is the host fixed-point pair (hi, lo) of
:mod:`comms_tpu_torch.ops.mixer`, exact over any stream length.
:func:`make_pipeline` is the pair path on the runtime layer.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from comms_tpu_torch.models.bpsk_tx import trunc_i16, write_blocks
from comms_tpu_torch.ops import mixer, modulation, pulse, taps, txshape
from comms_tpu_torch.ops import random as crandom

__all__ = ["QpskTxConfig", "make_block_fn", "make_pipeline",
           "make_block_fn_fast", "init_state", "init_state_fast",
           "state_from_jax", "fast_state_from_jax", "run_to_file"]


class QpskTxConfig:
    def __init__(self, bits_per_block: int = 4096, sps: int = 4,
                 num_taps: int = 32, beta: float = 0.25,
                 scale: float = 8192.0, dphase: float = 0.0,
                 phase0: float = 0.0):
        if bits_per_block % 2:
            raise ValueError("bits_per_block must be even")
        self.bits_per_block = int(bits_per_block)
        self.sps = int(sps)
        self.num_taps = int(num_taps)
        self.beta = float(beta)
        self.scale = float(scale)
        self.dphase = float(dphase)
        self.phase0 = float(phase0)
        t = taps.rrc_taps(num_taps, float(sps), beta).astype(np.complex64)
        self.phase_taps = pulse.polyphase_taps(t, sps)
        self._ramp = None
        self._shape_mats = None
        self._mix_tables = None

    @property
    def samples_per_block(self) -> int:
        return (self.bits_per_block // 2) * self.sps

    @property
    def ctx_len(self) -> int:
        """Symbols of pulse context (M - 1)."""
        return max(-(-self.num_taps // self.sps) - 1, 0)

    @property
    def ramp(self):
        """N-sized complex mixer ramp of the pair path (lazy)."""
        if self._ramp is None:
            self._ramp, _ = mixer.mixer_ramp(self.samples_per_block,
                                             self.dphase)
        return self._ramp

    @property
    def advance_fix(self):
        return mixer.advance_fix(self.samples_per_block, self.dphase)

    @property
    def shape_mats(self) -> txshape.TxShapeMats:
        """Fused bits->samples operands (lazy, host)."""
        if self._shape_mats is None:
            t = taps.rrc_taps(self.num_taps, float(self.sps), self.beta)
            self._shape_mats = txshape.tx_shape_matrices(
                t, self.sps, bits_per_sym=2)
        return self._shape_mats

    @property
    def mix_tables(self) -> txshape.MixerTables:
        """Planar mixer angle tables (lazy; O(N/128) host floats)."""
        if self._mix_tables is None:
            self._mix_tables = txshape.mixer_tables(
                self.samples_per_block, self.dphase,
                self.shape_mats.samples_per_row)
        return self._mix_tables


def init_state(cfg: QpskTxConfig, seed: int = 0, device="cuda"):
    """``(key, pulse_ctx_pairs[M-1, 2] float32, phase_fix)``."""
    return (crandom.source_init(seed, device),
            torch.zeros((cfg.ctx_len, 2), dtype=torch.float32,
                        device=device),
            mixer.phase_fix_init(cfg.phase0))


def _phase_from_jax(phase):
    return tuple(int(np.asarray(w)) for w in phase)


def state_from_jax(state, device="cuda"):
    """The JAX package's :func:`init_state`-shaped state ``(key uint32[2],
    ctx_pairs, (hi, lo))`` as numpy values -> this package's state."""
    key, ctx, phase = state
    return (crandom.key_from_words(key, device),
            torch.tensor(np.asarray(ctx, np.float32), device=device),
            _phase_from_jax(phase))


def make_block_fn(cfg: QpskTxConfig):
    """``block(state) -> (iq_i16[N, 2], new_state)``."""
    H = cfg.phase_taps
    ramp = cfg.ramp
    adv = cfg.advance_fix

    def block(state):
        key, ctx_pairs, phase = state
        bits, key = crandom.random_bits_block(key, cfg.bits_per_block)
        sym = modulation.qpsk_bits_mod_example(bits)
        ctx = torch.complex(ctx_pairs[:, 0], ctx_pairs[:, 1])
        y, ctx = pulse.pulse_shape_block(sym, H, ctx)
        y, phase = mixer.mixer_block_fix(y, phase, ramp, adv)
        new_ctx_pairs = torch.stack([ctx.real, ctx.imag], dim=-1)
        iq = torch.stack([trunc_i16(y.real * cfg.scale),
                          trunc_i16(y.imag * cfg.scale)], dim=-1)
        return iq, (key, new_ctx_pairs, phase)

    return block


def make_pipeline(cfg: Optional[QpskTxConfig] = None, seed: int = 0):
    """The same chain on the runtime layer: a source-headed
    :class:`comms_tpu_torch.runtime.Pipeline` (bits -> QPSK -> pulse
    shape -> mixer -> i16).  ``pipe.step(state)`` from
    ``pipe.init_state()`` equals :func:`make_block_fn` from
    :func:`init_state` with the same seed, bit for bit."""
    from comms_tpu_torch.runtime import (Lambda, Mixer, Pipeline,
                                         PulseShape, QpskMod,
                                         RandomBitSource)

    cfg = cfg or QpskTxConfig()
    t = taps.rrc_taps(cfg.num_taps, float(cfg.sps),
                      cfg.beta).astype(np.complex64)

    def quantize(y):
        return torch.stack([trunc_i16(y.real * cfg.scale),
                            trunc_i16(y.imag * cfg.scale)], dim=-1)

    return Pipeline([
        RandomBitSource(cfg.bits_per_block, seed),
        QpskMod(example_convention=True),
        PulseShape.make(t, cfg.sps),
        Mixer(cfg.dphase, cfg.phase0),
        Lambda(quantize, result_dtype=torch.int16),
    ])


def init_state_fast(cfg: QpskTxConfig, seed: int = 0, device="cuda"):
    """State of :func:`make_block_fn_fast`: ``(key, ctx_bits,
    phase_fix)``; start context bits 0.5 (the zero symbol)."""
    return (crandom.source_init(seed, device),
            torch.full((cfg.shape_mats.ctx_bits,), 0.5, dtype=torch.float32,
                       device=device),
            mixer.phase_fix_init(cfg.phase0))


def fast_state_from_jax(state, device="cuda"):
    """The JAX package's :func:`init_state_fast` state ``(key uint32[2],
    ctx_bits, (hi, lo))`` as numpy values -> this package's state."""
    key, ctx, phase = state
    return (crandom.key_from_words(key, device),
            torch.tensor(np.asarray(ctx, np.float32), device=device),
            _phase_from_jax(phase))


def make_block_fn_fast(cfg: QpskTxConfig):
    """Production tx path: ``block(state) -> (iq_packed_i32[N],
    new_state)``: packed PRNG bits -> QPSK map -> upsample -> RRC ->
    mixer -> quantize -> interleave.  Differs from :func:`make_block_fn`
    by the bit stream and by float32 rounding (<= 1 i16 LSB)."""
    mats = cfg.shape_mats
    tables = cfg.mix_tables

    def block(state):
        key, ctx, pfix = state
        bits, key = crandom.random_bits_packed_block(key,
                                                     cfg.bits_per_block)
        yre, yim, ctx, n_valid = txshape.tx_shape_block(bits, ctx, mats)
        yre, yim, pfix = txshape.mix_planar(yre, yim, pfix, tables)
        packed = txshape.quantize_pack_iq(yre, yim, cfg.scale, n_valid)
        return packed, (key, ctx, pfix)

    return block


def run_to_file(path, num_blocks: int, cfg: Optional[QpskTxConfig] = None,
                seed: int = 0, fast: bool = False, device="cuda") -> int:
    """File-driven entry.  Returns samples written."""
    cfg = cfg or QpskTxConfig()
    if fast:
        return write_blocks(path, make_block_fn_fast(cfg),
                            init_state_fast(cfg, seed, device), num_blocks)
    return write_blocks(path, make_block_fn(cfg),
                        init_state(cfg, seed, device), num_blocks)
