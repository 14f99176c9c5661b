"""Fused transmit shaping: bits -> pulse-shaped IQ as one planar product.

Counterpart of :mod:`comms_tpu.ops.txshape` (the reference tx chains:
random bits -> symbol map -> zero-stuff x sps -> RRC FIR -> scale 8192
-> interleaved i16 file):

* The symbol map (``2b - 1``) and the polyphase pulse product are both
  affine in the raw bit stream, so map + upsample + FIR are one banded
  product ``Y[r, c] = (W @ G)[r, c] - off[c]``: ``W`` holds overlapping
  windows of the bit stream (a ``Tensor.unfold`` view) and ``G`` is a
  host banded matrix.  QPSK's stride-2 re/im bit deinterleave lives in
  ``G``'s band.  Output rows carry 128 samples per plane, the re plane
  in columns ``[0, Pw)`` and the im plane in ``[Pw, 2*Pw)``.
* The product is exact.  ``G`` is split on the host into ``G_hi + G_lo``,
  each on a power-of-two grid coarse enough that every partial sum of a
  column's entries times a window value (0, 1, or the 0.5 of the start
  context) is a float32 number; the two products run as one float32
  ``torch.matmul`` against ``[G_hi | G_lo]`` (TF32 off) and are added
  once.  So the result does not depend on the order the library sums in:
  the CPU and a CUDA card give the same planes, bit for bit, and
  ``G_hi + G_lo`` is ``G`` to ~2^-43.
* The mixer ``y * exp(j*(phase0 + n*dphase))`` runs on the planes from
  host per-row / per-column angle tables by angle addition; the carried
  phase is the host fixed-point pair of :mod:`comms_tpu_torch.ops.mixer`.
* i16 interleaving: the planes are quantized to int16 side by side and
  viewed as int32 words ``(re & 0xffff) | (im << 16)``, whose
  little-endian bytes are the reference's file format.

Streaming semantics: the carried state is the last ``bits_per_sym*(M-1)``
raw bits (M = ceil(num_taps/sps)) and the fixed-point mixer phase;
output does not depend on how the stream is cut into blocks.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.ops import mixer as _mixer
from comms_tpu_torch.ops.fir import _pad_tail, _window_rows_strided

__all__ = [
    "TxShapeMats",
    "MixerTables",
    "tx_shape_matrices",
    "tx_shape_block",
    "mixer_tables",
    "mix_planar",
    "quantize_pack_iq",
    "unpack_iq",
]


class TxShapeMats(NamedTuple):
    """Host shaping operands (numpy)."""

    G: np.ndarray          # [width, C] banded bit->sample matrix (float32)
    off: np.ndarray        # [C] constant offset (the "-1" of 2b-1)
    bits_per_sym: int      # 1 = BPSK (re only), 2 = QPSK interleaved
    sps: int
    ctx_bits: int          # carried raw bits = bits_per_sym * (M-1)
    stride: int            # window row stride in bits
    width: int             # window width in bits
    samples_per_row: int   # Pw (output samples per row per plane)
    planes: int            # 1 (BPSK, im = 0) or 2 (QPSK)
    G_split: np.ndarray    # [width, 2C] float32 [G_hi | G_lo]


def _on_grid(G: np.ndarray):
    """``G`` rounded to the power-of-two grid q on which every partial sum
    of a column's entries, each times a value in {0, 0.5, 1}, is a
    float32 number: q/2 * 2^24 exceeds the largest column sum of |G|."""
    s = float(np.abs(G).sum(axis=0).max())
    if s == 0.0:
        return np.zeros_like(G)
    q = 2.0 ** (np.floor(np.log2(s)) + 1 - 23)
    return np.rint(G / q) * q


def tx_shape_matrices(taps, sps: int, bits_per_sym: int,
                      samples_per_row: int = 128) -> TxShapeMats:
    """Build the banded bit->sample operands on the host.

    ``taps`` is the 1-D pulse filter (real, or complex with zero
    imaginary part).  ``bits_per_sym`` = 1 maps bit b -> 2b-1; = 2 maps
    consecutive bit pairs (x, y) -> (2x-1) + j(2y-1).
    """
    t = np.asarray(taps)
    if np.iscomplexobj(t):
        if np.abs(t.imag).max() != 0.0:
            raise ValueError("tx_shape_matrices requires real taps")
        t = t.real
    t = t.astype(np.float64)
    sps = int(sps)
    B = int(bits_per_sym)
    if B not in (1, 2):
        raise ValueError("bits_per_sym must be 1 (BPSK) or 2 (QPSK)")
    Pw = int(samples_per_row)
    if Pw % sps:
        raise ValueError(f"samples_per_row {Pw} not a multiple of sps {sps}")
    S = Pw // sps                       # symbols per row
    T = t.shape[0]
    M = -(-T // sps)                    # symbols spanned by the filter
    Hf = np.zeros(M * sps)
    Hf[:T] = t
    H = Hf.reshape(M, sps)              # H[m, p] = taps[m*sps + p]

    width = B * (S + M - 1)
    planes = 2 if B == 2 else 1
    C = planes * Pw
    G = np.zeros((width, C))
    off = np.zeros(C)
    for s in range(Pw):
        j, p = divmod(s, sps)
        for pl in range(planes):
            c = pl * Pw + s
            off[c] = H[:, p].sum()
            for m in range(M):
                G[B * (j - m + M - 1) + pl, c] += 2.0 * H[m, p]
    G_hi = _on_grid(G)
    G_lo = _on_grid(G - G_hi)
    return TxShapeMats(
        G=G.astype(np.float32), off=off.astype(np.float32),
        bits_per_sym=B, sps=sps, ctx_bits=B * (M - 1), stride=B * S,
        width=width, samples_per_row=Pw, planes=planes,
        G_split=np.concatenate([G_hi, G_lo], axis=1).astype(np.float32))


def tx_shape_block(bits, ctx_bits, mats: TxShapeMats):
    """Shape one block of raw bits into sample planes.

    ``bits``: [Nbits] float32 in {0, 1} (``Nbits % bits_per_sym == 0``).
    ``ctx_bits``: carried [mats.ctx_bits] float32 raw-bit tail.
    Returns ``(yre[R, Pw], yim[R, Pw] | None, new_ctx, n_valid)``: the
    ``n_valid = (Nbits // B) * sps`` output samples are the row-major
    flattening of the planes (trailing entries pad the last row).
    """
    B = mats.bits_per_sym
    S = mats.stride // B
    n_bits = bits.shape[0]
    if n_bits % B:
        raise ValueError(f"bit count {n_bits} not a multiple of {B}")
    syms = n_bits // B
    n_valid = syms * mats.sps
    R = -(-syms // S)                   # rows

    ext = torch.cat([ctx_bits.to(bits.dtype), bits])
    new_ctx = ext[-mats.ctx_bits:].clone() if mats.ctx_bits else ctx_bits
    xpad = _pad_tail(ext, (R - 1) * mats.stride + mats.width)
    W = _window_rows_strided(xpad, R, mats.stride, mats.width)
    Y2 = W @ _build.device_constant(mats.G_split, bits.device)
    C = mats.planes * mats.samples_per_row
    Y = (Y2[:, :C] + Y2[:, C:]) - _build.device_constant(mats.off,
                                                         bits.device)
    Pw = mats.samples_per_row
    if mats.planes == 1:
        return Y, None, new_ctx, n_valid
    return Y[:, :Pw], Y[:, Pw:], new_ctx, n_valid


class MixerTables(NamedTuple):
    """Host planar mixer angle tables for one block shape."""

    cos_row: np.ndarray    # [R] cos(r*Pw*dphase mod 2pi)
    sin_row: np.ndarray
    cos_col: np.ndarray    # [Pw] cos(s*dphase mod 2pi)
    sin_col: np.ndarray
    adv: tuple             # fixed-point per-block phase advance


def mixer_tables(n_samples: int, dphase: float,
                 samples_per_row: int = 128) -> MixerTables:
    """Angle tables for mixing an ``[R, Pw]`` plane pair whose row-major
    flattening is the sample stream.  Host float64 (exact mod 2*pi at
    any block position), stored float32."""
    d = np.float64(_mixer.normalize_dphase(dphase))
    Pw = int(samples_per_row)
    R = -(-int(n_samples) // Pw)
    ar = np.mod(np.arange(R, dtype=np.float64) * Pw * d, 2 * np.pi)
    bs = np.mod(np.arange(Pw, dtype=np.float64) * d, 2 * np.pi)
    return MixerTables(
        cos_row=np.cos(ar).astype(np.float32),
        sin_row=np.sin(ar).astype(np.float32),
        cos_col=np.cos(bs).astype(np.float32),
        sin_col=np.sin(bs).astype(np.float32),
        adv=_mixer.advance_fix(int(n_samples), dphase))


def mix_planar(yre, yim, pfix, tables: MixerTables):
    """Mix sample planes by ``exp(j*(phase0 + n*dphase))``, n the
    row-major sample index and ``phase0`` the carried fixed-point phase
    (:func:`comms_tpu_torch.ops.mixer.phase_fix_init`).

    The carried phase's cos/sin are host float32 numbers; the row
    angles take it first (``cos(phase0 + ar)``, [R]), then two outer
    products with the column table give ``cos/sin(phase0 + ar + bs)``.
    Returns ``(yre', yim', new_pfix)``.
    """
    phi0 = _mixer.phase_fix_to_angle(pfix)
    c0, s0 = float(np.cos(phi0)), float(np.sin(phi0))
    dev = yre.device
    car = _build.device_constant(tables.cos_row, dev)
    sar = _build.device_constant(tables.sin_row, dev)
    cbs = _build.device_constant(tables.cos_col, dev)[None, :]
    sbs = _build.device_constant(tables.sin_col, dev)[None, :]
    rc = (c0 * car - s0 * sar)[:, None]     # cos(phi0 + ar)
    rs = (s0 * car + c0 * sar)[:, None]     # sin(phi0 + ar)
    c = rc * cbs - rs * sbs                 # cos(phi0 + ar + bs)
    s = rs * cbs + rc * sbs
    if yim is None:
        out_re, out_im = yre * c, yre * s
    else:
        out_re = yre * c - yim * s
        out_im = yre * s + yim * c
    return out_re, out_im, _mixer.add_fix(pfix, tables.adv)


def quantize_pack_iq(yre, yim, scale: float, n_valid: int):
    """Quantize planes to i16 (truncate toward zero, saturate: Rust's
    ``as i16``) and pack each (re, im) pair into one int32 word
    ``(re & 0xffff) | (im << 16)``: the two int16 planes side by side,
    viewed as int32 (little-endian, as the CPU and the card are).  The
    words' bytes are interleaved i16 re/im, the file format."""
    if yim is None:
        yim = torch.zeros_like(yre)
    y = torch.stack([yre, yim], dim=-1) * np.float32(scale)
    q = torch.clamp(torch.trunc(y), -32768.0, 32767.0).to(torch.int16)
    return q.view(torch.int32).reshape(-1)[:n_valid]


def unpack_iq(packed) -> np.ndarray:
    """Host view of packed int32 IQ as int16 pairs ``[N, 2]`` (re, im);
    a tensor is copied to the host first."""
    if isinstance(packed, torch.Tensor):
        packed = packed.cpu().numpy()
    arr = np.ascontiguousarray(np.asarray(packed, dtype="<i4"))
    return arr.view("<i2").reshape(-1, 2)
