"""PRN sequence generation: Fibonacci LFSR as GF(2) matrix powers.

Counterpart of :mod:`comms_tpu.ops.prns`.  The reference's left-shifting
Fibonacci LFSR (per step: feedback bit ``parity(state & poly_mask)``,
output bit the MSB of the state before the shift, then ``state = (state
<< 1) | fb``) is linear over GF(2): ``s[n+1] = A @ s[n] (mod 2)`` with
companion matrix ``A``, and the n-th output bit is ``msb_row @ A^n @
s0``.  So a block of N bits is one {0,1} matrix product ``bits = (M @
s0) mod 2`` with ``M[n, :] = msb_row @ A^n`` precomputed on the host,
and the register advances N steps at once, ``s' = (A^N @ s0) mod 2``.

On the device the products run as float32 matrix products (CUDA has no
integer ``matmul``): the entries are 0 or 1 and the sums at most the
register width, so every value is exact; ``mod 2`` follows.

``PrnSpec`` is the host parameter bundle (numpy); :func:`prn_block` is
the block step.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from comms_tpu_torch.kernels import _build

__all__ = ["PrnSpec", "prn_block", "prn_bits_host", "PRBS7_POLY",
           "shard_shift_matrices"]

# x^7 + x^6 + 1 (PRBS7) expressed as the reference's poly bitmask for
# an 8-bit register: taps on state bits 7 and 6 -> 0xC0 (prns.rs doc).
PRBS7_POLY = 0xC0


def _int_to_bits(value: int, width: int) -> np.ndarray:
    """Integer -> bit vector, index 0 = MSB (matches left-shift LFSR)."""
    return np.array(
        [(value >> (width - 1 - i)) & 1 for i in range(width)], dtype=np.uint8
    )


def _companion_matrix(poly_mask: int, width: int) -> np.ndarray:
    """A[i, j] over GF(2): new_bit_i = sum_j A[i,j] * bit_j.

    Left shift: new bit i = old bit i+1 for i < W-1; new LSB (i = W-1)
    = parity(state & poly_mask) = sum of bits where the mask is 1.
    """
    A = np.zeros((width, width), dtype=np.uint8)
    for i in range(width - 1):
        A[i, i + 1] = 1
    A[width - 1, :] = _int_to_bits(poly_mask, width)
    return A


def _gf2_matpow(A: np.ndarray, e: int) -> np.ndarray:
    """A^e over GF(2) via square-and-multiply (host numpy)."""
    An = np.eye(A.shape[0], dtype=np.uint8)
    P = A.copy()
    while e:
        if e & 1:
            An = (An.astype(np.int64) @ P % 2).astype(np.uint8)
        P = (P.astype(np.int64) @ P % 2).astype(np.uint8)
        e >>= 1
    return An


@dataclass(frozen=True)
class PrnSpec:
    """Precomputed block-generation matrices for one LFSR config.

    Attributes:
      out_matrix: [block, W] uint8 — ``bits = (out_matrix @ s) % 2``.
      adv_matrix: [W, W] uint8 — ``s' = (adv_matrix @ s) % 2``.
      width: register width in bits.
      block: bits produced per step.
      companion: [W, W] uint8 — the single-step matrix A (for derived
        advance matrices, e.g. per-shard offsets under time-sharding).
    """

    out_matrix: np.ndarray = field(repr=False)
    adv_matrix: np.ndarray = field(repr=False)
    width: int
    block: int
    companion: np.ndarray = field(repr=False, default=None)

    @staticmethod
    def make(poly_mask: int, width: int, block: int) -> "PrnSpec":
        A = _companion_matrix(poly_mask, width)
        # M[n, :] = e_msb^T A^n, built by matrix doubling:
        # rows[:2k] = [rows[:k]; rows[:k] @ A^k] — log2(block) numpy
        # matmuls instead of a per-bit Python loop.
        rows = np.zeros((1, width), dtype=np.uint8)
        rows[0, 0] = 1  # MSB row
        Ak = A.copy()   # A^(current number of rows)
        while rows.shape[0] < block:
            rows = np.concatenate(
                [rows, (rows.astype(np.int64) @ Ak) % 2]
            ).astype(np.uint8)
            Ak = (Ak.astype(np.int64) @ Ak % 2).astype(np.uint8)
        rows = rows[:block]
        An = _gf2_matpow(A, block)
        return PrnSpec(rows, An, width, block, A)

    def init_state(self, seed: int, device="cuda"):
        """Register seed (the reference's ``state`` integer) -> bit
        vector [W] int8 on ``device``, index 0 = MSB."""
        return torch.tensor(_int_to_bits(seed, self.width),
                            dtype=torch.int8, device=device)


def prn_block(spec: PrnSpec, state):
    """Generate ``spec.block`` bits and advance the register.

    Returns ``(bits[int8, block], new_state)`` on the state's device:
    two float32 products (exact: 0/1 entries, sums <= W) and mod 2.
    """
    M = _build.device_constant(spec.out_matrix, state.device)
    A = _build.device_constant(spec.adv_matrix, state.device)
    s = state.to(torch.float32)
    bits = torch.remainder(M @ s, 2).to(torch.int8)
    new_state = torch.remainder(A @ s, 2).to(torch.int8)
    return bits, new_state


def shard_shift_matrices(spec: PrnSpec, n_shards: int) -> np.ndarray:
    """[n_shards, W, W] uint8 stack: entry s = A^(s * block/n_shards).

    Shard s of a time-sharded block owns global bits
    [s*local, (s+1)*local); its effective register is
    ``A^(s*local) @ s0``, so its bits are
    ``out_matrix[:local] @ (stack[s] @ s0)`` — exact parity with the
    single-device sequence, with per-shard work 1/n of the block
    (reference LFSR: prns.rs:64-72)."""
    if spec.companion is None:
        raise ValueError("PrnSpec built without companion matrix")
    if spec.block % n_shards:
        raise ValueError(
            f"block {spec.block} not divisible by {n_shards} shards")
    local = spec.block // n_shards
    step = _gf2_matpow(spec.companion, local)
    out = np.empty((n_shards, spec.width, spec.width), np.uint8)
    cur = np.eye(spec.width, dtype=np.uint8)
    for s in range(n_shards):
        out[s] = cur
        cur = (cur.astype(np.int64) @ step % 2).astype(np.uint8)
    return out


def prn_bits_host(poly_mask: int, seed: int, width: int, n: int) -> np.ndarray:
    """Bit-serial host oracle with the reference's exact semantics
    (prns.rs:64-72).  For tests and tap verification."""
    mask_bits = int(poly_mask)
    state = int(seed)
    top = 1 << (width - 1)
    wrap = (1 << width) - 1
    out = np.empty(n, dtype=np.uint8)
    for i in range(n):
        fb = bin(state & mask_bits).count("1") % 2
        out[i] = 1 if (state & top) else 0
        state = ((state << 1) & wrap) | fb
    return out
