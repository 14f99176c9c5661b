"""The 3xTF32 split of csrc/tf32x3.cuh (mirrored by kernels/_tf32.py) and
the arithmetic of K5's panel kernel (csrc/qpsk_sym.cu), replayed with
torch on the CPU: the split, the three products, the kernel's chunks
(qpsk_sym.panel_chunking) of 32-row stages and the fixed-order sums,
held against the JAX package's panel kernel in interpret mode.  Also the
bank conflicts of the kernel's stores into its shared-memory operand
layout, and its chunking at the main paths' sizes.  The kernel itself is compared
with its plain version on the card (tests/test_torch_qpsk_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import qpsk_sym_pallas as JQS
from comms_tpu_torch.kernels import _tf32
from comms_tpu_torch.kernels import qpsk_sym as TQS
from comms_tpu_torch.ops import demodulation as tdemod

TOL_PANEL = 1e-5        # the panels' bound (tests/test_torch_qpsk_sym.py)
STAGE_ROWS = 32          # csrc/qpsk_sym.cu kStageRows
RAW_A_STRIDE = 136       # csrc/qpsk_sym.cu kRawA


def _f32(bits):
    return torch.tensor(np.array(bits, np.uint32).view(np.int32)).view(
        torch.float32)


def _bits(x):
    return x.view(torch.int32).numpy().view(np.uint32)


@pytest.mark.parametrize("case,bits,want", [
    # exactly half a TF32 unit above 1.0 rounds away from zero
    ("tie_up", [0x3F801000], [0x3F802000]),
    ("tie_negative", [0xBF801000], [0xBF802000]),
    ("below_half", [0x3F800FFF, 0xBF800FFF], [0x3F800000, 0xBF800000]),
    ("above_half", [0x3F801001], [0x3F802000]),
    ("carry_into_exponent", [0x3FFFF000], [0x40000000]),
    ("subnormals", [0x00001000, 0x00000FFF, 0x80001800, 0x007FF000],
     [0x00002000, 0x00000000, 0x80002000, 0x00800000]),
    ("zeros", [0x00000000, 0x80000000], [0x00000000, 0x80000000]),
    ("inf_and_nan", [0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001],
     [0x7F800000, 0xFF800000, 0x7FC00000, 0x7F800001]),
    ("to_inf", [0x7F7FF000, 0x7F7FEFFF], [0x7F800000, 0x7F7FE000]),
])
def test_tf32_round_bits(case, bits, want):
    got = _tf32.tf32_round(_f32(bits))
    assert list(_bits(got)) == want, case


@pytest.mark.parametrize("scale", [1e-20, 1.0, 3e4, 1e30])
def test_split_reconstructs_x(scale):
    rng = np.random.default_rng(int(np.log10(scale) + 40))
    x = torch.from_numpy((rng.standard_normal(100_000) * scale)
                         .astype(np.float32))
    hi, lo = _tf32.split(x)
    # hi and lo are TF32 values: their low 13 bits are zero
    assert not (_bits(hi) & 0x1FFF).any() and not (_bits(lo) & 0x1FFF).any()
    # the residual x - hi is exact in float32, and hi + lo holds x to 2^-21
    x64, hi64, lo64 = (v.double() for v in (x, hi, lo))
    assert torch.equal((x - hi).double(), x64 - hi64)
    assert float(((hi64 + lo64 - x64).abs() / x64.abs()).max()) <= 2.0 ** -21
    # one TF32 value alone is ~2^-11 off, so the lo half is needed
    assert float(((hi64 - x64).abs() / x64.abs()).max()) > 2.0 ** -14


def replay_panels(re: torch.Tensor, im: torch.Tensor, hw: int):
    """K5's panels as csrc/qpsk_sym.cu forms them, in torch: the operands
    masked as the kernel stages them (A zero at or past K = N - hw and
    past the chunk's rows, B zero outside [0, N)), split into TF32
    halves, each chunk's 32-row stages (from the chunk's first row) summed
    in stage order, three products a stage, and the chunks' sums added in
    chunk order.  Returns ``(P1, P2, P3, P4)``."""
    n = re.shape[0]
    lanes = 128
    K = n - hw
    R = -(-K // lanes)
    w = lanes + 2 * hw
    chunk_rows, chunks = TQS.panel_chunking(n, hw)
    rows = R + STAGE_ROWS
    pad = torch.nn.functional.pad

    def a_rows(p):                                   # [rows, 128]
        return pad(p[:K], (0, rows * lanes - K)).reshape(rows, lanes)

    def b_rows(p):                                   # [rows, w]
        flat = pad(p, (hw, rows * lanes + w - n - hw))
        return flat.unfold(0, w, lanes)[:rows]

    A = torch.cat([a_rows(re), a_rows(im)], 1)       # [rows, 256]
    B = torch.cat([b_rows(re), b_rows(im)], 1)       # [rows, 2w]
    ah, al = _tf32.split(A)
    bh, bl = _tf32.split(B)
    total = torch.zeros(2 * lanes, 2 * w)
    for c in range(chunks):
        r_begin = c * chunk_rows
        r_end = min(r_begin + chunk_rows, R)
        s = torch.zeros(2 * lanes, 2 * w)
        for r0 in range(r_begin, r_end, STAGE_ROWS):
            r1 = min(r0 + STAGE_ROWS, r_end)          # A is zero past r_end
            s = s + _tf32.dot3(ah[r0:r1].T, al[r0:r1].T, bh[r0:r1],
                               bl[r0:r1])
        total = total + s
    return (total[:lanes, :w], -total[:lanes, w:], total[lanes:, :w],
            -total[lanes:, w:])


@pytest.mark.parametrize("hw", [51, 64])
def test_replayed_kernel_arithmetic_matches_jax_kernel(hw):
    rng = np.random.default_rng(hw)
    N = 2 * TQS.IN_PER_STEP
    re, im = (rng.normal(size=N).astype(np.float32) for _ in range(2))
    want = JQS.qpsk_panels(jnp.asarray(re), jnp.asarray(im), hw,
                           interpret=True)
    got = replay_panels(torch.from_numpy(re), torch.from_numpy(im), hw)
    exact = tdemod.corr_panels(torch.from_numpy(re).double(),
                               torch.from_numpy(im).double(), hw)
    scale = max(float(np.abs(np.asarray(p)).max()) for p in want[:4])
    for g, w, e in zip(got, want[:4], exact[:4]):
        assert g.shape == w.shape == (128, 128 + 2 * hw)
        assert np.max(np.abs(g.numpy() - np.asarray(w))) < TOL_PANEL * scale
        # 3xTF32 with float32 sums: ~3.7e-7 of the float64 panels
        assert float((g.double() - e).abs().max()) < 1e-6 * scale


def fragment_bank_ways(stride: int) -> int:
    """The most distinct 4-byte words that one warp's A fragment load of
    the panel kernel puts into one of the 32 shared-memory banks: lane
    (g, t), g = lane / 4, t = lane % 4, reads raw row t (and, in other
    loads, t + 4) at column g + const of a stage whose rows are
    ``stride`` floats apart.  1 means conflict-free."""
    lane = np.arange(32)
    worst = 1
    for row0 in (0, 4):
        for col0 in range(0, 128, 8):
            words = np.unique((row0 + lane % 4) * stride + col0 + lane // 4)
            worst = max(worst, int(np.bincount(words % 32).max()))
    return worst


def split_store_bank_ways(swizzle: bool) -> int:
    """The most distinct 4-byte words that one phase (8 lanes) of the
    panel kernel's 16-byte split stores puts into one bank: lane n writes
    k chunk Q of row n of B^T at byte n * 128 + (Q ^ (n % 8)) * 16 (the
    128-byte swizzle of csrc/qpsk_sym.cu), or at n * 128 + Q * 16
    unswizzled.  1 means conflict-free."""
    worst = 1
    for Q in range(STAGE_ROWS // 4):
        for n0 in range(0, 128, 8):
            n = n0 + np.arange(8)
            chunk = (Q ^ (n % 8)) if swizzle else np.full(8, Q)
            words = ((n * 128 + chunk * 16)[:, None] // 4 + np.arange(4))
            w = np.unique(words)
            worst = max(worst, int(np.bincount(w % 32).max()))
    return worst


def test_panel_shared_memory_accesses_are_bank_conflict_free():
    # A fragments from raw rows 136 floats apart; rows 128 apart: 4-way
    assert fragment_bank_ways(RAW_A_STRIDE) == 1
    assert fragment_bank_ways(128) == 4
    # B's split stores into the swizzled rows; unswizzled: 8-way
    assert split_store_bank_ways(True) == 1
    assert split_store_bank_ways(False) == 8


@pytest.mark.parametrize("n", [TQS.IN_PER_STEP, 2 * TQS.IN_PER_STEP,
                               3 * TQS.IN_PER_STEP, 1 << 22, 1 << 25])
def test_panel_chunking_fills_the_card(n):
    # every N of the main paths (the tests, the sharded receiver's 2^22
    # shards, the 2^25 capture) gives >= 2 x 132 blocks of 8 tiles a chunk
    # and no empty chunk
    hw = 51
    R = -(-(n - hw) // 128)
    rows, chunks = TQS.panel_chunking(n, hw)
    assert chunks * rows >= R > (chunks - 1) * rows
    assert 8 * chunks >= 2 * 132
    assert chunks <= 70
