"""The channelizer kernel's plan replayed on the CPU (``k8_replay`` in
tests/_k8_replay.py: the kernel's partition, branch relabelling and sum
order, radix split, twiddle indices and pass order in float32 numpy),
held to the JAX package's Pallas kernel in interpret mode and to a
float64 channelizer, before any card runs it; and the kernel's launch
arithmetic: shared memory and thread coverage at every K | 128 and M <= 16,
the partition, and its shared-memory bank patterns."""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from _k8_replay import (MAX_TAPS, POINTS, RUN, SMEM_LIMIT, SMEM_SM, SRC,
                        THREADS, buffer_words, f64_channelize, geometry,
                        k8_replay, partition, row_word, smem_bytes, u_word,
                        unit_word, wavefronts)
from comms_tpu.kernels import channelizer_pallas as JCP
from comms_tpu_torch.kernels import channelizer as TCK
from comms_tpu_torch.ops import channelizer as tchan

# The JAX kernel's bf16x3 DFT products are ~1e-5 relative; its own
# parity bound (tests/test_channelizer_pallas.py).
TOL = 1e-5
# float32 against float64, relative to the largest output: a few float32
# roundings of the branch sums and log2(K) FFT passes (the replay measures
# 0.4e-7..1.8e-7 here).
TOL_F64 = 5e-7

KS = (2, 4, 8, 16, 32, 64, 128)
CASES = [(k, m) for k in KS for m in (1, 8, 16)
         if k * m <= TCK.CTX_SAMPLES + 1]


@functools.lru_cache(maxsize=None)
def _inputs(k, m, start):
    """Two blocks of step_samples() white noise, the context (zero, or the
    noise before them) and the JAX kernel's output, made once."""
    rng = np.random.default_rng(100 * k + m + (start == "zero"))
    N = 2 * TCK.step_samples()
    re_, im_ = rng.normal(size=(2, N)).astype(np.float32)
    if start == "zero":
        cr = ci = np.zeros(TCK.CTX_SAMPLES, np.float32)
    else:
        cr, ci = rng.normal(size=(2, TCK.CTX_SAMPLES)).astype(np.float32)
    h = tchan.design_prototype(k, m)
    want = JCP.channelize_pallas_planar(
        jnp.asarray(re_), jnp.asarray(im_), h, jnp.asarray(cr),
        jnp.asarray(ci), num_channels=k, interpret=True)
    return re_, im_, cr, ci, h, np.asarray(want[0]), np.asarray(want[1])


@pytest.mark.parametrize("start", ["zero", "mid_stream"])
@pytest.mark.parametrize("k,m", CASES)
def test_k8_replay_matches_jax_kernel_and_float64(k, m, start):
    re_, im_, cr, ci, h, wr, wi = _inputs(k, m, start)
    yr, yi, made = k8_replay(re_, im_, h, cr, ci, k)
    assert np.all(made == 1)
    assert yr.shape == wr.shape == (re_.shape[0] // k, k)
    scale = max(np.abs(wr).max(), np.abs(wi).max())
    assert np.abs(yr - wr).max() < TOL * scale
    assert np.abs(yi - wi).max() < TOL * scale
    f = f64_channelize(re_, im_, h, cr, ci, k)
    fs = max(np.abs(f.real).max(), np.abs(f.imag).max())
    assert max(np.abs(yr - f.real).max(), np.abs(yi - f.imag).max()) \
        < TOL_F64 * fs
    # the wrapper's plain version (CPU tensors) agrees with it
    t = [torch.from_numpy(a) for a in (re_, im_, cr, ci)]
    pr, pi, _, _ = TCK.channelize_planar(t[0], t[1], h, t[2], t[3], k)
    assert np.abs(pr.numpy() - yr).max() < TOL * scale
    assert np.abs(pi.numpy() - yi).max() < TOL * scale


@pytest.mark.parametrize("k", [2, 16, 64, 128])
@pytest.mark.parametrize("blocks", [1, 2, 3, 7, None])
def test_k8_partition_makes_every_tile_once_and_same_bits(k, blocks):
    # Block b walks tiles b, b + blocks, ...: each tile once, whatever the
    # block count, and every tile's output the same bits.
    re_, im_, cr, ci, h, _, _ = _inputs(k, 8, "mid_stream")
    ref = k8_replay(re_, im_, h, cr, ci, k, blocks=1)
    got = k8_replay(re_, im_, h, cr, ci, k, blocks=blocks)
    assert np.all(got[2] == 1)
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


@pytest.mark.parametrize("steps", [1, 2, 129, 1024, 1056, 1057, 4096])
@pytest.mark.parametrize("k", [2, 16, 64, 128])
def test_k8_partition_arithmetic(k, steps):
    F = geometry(k)[0]
    frames = steps * TCK.step_samples() // k
    tiles = frames // F
    T, run, blocks = TCK.partition(frames, k)
    assert T == F and tiles * F == frames
    assert 1 <= blocks <= min(tiles, TCK._RUN_BLOCKS)
    walks = partition(tiles, blocks)
    assert max(len(w) for w in walks) == run
    assert min(len(w) for w in walks) >= 1
    seen = np.zeros(tiles, int)
    for w in walks:
        seen[w] += 1
    assert np.all(seen == 1)


@pytest.mark.parametrize("k", KS)
def test_k8_launch_fits(k):
    # Every M <= 16 fits two blocks an SM (227 KB a block at most); 256
    # threads hold a tile's 16 points each in the DFT, and one branch and
    # a run of 16 frames each in the branch sums, with at most 16 taps.
    F, P, FPT, _ = geometry(k)
    assert THREADS == 256 and POINTS * THREADS == F * k
    assert k * (F // RUN) == THREADS and F % RUN == 0
    assert MAX_TAPS == 16 and F >= MAX_TAPS
    assert FPT * k == 16 or P * 16 == k
    for M in range(1, MAX_TAPS + 1):
        b = smem_bytes(k, M)
        assert b <= SMEM_LIMIT and 2 * (b + 1024) <= SMEM_SM, (k, M, b)
    assert "__launch_bounds__(kThreads, 2)" in SRC


@pytest.mark.parametrize("k", KS)
def test_k8_shared_memory_banks(k):
    # One warp's accesses, in wavefronts (a 128-bit access takes 4 when free
    # of conflicts, a 64-bit one 2, a 32-bit one 1).  Window reads of the
    # branch threads (lane n of run r reads row 16 r + s, one row later for
    # n = 0) and the DFT threads' loads and exchanges are conflict-free; the
    # branch threads' U stores are 2-way at K = 16 and up to 4-way below it
    # (32/K runs a warp; K < 16 is on no main path).
    F, P, FPT, _ = geometry(k)
    lanes = np.arange(32)
    for warp in range(THREADS // 32):
        tw = 32 * warp + lanes
        r, n = tw // k, tw % k
        for s in (0, 7, 14, 15, 16, 29):
            q = RUN * r + s + (n == 0)
            words = [row_word(k, int(a)) + int(b) for a, b in zip(q, n)]
            assert wavefronts(words, 1) <= (1 if s != 15 else 2), (warp, s)
        for j in (0, 1, 5, 15):
            words = [u_word(k, RUN * int(a) + j, int(b)) for a, b in zip(r, n)]
            worst = 1 if k >= 32 else (2 if k == 16 else 4)
            assert wavefronts(words, 1) <= worst, (warp, j)
        tau = tw
        for u in range(4):
            if k <= 16:
                words = 20 * tau + 4 * u
            else:
                words = [unit_word(k, int(t) // P, int(t) % P, u)
                         for t in tau]
            assert wavefronts(words, 4) == 4
        if k <= 16:                          # the pairs' output units
            for kk in range(4):
                unit = 2 * kk + (tau & 1)
                words = 20 * ((tau - (tau & 1)) + (unit >> 2)) \
                    + 4 * (unit & 3)
                assert wavefronts(words, 4) == 4
        else:                                # the exchange reads
            m, tp = tau // P, tau % P
            for tt in range(P):
                if P == 2:
                    for i in range(2):
                        words = [unit_word(k, int(a), tt, int(b) + 2 * i)
                                 for a, b in zip(m, tp)]
                        assert wavefronts(words, 4) == 4
                elif P == 4:
                    words = [unit_word(k, int(a), tt, int(b))
                             for a, b in zip(m, tp)]
                    assert wavefronts(words, 4) == 4
                else:
                    words = [unit_word(k, int(a), tt, int(b) >> 1)
                             + 2 * (int(b) & 1) for a, b in zip(m, tp)]
                    assert wavefronts(words, 2) == 2


def test_k8_u_layout_is_one_to_one():
    # put_u's words of a tile's U and the DFT threads' chunks cover each
    # (frame, branch) once, inside the buffer.
    for k in KS:
        F = geometry(k)[0]
        words = {u_word(k, m, n) for m in range(F) for n in range(k)}
        assert len(words) == F * k
        assert max(words) < buffer_words(k, 1)
