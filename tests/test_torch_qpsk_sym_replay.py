"""The QPSK symbol kernel's plan replayed on the CPU (tests/_k5_sym_replay.py:
its partition, windows, context and end-of-block quads, register-ring
reads, shared-memory layout and bank patterns, and its products summed
in order in float32 numpy), held to the plain version and, at one
262,144-sample step, to the JAX package's Pallas kernel in interpret
mode, before any card runs it."""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from _k5_sym_replay import (MD_MAX, MIN_BLOCKS_SM, R, RING, SMEM_LIMIT,
                            STEP_SYMS, THREADS_MAX, THREADS_MIN,
                            blocks_per_sm, copy_wavefronts, gather,
                            k5_sym_replay, load_wavefronts, partition,
                            ring_slots, smem_bytes, thread_reads)
from comms_tpu.kernels import qpsk_sym_pallas as JQS
from comms_tpu_torch.kernels import qpsk_sym as TQS

STEP = TQS.IN_PER_STEP
# float32 in another summation order than the plain version's (numpy
# rounds each product, the kernel fuses it): the card tests' bound.
TOL_SYM = 1e-4
# The JAX kernel against the port: the bound of tests/test_torch_qpsk_sym.py.
TOL_JAX = 1e-3
W, PHASE0 = 0.011, 0.31


@pytest.mark.parametrize("n", [STEP, 2 * STEP, 3 * STEP, 16 * STEP,
                               128 * STEP])
def test_partition_covers_every_symbol_once_within_a_step(n):
    blocks, S = partition(n)
    threads, tiles, nb = TQS.partition(n)
    assert S == R * threads and STEP_SYMS % S == 0
    assert THREADS_MIN <= threads <= THREADS_MAX
    assert len(blocks) == nb and tiles * S == n // 4
    starts = np.array(sorted(s for b in blocks for s in b))
    assert np.array_equal(starts, np.arange(0, n // 4, S))
    # no tile straddles a 65,536-symbol step
    assert np.all(starts // STEP_SYMS == (starts + S - 1) // STEP_SYMS)
    # enough tiles for two an SM where the call allows it
    assert tiles >= 264 or threads == THREADS_MIN


def test_ring_holds_each_window_quad_for_its_steps():
    # step q loads quad u = 0 into the slot ring quad u = R left at q - 1
    for M in (1, 4, 11, 32, 33):
        slots, loads = ring_slots(M)
        for q in range(1, M):
            assert loads[q] == slots[q - 1][R]
        assert all(len(set(row)) == RING for row in slots)


@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("md", [4, 8, 44, 128, 132])
def test_each_product_reads_its_sample(md, with_ctx):
    n = STEP
    # distinct values: the context below 0 (zeros without one), zeros at
    # or past n
    xr = np.arange(1, n + 1, dtype=np.float32)
    ctx = (-np.arange(md - 1, 0, -1, dtype=np.float32),
           np.arange(md - 1, 0, -1, dtype=np.float32)) if with_ctx else None
    gr, gi, idx = gather(xr, -xr, ctx, md, n)
    s = np.arange(n // 4)[:, None]
    assert np.array_equal(idx, 4 * (s + 1) - np.arange(md)[None, :])
    past, below = idx >= n, idx < 0
    inner = xr[np.clip(idx, 0, n - 1)]
    head = (ctx[0][np.clip(md - 1 + idx, 0, md - 2)] if with_ctx
            else np.zeros_like(inner))
    want = np.where(past, 0, np.where(below, head, inner))
    assert np.array_equal(gr, want)
    assert np.array_equal(gi, -want)
    if with_ctx:
        # every symbol's deepest read is sample 5 - MD: ctx[4] onwards
        assert int(idx[0].min()) == 5 - md


def test_thread_reads_match_the_polyphase_form():
    # t = 4q reads element 0 of quad f + M - q, t = 4q + p (p > 0)
    # element 4 - p of quad f + M - 1 - q: relative to the window's first
    # sample 4(s0 - M + 1), symbol f + r reads 4(f + r + M) - t
    for M in (1, 11, 33):
        quad, elem = thread_reads(M)
        t = np.arange(4 * M)
        for r in range(R):
            assert np.array_equal(4 * quad[r] + elem[r], 4 * (r + M) - t)


@pytest.mark.parametrize("md", [4, 44, 132])
@pytest.mark.parametrize("threads", [64, 128, 256])
def test_shared_memory_fits_and_loads_are_conflict_free(threads, md):
    smem = smem_bytes(threads, md)
    assert smem <= SMEM_LIMIT
    # at the launch bound's registers (65,536 / (2 x 256) = 128) and at
    # the 80 the design aims for
    assert blocks_per_sm(threads, md, 128) >= MIN_BLOCKS_SM * 256 // threads
    assert blocks_per_sm(256, MD_MAX, 80) == 3
    worst, mean = load_wavefronts(threads, md)
    assert worst == 4 and mean == 4          # conflict-free LDS.128
    # an interior tile's copies: the swizzle permutes each aligned group
    # of 8 quads, so they are conflict-free too (a warp's last partial
    # copy takes fewer wavefronts)
    worst_c, mean_c = copy_wavefronts(threads, md)
    assert worst_c == 4 and mean_c <= 4


@functools.lru_cache(maxsize=None)
def _inputs(md, with_ctx, n=STEP):
    rng = np.random.default_rng(md + 7 * with_ctx)
    xr, xi = rng.normal(size=(2, n)).astype(np.float32)
    fr, fi = rng.normal(size=(2, md)).astype(np.float32)
    ctx = tuple(rng.normal(size=(2, md - 1)).astype(np.float32)) \
        if with_ctx else None
    return xr, xi, fr, fi, ctx


def _err(got, want):
    g = got[0] + 1j * got[1]
    w = want[0] + 1j * want[1]
    return float(np.abs(g - w).max() / np.abs(w).max())


@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("md", [4, 44, 132])
def test_replay_matches_plain(md, with_ctx):
    xr, xi, fr, fi, ctx = _inputs(md, with_ctx)
    got = k5_sym_replay(xr, xi, fr, fi, W * 4, PHASE0, ctx)
    tctx = tuple(torch.from_numpy(c) for c in ctx) if ctx else None
    want = TQS.qpsk_symbol_plain(torch.from_numpy(xr), torch.from_numpy(xi),
                                 torch.from_numpy(fr), torch.from_numpy(fi),
                                 torch.tensor(W * 4, dtype=torch.float32),
                                 PHASE0, tctx)
    assert _err(got, [w.numpy() for w in want]) < TOL_SYM


@pytest.mark.parametrize("with_ctx", [False, True])
def test_replay_matches_jax_kernel(with_ctx):
    xr, xi, fr, fi, ctx = _inputs(44, with_ctx)
    jctx = tuple(jnp.asarray(c, jnp.float32) for c in ctx) if ctx else None
    wr, wi = JQS.qpsk_symbol_gemm(
        jnp.asarray(xr, jnp.float32), jnp.asarray(xi, jnp.float32),
        jnp.asarray(fr, jnp.float32), jnp.asarray(fi, jnp.float32),
        jnp.float32(W) * 4, phase0=PHASE0, ctx=jctx, interpret=True)
    got = k5_sym_replay(xr, xi, fr, fi, np.float32(W) * 4, PHASE0, ctx)
    assert _err(got, (np.asarray(wr, np.float32),
                      np.asarray(wi, np.float32))) < TOL_JAX
