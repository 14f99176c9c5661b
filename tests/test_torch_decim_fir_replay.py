"""The decimating-FIR kernel's plan replayed on the CPU (tests/_k2_replay.py:
its partition, windows, context and end-of-row samples, register-ring
reads, shared-memory layout and bank patterns, and its products summed
in order in float32 numpy), held to the plain version and to the JAX
package's Pallas kernels of both entries (decim_fir_pallas and
poly_fir_pallas) in interpret mode, before any card runs it."""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from _k2_replay import (D_MAX, MIN_BLOCKS_SM, R_OF_D, SMEM_LIMIT, STAGES,
                        THREADS_MAX, Shape, blocks_per_sm, copied_quads,
                        copy_wavefronts, gather, k2_replay, load_wavefronts,
                        partition, ring_slots, smem_bytes, store_wavefronts,
                        thread_reads, window_sources)
from comms_tpu.kernels import decim_fir_pallas as JDF
from comms_tpu.kernels import poly_fir_pallas as JPF
from comms_tpu_torch.kernels import decim_fir as TDF

# float32 in another summation order than the plain version's (numpy
# rounds each product, the kernel fuses it), and the JAX split entry's
# bf16x3 products: the card tests' bound
# (tests/test_torch_band_monitor_cuda.py).
TOL_FIR = 5e-5


def _err(got, want):
    g = np.asarray(got[0]) + 1j * np.asarray(got[1])
    w = np.asarray(want[0]) + 1j * np.asarray(want[1])
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / np.abs(w).max())


def test_plan_constants_match_the_wrapper():
    assert R_OF_D == TDF._R_OF_D and len(R_OF_D) == D_MAX + 1
    # odd: lanes R*D floats apart, free of bank conflicts (below)
    assert all(r % 2 == 1 for r in R_OF_D)
    assert max(TDF._THREADS) == THREADS_MAX and STAGES >= 1
    for d in range(1, 12):
        assert TDF.outputs_per_thread(d) == (R_OF_D[d] if d <= D_MAX
                                             else R_OF_D[0])


@pytest.mark.parametrize("n_out,rows,D", [(262144, 8, 4), (3350528, 1, 5),
                                          (1024, 1, 5), (16384, 4, 4),
                                          (1000, 3, 4), (4097, 2, 9)])
def test_partition_covers_every_output_once(n_out, rows, D):
    blocks, threads = partition(n_out, rows, D)
    s = Shape(D, D, threads, n_out * D, rows)
    seen = np.zeros((rows, n_out), np.int64)
    tiles = sorted(t for b in blocks for t in b)
    assert tiles == list(range(s.tiles))
    for t in tiles:
        row, f0 = t // s.tpr, (t % s.tpr) * s.S
        seen[row, f0:min(f0 + s.S, n_out)] += 1
    assert np.all(seen == 1)
    # enough tiles for two an SM where the call allows it
    assert s.tiles >= TDF._MIN_TILES or threads == min(TDF._THREADS)
    assert len(blocks) == min(s.tiles, TDF._RUN_BLOCKS)


def test_ring_holds_each_window_group_for_its_steps():
    # step q loads group u = 0 into the slot ring group u = R left at q - 1
    for R in sorted(set(R_OF_D)):
        for M in (1, 2, R, R + 1, 33, 129):
            slots, loads = ring_slots(M, R)
            for q in range(1, M):
                assert loads[q] == slots[q - 1][R]
            assert all(len(set(row)) == R + 1 for row in slots)


@pytest.mark.parametrize("D", list(range(1, D_MAX + 1)) + [9, 12])
def test_thread_reads_match_the_polyphase_form(D):
    # relative to the window's first sample (f0 - M)*D, output a + r reads
    # sample (a + r + M)*D - t at tap t
    for M in (1, 3, 8, 129):
        s = Shape(M * D, D, 64)
        reads = thread_reads(s)
        t = np.arange(s.MD)
        for r in range(s.R):
            assert np.array_equal(reads[r], (r + M) * D - t)


def _case(D, entry):
    """Taps (most of the entry at D) and context length."""
    if entry == "k2":
        return TDF.max_taps(D), D * 128
    return D * 128 + 1, TDF.CTX_ROWS * D * 128


@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("D,entry", [(d, "k2") for d in range(1, D_MAX + 1)]
                         + [(5, "k3"), (8, "k3"), (10, "k2")])
def test_each_product_reads_its_sample(D, entry, with_ctx):
    T, L = _case(D, entry)
    MD = D * -(-T // D)
    rows, n_in = 2, D * (700 + 3 * D)         # a partial last tile a row
    xr = (np.arange(rows * n_in, dtype=np.float32) + 1).reshape(rows, n_in)
    ctx = None
    if with_ctx:
        c = -(np.arange(rows * L, dtype=np.float32) + 1).reshape(rows, L)
        ctx = (c, -c)
    gr, gi, idx = gather(xr, -xr, ctx, MD, D)
    f = np.arange(n_in // D)[None, :, None]
    assert np.array_equal(idx, np.broadcast_to(
        f * D - np.arange(MD)[None, None, :], idx.shape))
    row = np.arange(rows)[:, None, None]
    inner = xr[row, np.clip(idx, 0, n_in - 1)]
    head = ctx[0][row, np.clip(L + idx, 0, L - 1)] if with_ctx else 0
    want = np.where(idx < 0, head, inner)
    assert np.array_equal(gr, want) and np.array_equal(gi, -want)
    if with_ctx:
        # the deepest read is sample 1 - MD: the context's last MD - 1
        assert int(idx.min()) == 1 - MD and L - (MD - 1) >= 0


def test_windows_copy_interior_quads_and_build_the_edges():
    s = Shape(32, 4, 128, 4 * 5000, 2, 512)
    for tile in range(s.tiles):
        idx, src = window_sources(s, tile)
        k_lo, k_hi = copied_quads(s, tile)
        # the copied quads lie wholly inside the row, the others hold
        # context, zeros or (at a row's last tile) its last samples
        assert np.all(src[k_lo:k_hi] == 0)
        inner = (tile % s.tpr) not in (0, s.tpr - 1)
        assert (k_lo, k_hi) == (0, s.nq) or not inner
        assert np.all(src[:k_lo] != 0)


@pytest.mark.parametrize("threads", [64, 128])
@pytest.mark.parametrize("D", list(range(1, D_MAX + 1)))
def test_shared_memory_fits_and_loads_are_conflict_free(D, threads):
    entries = ["k2"] + (["k3"] if D >= 2 else [])
    for entry in entries:
        T, _ = _case(D, entry)
        MD = D * -(-T // D)
        for cplx in (False, True):
            smem = smem_bytes(MD, D, threads, cplx)
            assert smem <= SMEM_LIMIT
            # at the launch bound's registers (65,536 / (4 x 128) = 128)
            assert blocks_per_sm(threads, smem, 128) >= 1
        for md in sorted({D, 32 // D * D or D, MD}):
            worst, floor = load_wavefronts(md, D, threads)
            assert worst == floor                # every group load
            worst_c, floor_c = copy_wavefronts(md, D, threads)
            assert worst_c == floor_c            # an interior tile's copies
    assert store_wavefronts(D) == (1, 1)
    # the band monitor's shape (32 taps at D = 4) keeps MIN_BLOCKS_SM
    # blocks of 128 an SM at the launch bound's registers
    if D == 4:
        smem = smem_bytes(32, 4, THREADS_MAX, False)
        assert blocks_per_sm(THREADS_MAX, smem, 128) >= MIN_BLOCKS_SM


@functools.lru_cache(maxsize=None)
def _inputs(D, T, cplx, rows, n_in, L, seed):
    rng = np.random.default_rng(seed)
    xr, xi = rng.normal(size=(2, rows, n_in)).astype(np.float32)
    cr, ci = rng.normal(size=(2, rows, L)).astype(np.float32)
    h = rng.normal(size=T)
    if cplx:
        h = h + 1j * rng.normal(size=T)
    return xr, xi, cr, ci, h


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("D", list(range(1, D_MAX + 1)))
def test_replay_matches_plain(D, cplx):
    T = TDF.max_taps(D)
    xr, xi, cr, ci, h = _inputs(D, T, cplx, 2, D * 1200, D * 128, D)
    got = k2_replay(xr, xi, h, D, (cr, ci))
    want = TDF.fir_decimate_plain(*(torch.from_numpy(a) for a in (xr, xi)),
                                  h, D,
                                  *(torch.from_numpy(a) for a in (cr, ci)))
    assert _err(got, [w.numpy() for w in want]) < TOL_FIR


@pytest.mark.parametrize("D,T,cplx", [(4, 32, False), (5, 63, True),
                                      (1, 129, False), (8, 1024, False)])
def test_replay_matches_jax_decim_fir_kernel(D, T, cplx):
    n_in = 16 * D * 128
    xr, xi, cr, ci, h = _inputs(D, T, cplx, 1, n_in, D * 128, 100 + D)
    if D == 4 and T == 32:
        h = np.hanning(T).astype(np.float32)
    want = JDF.fir_decimate_planar_pallas(
        jnp.asarray(xr[0]), jnp.asarray(xi[0]), h, D, jnp.asarray(cr),
        jnp.asarray(ci), tile_rows=16, interpret=True)
    got = k2_replay(xr, xi, h, D, (cr, ci))
    assert _err((got[0][0], got[1][0]), (np.asarray(want[0]),
                                         np.asarray(want[1]))) < TOL_FIR


@pytest.mark.parametrize("D,T,cplx", [(5, 63, False), (5, 641, False),
                                      (3, 385, True)])
def test_replay_matches_jax_poly_fir_kernel(D, T, cplx):
    n = TDF.step_samples(D)
    L = TDF.CTX_ROWS * D * 128
    xr, xi, cr, ci, h = _inputs(D, T, cplx, 1, n, L, 200 + T)
    x = (xr[0] + 1j * xi[0]).astype(np.complex64)
    ctx = (cr[0] + 1j * ci[0]).astype(np.complex64)
    want, _ = JPF.poly_fir_pallas(jnp.asarray(x), h, jnp.asarray(ctx), D,
                                  interpret=True)
    want = np.asarray(want)
    got = k2_replay(xr, xi, h, D, (cr, ci))
    assert _err((got[0][0], got[1][0]), (want.real, want.imag)) < TOL_FIR
