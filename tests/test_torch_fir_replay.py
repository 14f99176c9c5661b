"""K4, the dense streaming FIR, as the decimating-FIR kernel runs it at
D = 1 (kernels/fir.py on csrc/decim_fir.cu), replayed on the CPU through
tests/_k2_replay.py: shared memory and blocks an SM at every tap count up
to 1025, where each window sample comes from (the 1024-sample context
read flat from its [8, 128] planes, the plane, or a zero), the ring's
conflict-free loads, the products summed in the kernel's order against
the plain version and the JAX package's Pallas kernel in interpret mode,
and the context the launch writes for the next call."""

import functools

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from _k2_replay import (K4_CTX, MIN_BLOCKS_SM, SMEM_LIMIT, THREADS_MAX,
                        Shape, blocks_per_sm, copy_wavefronts, gather,
                        k4_replay, load_wavefronts, next_context, partition,
                        smem_bytes, window_sources)
from comms_tpu.kernels import fir_pallas as JFP
from comms_tpu_torch.kernels import decim_fir as TDF
from comms_tpu_torch.kernels import fir as TFK

# float32 in another summation order than the plain version's (numpy
# rounds each product, the kernel fuses it), and the JAX kernel's bf16x3
# products (tests/test_torch_fir_kernel.py).
TOL = 5e-5
TAPS = [1, 2, 31, 32, 33, 129, 257, 1024, 1025]
N = 3 * 1024             # 64 threads: 7 tiles of 448, the last partial


def _err(got, want):
    g = np.asarray(got[0]) + 1j * np.asarray(got[1])
    w = np.asarray(want[0]) + 1j * np.asarray(want[1])
    assert g.shape == w.shape
    return float(np.abs(g - w).max() / np.abs(w).max())


@functools.lru_cache(maxsize=None)
def _inputs(T, cplx, n, seed):
    rng = np.random.default_rng(seed)
    xr, xi = rng.normal(size=(2, n)).astype(np.float32)
    cr, ci = rng.normal(size=(2, 8, 128)).astype(np.float32)
    h = rng.normal(size=T)
    if cplx:
        h = h + 1j * rng.normal(size=T)
    return xr, xi, cr, ci, h


class _Lib:
    """The library's shared-memory entry, from the replay."""

    @staticmethod
    def decim_fir_smem_bytes(MD, D, threads, cplx):
        return smem_bytes(MD, D, threads, cplx)


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("T", TAPS)
def test_k4_shared_memory_fits_at_full_blocks(T, cplx):
    smem = smem_bytes(T, 1, THREADS_MAX, cplx)
    assert smem <= SMEM_LIMIT
    # at the launch bound's registers (65,536 / (4 x 128) = 128)
    assert blocks_per_sm(THREADS_MAX, smem, 128) >= 1
    if T <= 257:
        assert blocks_per_sm(THREADS_MAX, smem, 128) >= MIN_BLOCKS_SM
    # the wrapper's plan keeps 128 threads at the main path's size, and
    # its blocks walk every tile once
    for n in (N, 33554432):
        threads, tiles, blocks = TDF.partition(n, 1, 1,
                                               run_blocks=TFK._RUN_BLOCKS)
        assert TDF._launch_plan(_Lib, T, 1, int(cplx), n, 1,
                               TFK._RUN_BLOCKS) == (threads, blocks)
        walked = sorted(t for b in range(blocks)
                        for t in range(b, tiles, blocks))
        assert walked == list(range(tiles))
    assert (threads, blocks) == (THREADS_MAX, TFK._RUN_BLOCKS)


@pytest.mark.parametrize("T", TAPS)
def test_k4_each_product_reads_its_sample(T):
    # plane sample n is n + 1, context sample c of the flat 1024 is -(c+1)
    xr = np.arange(1, N + 1, dtype=np.float32)[None]
    c = -np.arange(1, K4_CTX + 1, dtype=np.float32)
    flat = c.reshape(8, 128).reshape(1, K4_CTX)
    ctx = (flat, -flat)
    gr, gi, idx = gather(xr, -xr, ctx, T, 1)
    want_idx = np.arange(N)[:, None] - np.arange(T)[None, :]
    assert np.array_equal(idx[0], want_idx)
    want = np.where(want_idx < 0,
                    c[np.clip(K4_CTX + want_idx, 0, K4_CTX - 1)],
                    xr[0][np.clip(want_idx, 0, None)])
    assert np.array_equal(gr[0], want) and np.array_equal(gi[0], -want)
    # no product reads a zero fill: the deepest read is sample 1 - T,
    # inside the context's last T - 1 samples
    blocks, threads = partition(N, 1, 1)
    s = Shape(T, 1, threads, N, 1, K4_CTX)
    for tile in range(s.tiles):
        w_idx, src = window_sources(s, tile)
        f0 = tile * s.S
        lo, hi = f0 - (T - 1), min(f0 + s.S, N)
        read = (w_idx >= lo) & (w_idx < hi)
        assert np.all(src[read] != 2)
        assert np.all((src[read] == 1) == (w_idx[read] < 0))


@pytest.mark.parametrize("T", TAPS)
def test_k4_ring_loads_are_conflict_free(T):
    for threads in (64, THREADS_MAX):
        worst, floor = load_wavefronts(T, 1, threads)
        assert worst == floor                # every sample load
        worst_c, floor_c = copy_wavefronts(T, 1, threads)
        assert worst_c == floor_c            # an interior tile's copies


@pytest.mark.parametrize("cplx", [False, True])
@pytest.mark.parametrize("T", TAPS)
def test_k4_replay_matches_plain(T, cplx):
    xr, xi, cr, ci, h = _inputs(T, cplx, N, T)
    got = k4_replay(xr, xi, h, cr, ci)
    want = TFK.fir_plain(*(torch.from_numpy(a) for a in (xr, xi)), h,
                         *(torch.from_numpy(a) for a in (cr, ci)))
    assert _err(got, [w.numpy() for w in want]) < TOL


@pytest.mark.parametrize("T,cplx", [(32, False), (257, True)])
def test_k4_replay_matches_jax_kernel(T, cplx):
    n = 4 * 1024
    xr, xi, cr, ci, h = _inputs(T, cplx, n, 300 + T)
    want = JFP.fir_planar_pallas(jnp.asarray(xr), jnp.asarray(xi), h,
                                 jnp.asarray(cr), jnp.asarray(ci),
                                 tile_rows=8, interpret=True)
    got = k4_replay(xr, xi, h, cr, ci)
    assert _err(got, (np.asarray(want[0]), np.asarray(want[1]))) < TOL


@pytest.mark.parametrize("T,cplx", [(32, False), (1025, True)])
def test_k4_next_context_and_chained_halves(T, cplx):
    """The context the launch writes (the flat row's last 1024 samples)
    is, as [8, 128] planes, the tail the wrapper returned before; fed to
    the next call it reproduces the one-shot replay bit for bit."""
    xr, xi, cr, ci, h = _inputs(T, cplx, 2 * N, 400 + T)
    nr = next_context(xr, 1, K4_CTX).reshape(8, 128)
    tr, _ = TFK.planar_ctx_from_tail(torch.from_numpy(xr),
                                     torch.from_numpy(xi))
    assert np.array_equal(nr, tr.numpy())
    _, _, wr, wi = TFK.fir_planar(torch.from_numpy(xr), torch.from_numpy(xi),
                                  h, torch.from_numpy(cr),
                                  torch.from_numpy(ci), tile_rows=8)
    assert np.array_equal(nr, wr.numpy())
    assert np.array_equal(next_context(xi, 1, K4_CTX).reshape(8, 128),
                          wi.numpy())
    one = k4_replay(xr, xi, h, cr, ci)
    a = k4_replay(xr[:N], xi[:N], h, cr, ci)
    b = k4_replay(xr[N:], xi[N:], h,
                  next_context(xr[:N], 1, K4_CTX).reshape(8, 128),
                  next_context(xi[:N], 1, K4_CTX).reshape(8, 128))
    assert np.array_equal(one[0], np.concatenate([a[0], b[0]]))
    assert np.array_equal(one[1], np.concatenate([a[1], b[1]]))


def test_k4_other_devices_raise():
    z = torch.zeros(1024, device="meta")
    c = torch.zeros(8, 128, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TFK.fir_planar(z, z, np.ones(5), c, c, tile_rows=8)
