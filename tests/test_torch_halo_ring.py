"""The ring halo exchange (K12): comms_tpu_torch.kernels.halo_ring and
parallel.sharding.halo_exchange against the JAX package's
``halo_exchange_rdma`` (its Pallas RDMA ring under the TPU interpret
mode, as tests/test_sharding.py runs it) and ``halo_exchange`` on the
8-device CPU mesh, with the same numpy inputs.  On the CPU the wrapper
runs the plain version, because the tensors lie on the CPU; the kernel
itself is held to the plain version on the card by
tests/test_torch_halo_ring_cuda.py and chip_smoke.py.  A halo exchange
moves values and computes nothing, so every comparison is exact."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import shard_map
from jax.experimental.pallas import tpu as pltpu
from jax.sharding import PartitionSpec as P

from comms_tpu.kernels import halo_rdma
from comms_tpu.parallel import sharding as jsh
from comms_tpu_torch.kernels import halo_ring as HR
from comms_tpu_torch.parallel import sharding as tsh

import _k12_replay as k12_replay

N_DEV = 8
HALO = 12


def _data(dtype, seed):
    rng = np.random.default_rng(seed)
    if dtype is np.complex64:
        x = (rng.normal(size=N_DEV * 64)
             + 1j * rng.normal(size=N_DEV * 64)).astype(dtype)
        ctx = (rng.normal(size=HALO) + 1j * rng.normal(size=HALO)).astype(
            dtype)
    else:
        x = rng.normal(size=N_DEV * 64).astype(dtype)
        ctx = rng.normal(size=HALO).astype(dtype)
    return x, ctx


def _jax_exchange(fn, x, ctx):
    mesh = jsh.time_mesh(N_DEV)
    kw = dict(mesh=mesh, in_specs=(P("time"), P()), out_specs=P("time"),
              check_vma=False)
    return np.asarray(jax.jit(shard_map(fn, **kw))(jnp.asarray(x),
                                                   jnp.asarray(ctx)))


@pytest.mark.parametrize("route", ["rdma", "ppermute"])
@pytest.mark.parametrize("dtype", [np.float32, np.complex64])
def test_halo_exchange_matches_jax(route, dtype):
    x, ctx = _data(dtype, 5)
    if route == "rdma":
        want = _jax_exchange(lambda xl, c: jsh.halo_exchange_rdma(
            xl, c, HALO, interpret=pltpu.InterpretParams()), x, ctx)
    else:
        want = _jax_exchange(lambda xl, c: jsh.halo_exchange(xl, c, HALO),
                             x, ctx)
    mesh = tsh.time_mesh(N_DEV, device="cpu")
    xt = torch.from_numpy(x)
    launches = HR.launches
    got = tsh.halo_exchange(tsh.shard(xt, mesh, ("time",)),
                            torch.from_numpy(ctx), HALO, mesh)
    assert HR.launches == launches          # CPU tensors: no kernel
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    # the JAX name is the same function in the port
    got_r = tsh.halo_exchange_rdma(tsh.shard(xt, mesh, ("time",)),
                                   torch.from_numpy(ctx), HALO, mesh)
    np.testing.assert_array_equal(torch.cat(got_r).numpy(), want)


def test_ring_wrap_form_matches_jax_kernel():
    # K12's own contract: shard 0 receives shard n-1's tail.
    x, _ = _data(np.float32, 6)
    mesh = jsh.time_mesh(N_DEV)
    fn = shard_map(lambda xl: halo_rdma.ring_halo_exchange(
        xl[-HALO:], HALO, interpret=pltpu.InterpretParams()), mesh=mesh,
        in_specs=(P("time"),), out_specs=P("time"), check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    xs = list(torch.from_numpy(x).chunk(N_DEV))
    got = HR.ring_halo_exchange(xs, HALO)
    np.testing.assert_array_equal(torch.cat(got).numpy(), want)
    np.testing.assert_array_equal(
        torch.cat(HR.ring_halo_exchange_plain(xs, HALO)).numpy(), want)


@pytest.mark.parametrize("dtype", [torch.float32, torch.complex64,
                                   torch.uint8])
def test_exchange_rings_and_planes(dtype):
    # several rings (2-D columns, planes) in one call, ctx and wrap forms,
    # against the index rule out[r][i] = rings[r][i-1][-halo:].
    g = torch.Generator().manual_seed(3)
    rings = [[(torch.rand(9, 3, generator=g) * 200).to(dtype)
              for _ in range(4)] for _ in range(3)]
    ctxs = [(torch.rand(2, 3, generator=g) * 200).to(dtype)
            for _ in range(3)]
    for c in (None, ctxs):
        got = HR.exchange(rings, 2, c)
        for r, ring in enumerate(rings):
            first = ring[-1][-2:] if c is None else c[r]
            assert torch.equal(got[r][0], first)
            for i in range(1, 4):
                assert torch.equal(got[r][i], ring[i - 1][-2:])
                assert got[r][i].data_ptr() != ring[i - 1].data_ptr()


def test_exchange_validations():
    xs = [torch.zeros(4) for _ in range(3)]
    with pytest.raises(ValueError, match="exceeds"):
        HR.ring_halo_exchange(xs, 5)
    with pytest.raises(ValueError, match="dtype"):
        HR.ring_halo_exchange(xs[:2] + [torch.zeros(4, dtype=torch.int32)], 1)
    with pytest.raises(ValueError, match="ctx"):
        HR.ring_halo_exchange(xs, 2, ctx=torch.zeros(3))
    with pytest.raises(ValueError, match="CUDA or CPU"):
        HR.ring_halo_exchange([torch.zeros(4, device="meta")] * 2, 1)
    with pytest.raises(ValueError, match="later slice"):
        HR.ring_halo_exchange([torch.zeros(4), torch.zeros(4, device="meta")],
                              1)


def test_sharding_halo_rules():
    mesh = tsh.time_mesh(4, device="cpu")
    xs = tsh.shard(torch.arange(16.0), mesh, ("time",))
    ctx = torch.tensor([-1.0, -2.0])
    with pytest.raises(ValueError, match="exceeds per-shard length"):
        tsh.halo_exchange(xs, ctx, 5, mesh)
    assert all(h.shape == (0,) for h in tsh.halo_exchange(xs, ctx, 0, mesh))
    one = tsh.time_mesh(1, device="cpu")
    got = tsh.halo_exchange([torch.arange(4.0)], torch.tensor([7 + 1j]), 1,
                            one)
    assert torch.equal(got[0], torch.tensor([7.0]))   # complex ctx -> real
    # a strided tail is made contiguous before the ring reads it
    ys = [x[::2] for x in xs]
    got = tsh.halo_exchange(ys, ctx[:1], 1, mesh)
    assert [float(g) for g in got] == [-1.0, 2.0, 6.0, 10.0]


def test_multi_card_mesh_raises():
    with pytest.raises(ValueError, match="later slice"):
        tsh.Mesh(["cuda:0", "cuda:1"], (2,), ("time",))


@pytest.mark.parametrize("length,halo", [(25, 7), (37, 13), (41, 41)])
def test_exchange_u8_odd_lengths_match_jax(length, halo):
    # the fused chain's raw tails are u8 of an odd length (25,669 B): the
    # wrapped ring against the JAX kernel, the ctx form against
    # halo_exchange_rdma (the Pallas ring under the TPU interpret mode)
    rng = np.random.default_rng(length)
    x = rng.integers(0, 256, N_DEV * length).astype(np.uint8)
    ctx = rng.integers(0, 256, halo).astype(np.uint8)
    mesh = jsh.time_mesh(N_DEV)
    fn = shard_map(lambda xl: halo_rdma.ring_halo_exchange(
        xl[-halo:], halo, interpret=pltpu.InterpretParams()), mesh=mesh,
        in_specs=(P("time"),), out_specs=P("time"), check_vma=False)
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    xs = list(torch.from_numpy(x).chunk(N_DEV))
    np.testing.assert_array_equal(
        torch.cat(HR.ring_halo_exchange(xs, halo)).numpy(), want)
    want_ctx = _jax_exchange(lambda xl, c: jsh.halo_exchange_rdma(
        xl, c, halo, interpret=pltpu.InterpretParams()), x, ctx)
    got = HR.ring_halo_exchange(xs, halo, torch.from_numpy(ctx))
    np.testing.assert_array_equal(torch.cat(got).numpy(), want_ctx)


class _HostCopy:
    """Stands in for the kernel library on CPU tensors: the C entry's
    contract (2 k pointers packed as uint64, sources then destinations,
    every destination 16-byte aligned), each pair copied with memmove."""

    def __init__(self):
        self.calls = []

    def halo_ring_launch(self, ptrs, k, nbytes, stream):
        import ctypes
        import struct
        p = struct.unpack(f"{2 * k}Q", ptrs)
        assert 1 <= k <= HR.MAX_PAIRS and all(d % 16 == 0 for d in p[k:])
        for s, d in zip(p[:k], p[k:]):
            ctypes.memmove(d, s, nbytes)
        self.calls.append(k)
        return 0


def _byte_range(t):
    return t.data_ptr(), t.data_ptr() + t.numel() * t.element_size()


@pytest.mark.parametrize("trailing", [(), (3,)])
@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32,
                                   torch.complex64])
@pytest.mark.parametrize("form", ["wrap", "ctx", "rings"])
def test_kernel_path_destinations(form, dtype, trailing):
    # the wrapper's kernel path on CPU tensors with the copy done on the
    # host: the received tensors are rows of one buffer, contiguous, of the
    # right shape, 16-byte aligned, overlapping neither each other nor a
    # source, and equal to the plain version
    g = torch.Generator().manual_seed(7)
    n_rings = 3 if form == "rings" else 1
    rings = [[(torch.rand((29,) + trailing, generator=g) * 200).to(dtype)
              for _ in range(5)] for _ in range(n_rings)]
    ctxs = None
    if form != "wrap":
        ctxs = [(torch.rand((7,) + trailing, generator=g) * 200).to(dtype)
                for _ in range(n_rings)]
    lib = _HostCopy()
    n0 = HR.launches
    got = HR._launch(lib, 0, rings, 7, ctxs)
    assert HR.launches == n0 + 1 and lib.calls == [5 * n_rings]
    want = HR.exchange_plain(rings, 7, ctxs)
    rows = [a for ga in got for a in ga]
    sources = [_byte_range(x) for r in rings for x in r]
    sources += [_byte_range(c) for c in ctxs or []]
    spans = sorted(_byte_range(a) for a in rows)
    for (_, e0), (s1, _) in zip(spans, spans[1:]):
        assert e0 <= s1                              # no overlap
    for ga, wa in zip(got, want):
        for a, b in zip(ga, wa):
            assert torch.equal(a, b)
            assert a.is_contiguous() and a.shape == (7,) + trailing
            assert a.data_ptr() % 16 == 0
            lo, hi = _byte_range(a)
            assert all(hi <= s or e <= lo for s, e in sources)
    assert len({a.untyped_storage().data_ptr() for a in rows}) == 1


def test_kernel_path_pairs_over_launches():
    # 180 pairs: two launches of at most MAX_PAIRS pairs
    g = torch.Generator().manual_seed(8)
    rings = [[torch.rand(64, generator=g) for _ in range(60)]
             for _ in range(3)]
    lib = _HostCopy()
    got = HR._launch(lib, 0, rings, 31, None)
    assert lib.calls == [HR.MAX_PAIRS, 180 - HR.MAX_PAIRS]
    for ga, wa in zip(got, HR.exchange_plain(rings, 31)):
        assert all(torch.equal(a, b) for a, b in zip(ga, wa))


def test_kernel_path_tails():
    # a contiguous tail of a strided shard is read in place; a strided
    # tail raises (the sharding layer makes it contiguous first)
    x = torch.arange(40.0)
    xs = [x[i * 10:(i + 1) * 10:2] for i in range(4)]
    got = HR._launch(_HostCopy(), 0, [xs], 1, None)
    assert [float(t) for t in got[0]] == [38.0, 8.0, 18.0, 28.0]
    with pytest.raises(ValueError, match="contiguous"):
        HR._launch(_HostCopy(), 0, [xs], 2, None)


def test_kernel_path_size_limit():
    # the kernel indexes a pair's bytes in 32 bits: 2 GiB a shard raises
    xs = [torch.empty((1 << 29) + 1, device="meta") for _ in range(2)]
    with pytest.raises(ValueError, match="2 GiB"):
        HR._launch(_HostCopy(), 0, [xs], (1 << 29) + 1, None)


@pytest.mark.parametrize("nbytes", [1, 15, 16, 17, 31, 33, 4095, 25669])
@pytest.mark.parametrize("off", range(16))
def test_k12_replay_copies_and_reads_in_bounds(off, nbytes):
    # the kernel's schedule and realignment, replayed: every output word
    # written once, the bytes those of the source, and no input word read
    # past the last one that holds a source byte
    rng = np.random.default_rng(off * 100003 + nbytes)
    memory = rng.integers(0, 256, 16 * (-(-(off + nbytes) // 16) + 2),
                          dtype=np.uint8)
    got, read, written, last = k12_replay.copy(memory, off, nbytes)
    np.testing.assert_array_equal(got, memory[off:off + nbytes])
    assert np.all(written == 1)
    assert max(read) == last and min(read) == 0


def test_k12_replay_grid():
    c = k12_replay.constants()
    assert c["kMaxPairs"] == HR.MAX_PAIRS and c["kSmallPairs"] <= 16
    # the fused tails: a few blocks a pair; the 1 MiB ring: one wave
    assert k12_replay.grid_x(25669, 16, 1056) * 16 <= 128
    assert k12_replay.grid_x(1 << 20, 8, 1056) * 8 <= 1056
    assert k12_replay.grid_x(1 << 24, 128, 1056) == 8


def test_source_offset():
    assert [HR.source_offset(p) for p in (0, 17, 4096 + 15)] == [0, 1, 15]
