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
    assert HR.copy_width([0, 16, 4096], 64) == 16
    assert HR.copy_width([0, 4], 64) == 4
    assert HR.copy_width([0, 16], 6) == 1


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
