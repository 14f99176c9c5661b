"""parallel.sharding: the port's in-process mesh and its collectives against
the JAX package's on the 8-device CPU mesh, with the same numpy inputs.
The collectives move values, so they are held to JAX exactly; the
estimator psum sums complex lag products in another order than XLA's,
so it is held to 1e-5 (the JAX test's own bound against the one-device
estimate)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from jax import lax, shard_map
from jax.sharding import Mesh, PartitionSpec as P

from comms_tpu.ops import channelizer as jchan
from comms_tpu.ops import fir as jfir
from comms_tpu.parallel import sharding as jsh
from comms_tpu_torch.ops import channelizer as tchan
from comms_tpu_torch.ops import fir as tfir
from comms_tpu_torch.parallel import sharding as tsh

N_DEV = 8


def _mesh():
    return tsh.time_mesh(N_DEV, device="cpu")


def test_mesh_order_is_jax_order():
    jm = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("time", "chan"))
    tm = tsh.Mesh(["cpu"] * 8, (2, 4), ("time", "chan"))
    assert tm.shape == dict(jm.shape) and tm.size == 8
    x = np.arange(8 * 3, dtype=np.float32)
    # shard s of the flattened ring holds the same slice in both
    fn = shard_map(lambda v: v * (lax.axis_index(("time", "chan")) + 1),
                   mesh=jm, in_specs=P(("time", "chan")),
                   out_specs=P(("time", "chan")))
    want = np.asarray(jax.jit(fn)(jnp.asarray(x)))
    xs = tsh.shard(torch.from_numpy(x), tm, (("time", "chan"),))
    got = torch.cat([v * (i + 1) for i, v in
                     enumerate(xs)]).numpy()
    np.testing.assert_array_equal(got, want)
    assert tm.rings("time") == [[0, 4], [1, 5], [2, 6], [3, 7]]
    assert tm.rings("chan") == [[0, 1, 2, 3], [4, 5, 6, 7]]
    assert tm.rings(("time", "chan")) == [list(range(8))]
    assert tm.axis_index("time") == [0, 0, 0, 0, 1, 1, 1, 1]


def test_shard_unshard_round_trip_2d():
    tm = tsh.Mesh(["cpu"] * 8, (2, 4), ("time", "chan"))
    x = torch.arange(8 * 6.0).reshape(8, 6).clone()
    for spec in (("chan", "time"), ("time", None), (None, "time"),
                 (("time", "chan"), None)):
        xs = tsh.shard(x, tm, spec)
        assert all(v._base is x for v in xs)                  # views
        assert torch.equal(tsh.unshard(xs, tm, spec), x)


def test_sharded_fir_halo_matches_jax():
    rng = np.random.default_rng(0)
    T = 33
    t = (rng.normal(size=T) + 1j * rng.normal(size=T)).astype(np.complex64)
    B = jfir.banded_tap_matrix(t)
    x = (rng.normal(size=2048) + 1j * rng.normal(size=2048)).astype(
        np.complex64)
    ctx = (rng.normal(size=T - 1) + 1j * rng.normal(size=T - 1)).astype(
        np.complex64)

    def local(xl, ctxg):
        halo = jsh.halo_exchange(xl, ctxg, T - 1)
        y, _ = jfir.fir_block(xl, B, halo)
        return y, jsh.collect_ctx(xl, T - 1)

    fn = jax.jit(shard_map(local, mesh=jsh.time_mesh(8),
                           in_specs=(P("time"), P()),
                           out_specs=(P("time"), P())))
    y_j, ctx_j = fn(jnp.asarray(x), jnp.asarray(ctx))

    mesh = _mesh()
    xs = tsh.shard(torch.from_numpy(x), mesh, ("time",))
    halos = tsh.halo_exchange(xs, torch.from_numpy(ctx), T - 1, mesh)
    ys = [tfir.fir_block(v, tfir.banded_tap_matrix(t), h)[0]
          for v, h in zip(xs, halos)]
    new_ctx = tsh.collect_ctx(xs, T - 1, mesh)
    # the FIR products sum in another order than XLA's: the JAX test's
    # 1e-5 against the one-device filter; the halos and the context are
    # moved values, exact.
    np.testing.assert_allclose(torch.cat(ys).numpy(), np.asarray(y_j),
                               atol=1e-5)
    assert all(c is new_ctx[0] for c in new_ctx)
    np.testing.assert_array_equal(new_ctx[0].numpy(), np.asarray(ctx_j))


def test_estimator_psum_matches_jax():
    w = 0.123
    x = np.exp(1j * w * np.arange(4096)).astype(np.complex64)

    def local(xl):
        lag = jnp.sum(xl[1:] * jnp.conj(xl[:-1]))
        yprev = jsh.halo_exchange(xl, jnp.zeros((1,), xl.dtype), 1)
        idx = lax.axis_index("time")
        edge = jnp.where(idx == 0, 0j, xl[0] * jnp.conj(yprev[0]))
        s = jsh.psum_estimate(lag + edge)
        return jnp.arctan2(jnp.imag(s), jnp.real(s))[None]

    fn = jax.jit(shard_map(local, mesh=jsh.time_mesh(8),
                           in_specs=(P("time"),), out_specs=P("time")))
    want = float(np.asarray(fn(jnp.asarray(x)))[0])

    mesh = _mesh()
    xs = tsh.shard(torch.from_numpy(x), mesh, ("time",))
    prev = tsh.halo_exchange(xs, torch.zeros(1, dtype=torch.complex64), 1,
                             mesh)
    parts = [torch.sum(v[1:] * torch.conj(v[:-1]))
             + (0 if i == 0 else v[0] * torch.conj(p[0]))
             for i, (v, p) in enumerate(zip(xs, prev))]
    sums = tsh.psum_estimate(parts, mesh)
    assert all(s is sums[0] for s in sums)
    got = float(torch.atan2(sums[0].imag, sums[0].real))
    assert abs(got - want) < 1e-5
    assert abs(got - w) < 1e-5


def test_psum_in_shard_order_and_tuples():
    mesh = _mesh()
    parts = [(torch.tensor([float(i)]), torch.tensor([2.0 ** -i]))
             for i in range(N_DEV)]
    out = tsh.psum(parts, mesh)
    want_a = parts[0][0]
    want_b = parts[0][1]
    for a, b in parts[1:]:
        want_a, want_b = want_a + a, want_b + b
    assert torch.equal(out[3][0], want_a) and torch.equal(out[5][1], want_b)


def test_corner_turn_matches_jax():
    frames_local, K = 4, 16
    x = np.arange(8 * frames_local * K, dtype=np.float32).reshape(
        8 * frames_local, K)
    fn = jax.jit(shard_map(jsh.corner_turn, mesh=jsh.time_mesh(8),
                           in_specs=(P("time", None),),
                           out_specs=P(None, "time")))
    want = np.asarray(fn(jnp.asarray(x)))
    mesh = _mesh()
    got = tsh.unshard(tsh.corner_turn(
        tsh.shard(torch.from_numpy(x), mesh, ("time", None)), mesh), mesh,
        (None, "time"))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(got.numpy(), x)
    with pytest.raises(ValueError, match="not divisible"):
        tsh.corner_turn([torch.zeros(2, 6)] * 8, mesh)


def test_all_to_all_matches_jax():
    x = np.arange(8 * 16 * 3, dtype=np.float32).reshape(8 * 16, 3)
    fn = jax.jit(shard_map(
        lambda v: lax.all_to_all(v, "time", 0, 0, tiled=True),
        mesh=jsh.time_mesh(8), in_specs=(P("time", None),),
        out_specs=P("time", None)))
    want = np.asarray(fn(jnp.asarray(x)))
    mesh = _mesh()
    got = tsh.unshard(tsh.all_to_all(
        tsh.shard(torch.from_numpy(x), mesh, ("time", None)), mesh), mesh,
        ("time", None))
    np.testing.assert_array_equal(got.numpy(), want)


def test_sharded_channelizer_matches_jax():
    # Time-sharded channelizer: the shards' halos reproduce every window;
    # the JAX test's 1e-4 against the one-device channelizer.
    rng = np.random.default_rng(3)
    K, M = 16, 4
    h = jchan.design_prototype(K, M).astype(np.float64)
    Hb = jchan.branch_taps(h, K)
    N = 8 * 32 * K
    x = (rng.normal(size=N) + 1j * rng.normal(size=N)).astype(np.complex64)
    T = len(h)
    ctx0 = jchan.channelizer_init_ctx(T, dtype=jnp.complex64)

    def local(xl, ctxg):
        halo = jsh.halo_exchange(xl, ctxg, T - 1)
        return jchan.channelize_block(xl, Hb, halo)[0]

    fn = jax.jit(shard_map(local, mesh=jsh.time_mesh(8),
                           in_specs=(P("time"), P()),
                           out_specs=P("time", None)))
    want = np.asarray(fn(jnp.asarray(x), ctx0))
    mesh = _mesh()
    xs = tsh.shard(torch.from_numpy(x), mesh, ("time",))
    halos = tsh.halo_exchange(
        xs, tchan.channelizer_init_ctx(T, device="cpu"), T - 1, mesh)
    Hb_t = tchan.branch_taps(h, K)
    got = torch.cat([tchan.channelize_block(v, Hb_t, c)[0]
                     for v, c in zip(xs, halos)]).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)


def test_time_mesh_validations():
    with pytest.raises(ValueError, match="at least one shard"):
        tsh.time_mesh(0, device="cpu")
    with pytest.raises(ValueError, match="needs 8 devices"):
        tsh.Mesh(["cpu"] * 4, (2, 4), ("time", "chan"))
    with pytest.raises(ValueError, match="no mesh axis"):
        _mesh().rings("chan")
