"""parallel.wideband: the sharded FM chain and the sharded Welch PSDs
against the JAX package's on the 8-device CPU mesh, with the same numpy
inputs.  The chain is held to 1e-4, the JAX test's own bound against its
one-device oracle (both sides run float32 products in other summation
orders); the PSDs to 1e-5 of the largest bin (the JAX tests' bound
against ``welch_psd``)."""

import json

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.models.fm_receiver import FM_LPF_TAPS
from comms_tpu.parallel import dfft as jdfft
from comms_tpu.parallel import sharding as jsh
from comms_tpu.parallel import wideband as jwb
from comms_tpu_torch.kernels import halo_ring as HR
from comms_tpu_torch.ops import spectrum as tspec
from comms_tpu_torch.parallel import dryrun, scaling
from comms_tpu_torch.parallel import sharding as tsh
from comms_tpu_torch.parallel import wideband as twb

TOL_CHAIN = 1e-4
TOL_PSD = 1e-5


def _fm_pairs(n, seed):
    rng = np.random.default_rng(seed)
    ph = np.cumsum(0.2 + 0.05 * np.sin(2 * np.pi * np.arange(n) / 400)
                   + 0.01 * rng.normal(size=n))
    z = (np.exp(1j * ph) * 0.9).astype(np.complex64)
    return np.stack([z.real, z.imag], -1).astype(np.float32)


@pytest.mark.parametrize("rdma_halo", [False, True])
def test_chain_matches_jax_streamed(rdma_halo):
    n = 8 * 1000
    blocks = [_fm_pairs(n, 2), _fm_pairs(n, 3)]
    jcfg = jwb.WidebandConfig(FM_LPF_TAPS, block=n, dec1=5, dec2=5)
    jstep = jwb.make_sharded_step(jcfg, jsh.time_mesh(8))
    tcfg = twb.WidebandConfig(FM_LPF_TAPS, block=n, dec1=5, dec2=5)
    tstep = twb.make_sharded_step(tcfg, tsh.time_mesh(8, device="cpu"),
                                  rdma_halo=rdma_halo)
    jst = jwb.init_state(jcfg)
    # a mid-stream state: the JAX chain's after one block, carried over
    (_, _), jst = jstep(jst, jnp.asarray(_fm_pairs(n, 1)))
    tst = twb.state_from_jax([np.asarray(s) for s in jst], device="cpu")
    for pairs in blocks:
        (ja, jf), jst = jstep(jst, jnp.asarray(pairs))
        launches = HR.launches
        (ta, tf), tst = tstep(tst, torch.from_numpy(pairs))
        assert HR.launches == launches       # CPU shards: the plain ring
        assert ta.shape == (n // 25,)
        np.testing.assert_allclose(ta.numpy(), np.asarray(ja),
                                   atol=TOL_CHAIN)
        assert abs(float(tf) - float(jf)) < TOL_CHAIN
        for a, b in zip(tst, jst):
            np.testing.assert_allclose(a.numpy(), np.asarray(b),
                                       atol=TOL_CHAIN)


def test_chain_validations():
    mesh = tsh.time_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="divide evenly"):
        twb.make_sharded_step(twb.WidebandConfig(FM_LPF_TAPS, block=8001),
                              mesh)
    with pytest.raises(ValueError, match="dec1 and dec2"):
        twb.make_sharded_step(twb.WidebandConfig(FM_LPF_TAPS, block=8 * 30),
                              mesh)


def _segments(F, B, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=B * F) + 1j * rng.normal(size=B * F)).astype(
        np.complex64)
    return x, np.stack([x.real, x.imag], -1).reshape(B, F, 2)


def _close(got, want):
    assert got.shape == want.shape
    assert np.max(np.abs(got - want)) / np.max(want) < TOL_PSD


def test_sharded_psd_matches_jax_and_welch():
    F, B = 1 << 12, 4
    x, pairs = _segments(F, B, 11)
    want = np.asarray(jwb.make_sharded_psd(F, jsh.time_mesh(8))(
        jnp.asarray(pairs)))
    mesh = tsh.time_mesh(8, device="cpu")
    got = twb.make_sharded_psd(F, mesh)(torch.from_numpy(pairs)).numpy()
    _close(got, want)
    _, ref = tspec.welch_psd(torch.from_numpy(x), nperseg=F, noverlap=0)
    _close(got, ref.numpy())


def test_sharded_psd_local_radix_matches_jax():
    F = 1 << 16
    _, pairs = _segments(F, 1, 12)
    r = jdfft.pick_local_radix(F, 8, max_local_fft=1 << 10)
    want = np.asarray(jwb.make_sharded_psd(F, jsh.time_mesh(8),
                                           local_radix=r)(jnp.asarray(pairs)))
    got = twb.make_sharded_psd(F, tsh.time_mesh(8, device="cpu"),
                               local_radix=r)(torch.from_numpy(pairs))
    _close(got.numpy(), want)


@pytest.mark.parametrize("use_kernel", [False, True])
def test_sharded_psd_segments_matches_jax(use_kernel):
    # use_kernel=True runs K10's wrapper, whose plain version runs on CPU
    # shards; the JAX side takes its XLA route (no interpret-mode K10).
    F, B = 1 << 16, 8
    _, pairs = _segments(F, B, 13)
    want = np.asarray(jwb.make_sharded_psd_segments(
        F, jsh.time_mesh(8), use_pallas=False)(jnp.asarray(pairs)))
    got = twb.make_sharded_psd_segments(
        F, tsh.time_mesh(8, device="cpu"), use_kernel=use_kernel)(
        torch.from_numpy(pairs))
    _close(got.numpy(), want)


@pytest.mark.parametrize("shards", [1, 8])
def test_sharded_psd_planar_3d_serving_shape(shards):
    F, n1 = 1 << 16, 256
    rng = np.random.default_rng(7)
    re = rng.normal(size=(2, F)).astype(np.float32)
    im = rng.normal(size=(2, F)).astype(np.float32)
    want = np.asarray(jwb.make_sharded_psd_planar(
        F, jsh.time_mesh(shards), use_pallas=False)(jnp.asarray(re),
                                                    jnp.asarray(im)))
    psd = twb.make_sharded_psd_planar(F, tsh.time_mesh(shards, device="cpu"))
    a2 = psd(torch.from_numpy(re), torch.from_numpy(im)).numpy()
    a3 = psd(torch.from_numpy(re.reshape(2, n1, -1)),
             torch.from_numpy(im.reshape(2, n1, -1))).numpy()
    _close(a2, want)
    _close(a3, a2)


def test_psd_kernel_route_needs_one_shard():
    with pytest.raises(ValueError, match="1-shard mesh"):
        twb.make_sharded_psd(1 << 16, tsh.time_mesh(2, device="cpu"),
                             use_kernel=True)
    with pytest.raises(ValueError, match="two-factor"):
        twb.make_sharded_psd_segments(320, tsh.time_mesh(2, device="cpu"),
                                      use_kernel=True)


def test_weak_scaling_mechanics(tmp_path):
    out = tmp_path / "scaling.json"
    scaling.main(["--device", "cpu", "--per-shard", "400", "--iters", "1",
                  "--reps", "1", "--out", str(out)])
    art = json.loads(out.read_text())
    assert art["device"] == "cpu" and "IN-PROCESS MESH" in art["note"]
    assert [r["shards"] for r in art["results"]] == [1, 2, 4, 8]
    assert art["results"][0]["efficiency"] == 1.0


def test_dryrun_multichip_on_cpu_shards():
    # configs 1, 2, 4, 5, 6, 7 and 9 at the JAX dry run's sizes, with its
    # assertions (the rdma_halo build bit-equal to the default one, the
    # 2-D mesh within 1e-5 of the one-device band monitor)
    dryrun.dryrun_multichip(8, device="cpu")
