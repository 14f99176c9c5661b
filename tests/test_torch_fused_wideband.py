"""parallel.fused_wideband: the sharded fused FM chain (K1 per shard) and
the sharded fused band monitor (K9 per shard) against the JAX package's
on a 2-shard submesh of the CPU mesh, with the same numpy inputs (the JAX
kernels run in interpret mode, about 4 s per K1 step, hence two shards of
one kernel step each).  On the CPU the port's wrappers run their plain
versions.

Bounds: the port's sharded FM chain equals its own sequential run of
``make_fused_block_fn`` over per-shard blocks bit for bit (a shard
boundary is a block boundary, with the same context recompute), and is
held to the JAX sharded chain at 1e-3, the bound of the port's K1 against
the JAX kernel (tests/test_torch_fm_chain.py).  The band monitor is held
to the JAX sharded step and to the port's sequential fused stream at the
JAX test's 5e-4 of the largest sample (the boundary state is recomputed
from the raw tail in another summation order than the kernel's)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import band_monitor_pallas as JBM
from comms_tpu.models import fm_band_monitor as jbm
from comms_tpu.parallel import fused_wideband as jfw
from comms_tpu.parallel import sharding as jsh
from comms_tpu_torch.kernels import halo_ring as HR
from comms_tpu_torch.models import fm_band_monitor as tbm
from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.parallel import fused_wideband as tfw
from comms_tpu_torch.parallel import sharding as tsh

SHARDS = 2
TOL_FM = 1e-3
TOL_BM = 5e-4


def _u8(n, seed):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, size=n, dtype=np.uint8),
            rng.integers(0, 256, size=n, dtype=np.uint8))


def _port_sequential(re, im, per_shard, blocks, state):
    blk = tfm.make_fused_block_fn(tfm.FmReceiverConfig(block=per_shard))
    outs = []
    for b in range(blocks):
        a, state = blk(state, torch.from_numpy(re[b * per_shard:
                                                  (b + 1) * per_shard]),
                       torch.from_numpy(im[b * per_shard:
                                           (b + 1) * per_shard]))
        outs.append(a)
    return torch.cat(outs), state


def test_sharded_fused_fm_matches_jax_and_sequential():
    per = tfm.FUSED_BLOCK_QUANTUM
    N = SHARDS * per
    re, im = _u8(2 * N, 0)
    jstep = jfw.make_sharded_fused_step(jsh.time_mesh(SHARDS), block=N,
                                        interpret=True)
    want, _ = jstep(jfw.fused_init_state(), jnp.asarray(re[:N]),
                    jnp.asarray(im[:N]))

    tstep = tfw.make_sharded_fused_step(tsh.time_mesh(SHARDS, device="cpu"),
                                        block=N)
    st = tfw.fused_init_state("cpu")
    launches = HR.launches
    a1, st = tstep(st, torch.from_numpy(re[:N]), torch.from_numpy(im[:N]))
    a2, st = tstep(st, torch.from_numpy(re[N:]), torch.from_numpy(im[N:]))
    assert HR.launches == launches           # CPU shards: the plain ring
    assert a1.shape == (N // 25,)
    assert np.max(np.abs(a1.numpy() - np.asarray(want))) < TOL_FM

    ref, ref_state = _port_sequential(re, im, per, 2 * SHARDS,
                                      tfw.fused_init_state("cpu"))
    assert torch.equal(torch.cat([a1, a2]), ref)
    for k in ref_state:
        assert torch.equal(st[k], ref_state[k])


def test_sharded_fused_validations():
    mesh = tsh.time_mesh(SHARDS, device="cpu")
    with pytest.raises(ValueError, match="multiple of the"):
        tfw.make_sharded_fused_step(mesh, block=SHARDS * 1024)
    with pytest.raises(ValueError, match="must divide over"):
        tfw.make_sharded_fused_step(mesh, block=3)
    cfg = tbm.BandMonitorConfig(block=16384)
    with pytest.raises(ValueError, match="multiple of the"):
        tfw.make_sharded_band_monitor_step(cfg, mesh, block=SHARDS * 4096)


def test_sharded_band_monitor_matches_jax_and_sequential():
    per = JBM.step_samples()
    N = SHARDS * per
    rng = np.random.default_rng(5)
    re = rng.normal(size=N).astype(np.float32)
    im = rng.normal(size=N).astype(np.float32)

    jcfg = jbm.BandMonitorConfig(block=per)
    jstep = jfw.make_sharded_band_monitor_step(
        jcfg, jsh.time_mesh(SHARDS), block=N, interpret=True)
    want, _ = jstep(jbm.init_state_fused(jcfg), jnp.asarray(re),
                    jnp.asarray(im))
    want = np.asarray(want)

    cfg = tbm.BandMonitorConfig(block=per)
    tstep = tfw.make_sharded_band_monitor_step(
        cfg, tsh.time_mesh(SHARDS, device="cpu"), block=N)
    st0 = tbm.init_state_fused(cfg, device="cpu")
    got, st1 = tstep(st0, torch.from_numpy(re), torch.from_numpy(im))
    got2, _ = tstep(st1, torch.from_numpy(re), torch.from_numpy(im))
    assert got.shape == want.shape == (cfg.num_channels,
                                       N // cfg.num_channels // 4)
    scale = np.abs(want).max()
    assert np.max(np.abs(got.numpy() - want)) < TOL_BM * scale

    blk = tbm.make_fused_block_fn(cfg)
    st = st0
    outs = []
    for _ in range(2):
        for b in range(SHARDS):
            a, st = blk(st, torch.from_numpy(re[b * per:(b + 1) * per]),
                        torch.from_numpy(im[b * per:(b + 1) * per]))
            outs.append(a)
    ref = torch.cat(outs, dim=1)
    seq = torch.cat([got, got2], dim=1)
    assert np.max(np.abs((seq - ref).numpy())) < TOL_BM * scale
