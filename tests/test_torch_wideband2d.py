"""parallel.wideband2d: the band monitor on the port's 2-D (time x chan)
mesh against the JAX package's on the CPU mesh, for every factorization
of 8 shards, with the same numpy inputs.  Bounds: audio, carried state
and the streamed second block within 1e-5 of JAX, the JAX test's own
bound against the one-device band monitor (float32 on both sides in
other summation orders); the power map within 1e-5 relative to JAX and
2% of the oracle's (the JAX test's)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.models import fm_band_monitor as jbm
from comms_tpu.ops import channelizer as jchan
from comms_tpu.parallel import wideband2d as jw2
from comms_tpu_torch.kernels import halo_ring as HR
from comms_tpu_torch.models import fm_band_monitor as tbm
from comms_tpu_torch.parallel import wideband2d as tw2

TOL = 1e-5
N = 16384


def _capture():
    rng = np.random.default_rng(11)
    ph = np.cumsum(0.3 + 0.2 * rng.normal(size=N))
    z = (np.exp(1j * ph) + 0.1 * rng.normal(size=N)).astype(np.complex64)
    return z, np.stack([z.real, z.imag], -1).astype(np.float32)


@pytest.mark.parametrize("nt,nc", [(2, 4), (4, 2), (1, 8), (8, 1)])
def test_band_monitor_2d_matches_jax(nt, nc):
    z, pairs = _capture()
    jcfg = jbm.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                 block=N, audio_dec=4)
    jstep = jw2.make_sharded_band_monitor_2d(jcfg, jw2.mesh_2d(nt, nc))
    (ja, jp), jst = jstep(jbm.init_state(jcfg), jnp.asarray(pairs))
    (ja2, _), _ = jstep(jst, jnp.asarray(pairs))

    cfg = tbm.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                block=N, audio_dec=4)
    step = tw2.make_sharded_band_monitor_2d(
        cfg, tw2.mesh_2d(nt, nc, device="cpu"))
    launches = HR.launches
    (ta, tp), tst = step(tbm.init_state(cfg, device="cpu"),
                         torch.from_numpy(pairs))
    (ta2, _), _ = step(tst, torch.from_numpy(pairs))
    assert HR.launches == launches           # CPU shards: the plain ring
    assert ta.shape == (16, N // 16 // 4)
    np.testing.assert_allclose(ta.numpy(), np.asarray(ja), atol=TOL)
    np.testing.assert_allclose(ta2.numpy(), np.asarray(ja2), atol=TOL)
    for a, b in zip(tst, jst):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=TOL)
    y_ref = jchan.channelize_oracle(z, cfg.prototype, cfg.num_channels)
    np.testing.assert_allclose(tp.numpy(), np.mean(np.abs(y_ref) ** 2, 0),
                               rtol=0.02)


def test_band_monitor_2d_matches_one_device_port():
    # the port's own one-device staged band monitor, the tensor route
    _, pairs = _capture()
    cfg = tbm.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                block=N, audio_dec=4)
    ref, ref_st = tbm.make_block_fn(cfg, use_kernel=False)(
        tbm.init_state(cfg, device="cpu"), torch.from_numpy(pairs))
    (a, _), st = tw2.make_sharded_band_monitor_2d(
        cfg, tw2.mesh_2d(2, 4, device="cpu"))(
        tbm.init_state(cfg, device="cpu"), torch.from_numpy(pairs))
    np.testing.assert_allclose(a.numpy(), ref.numpy(), atol=TOL)
    for x, y in zip(st, ref_st):
        np.testing.assert_allclose(x.numpy(), y.numpy(), atol=TOL)


def test_band_monitor_2d_validations():
    mesh = tw2.mesh_2d(2, 4, device="cpu")
    bad = tbm.BandMonitorConfig(num_channels=6, taps_per_branch=8,
                                block=16 * 6 * 25, audio_dec=4)
    with pytest.raises(ValueError, match="divide over chan"):
        tw2.make_sharded_band_monitor_2d(bad, mesh)
    bad2 = tbm.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                 block=512, audio_dec=4)
    with pytest.raises(ValueError, match="channelizer halo"):
        tw2.make_sharded_band_monitor_2d(bad2, mesh)
    bad3 = tbm.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                 block=16 * 4 * 25, audio_dec=4)
    with pytest.raises(ValueError, match="must divide by devices"):
        tw2.make_sharded_band_monitor_2d(bad3, mesh)
