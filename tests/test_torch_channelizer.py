"""The channelizer ops and model: comms_tpu_torch against the JAX
package, against the direct float64 oracle, and across block seams.
Inputs are made with numpy from a seed and fed to both packages."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.models import channelizer as jmodel
from comms_tpu.ops import channelizer as jchan
from comms_tpu_torch.models import channelizer as tmodel
from comms_tpu_torch.ops import channelizer as tchan

# float32 products in another summation order: ~1e-7 relative; the JAX
# kernel tests' bound.
TOL = 1e-5


def _cx(rng, n, dtype=np.complex64):
    return (rng.normal(size=n) + 1j * rng.normal(size=n)).astype(dtype)


@pytest.mark.parametrize("K,M", [(8, 4), (16, 8), (64, 8), (512, 2)])
def test_prototype_and_branch_taps_bit_equal(K, M):
    h = tchan.design_prototype(K, M)
    assert np.array_equal(h, jchan.design_prototype(K, M))
    for proto in (h, h.astype(np.float32)):
        assert np.array_equal(tchan.branch_taps(proto, K),
                              jchan.branch_taps(proto, K))


@pytest.mark.parametrize("K,M,N", [(8, 4, 1024), (16, 8, 4096),
                                   (64, 8, 16384), (512, 2, 4096)])
def test_channelize_block_matches_jax(K, M, N):
    rng = np.random.default_rng(K + M)
    h = tchan.design_prototype(K, M)
    Hb = tchan.branch_taps(h.astype(np.float32), K)
    x = _cx(rng, N)
    ctx = _cx(rng, K * M - 1)
    y_j, c_j = jchan.channelize_block(jnp.asarray(x), Hb, jnp.asarray(ctx))
    y_t, c_t = tchan.channelize_block(torch.from_numpy(x), Hb,
                                      torch.from_numpy(ctx))
    y_j = np.asarray(y_j)
    assert y_t.shape == y_j.shape == (N // K, K)
    assert np.max(np.abs(y_t.numpy() - y_j)) < TOL * np.abs(y_j).max()
    np.testing.assert_array_equal(c_t.numpy(), np.asarray(c_j))

    yr, yi, nr, ni = tchan.channelize_block_planar(
        torch.from_numpy(x.real.copy()), torch.from_numpy(x.imag.copy()),
        Hb, torch.from_numpy(ctx.real.copy()),
        torch.from_numpy(ctx.imag.copy()))
    np.testing.assert_array_equal(yr.numpy() + 1j * yi.numpy(),
                                  y_t.numpy())
    np.testing.assert_array_equal(nr.numpy() + 1j * ni.numpy(), c_t.numpy())


@pytest.mark.parametrize("K,M,N", [(8, 4, 256), (512, 2, 2048)])
def test_channelize_block_matches_oracle_f64(K, M, N):
    rng = np.random.default_rng(N)
    h = tchan.design_prototype(K, M)
    x = _cx(rng, N, np.complex128)
    y, _ = tchan.channelize_block(
        torch.from_numpy(x), tchan.branch_taps(h, K),
        tchan.channelizer_init_ctx(len(h), dtype=torch.complex128,
                                   device="cpu"))
    assert y.dtype == torch.complex128
    assert np.allclose(y.numpy(), tchan.channelize_oracle(x, h, K),
                       atol=1e-9)
    np.testing.assert_array_equal(tchan.channelize_oracle(x, h, K),
                                  jchan.channelize_oracle(x, h, K))


def test_channelize_streaming_invariance():
    rng = np.random.default_rng(1)
    K, M = 16, 8
    h = tchan.design_prototype(K, M)
    Hb = tchan.branch_taps(h, K)
    x = torch.from_numpy(_cx(rng, 1024, np.complex128))
    ctx = tchan.channelizer_init_ctx(len(h), dtype=torch.complex128,
                                     device="cpu")
    y_once, _ = tchan.channelize_block(x, Hb, ctx)
    parts = []
    for i in range(4):
        y, ctx = tchan.channelize_block(x[i * 256:(i + 1) * 256], Hb, ctx)
        parts.append(y)
    assert np.allclose(torch.cat(parts).numpy(), y_once.numpy(), atol=1e-12)


def test_tone_lands_in_its_channel():
    K, M, c = 8, 8, 3
    h = tchan.design_prototype(K, M)
    n = np.arange(4096)
    x = torch.from_numpy(np.exp(2j * np.pi * c * n / K))
    y, _ = tchan.channelize_block(
        x, tchan.branch_taps(h, K),
        tchan.channelizer_init_ctx(len(h), dtype=torch.complex128,
                                   device="cpu"))
    power = np.mean(np.abs(y.numpy()[M:]) ** 2, axis=0)
    assert np.argmax(power) == c
    assert power[c] > 100 * np.delete(power, c).max()


@pytest.mark.parametrize("planar", [False, True])
@pytest.mark.parametrize("K", [16, 64])
def test_channelizer_model_matches_jax_streamed(K, planar):
    rng = np.random.default_rng(K + planar)
    jcfg = jmodel.ChannelizerConfig(num_channels=K, block=8192)
    tcfg = tmodel.ChannelizerConfig(num_channels=K, block=8192)
    if planar:
        jblk = jmodel.make_planar_block_fn(jcfg)
        tblk = tmodel.make_planar_block_fn(tcfg)
    else:
        jblk = jmodel.make_block_fn(jcfg)
        tblk = tmodel.make_block_fn(tcfg)
    js, ts = jmodel.init_state(jcfg), tmodel.init_state(tcfg, device="cpu")
    for b in range(3):
        pairs = rng.normal(size=(tcfg.block, 2)).astype(np.float32)
        if planar:
            re, im = pairs[:, 0].copy(), pairs[:, 1].copy()
            (yr, yi), js = jblk(js, jnp.asarray(re), jnp.asarray(im))
            (tr, ti), ts = tblk(ts, torch.from_numpy(re),
                                torch.from_numpy(im))
            want = np.stack([np.asarray(yr), np.asarray(yi)], -1)
            got = torch.stack([tr, ti], -1).numpy()
        else:
            want, js = jblk(js, jnp.asarray(pairs))
            got, ts = tblk(ts, torch.from_numpy(pairs))
            want, got = np.asarray(want), got.numpy()
        assert got.shape == want.shape == (tcfg.frames_per_block, K, 2)
        assert np.max(np.abs(got - want)) < TOL * np.abs(want).max(), b
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))


def test_channelizer_model_state_from_jax_continues():
    rng = np.random.default_rng(5)
    cfg_j = jmodel.ChannelizerConfig(num_channels=16, block=4096)
    cfg_t = tmodel.ChannelizerConfig(num_channels=16, block=4096)
    jblk, tblk = jmodel.make_block_fn(cfg_j), tmodel.make_block_fn(cfg_t)
    a, b = (rng.normal(size=(4096, 2)).astype(np.float32) for _ in range(2))
    _, js = jblk(jmodel.init_state(cfg_j), jnp.asarray(a))
    want, _ = jblk(js, jnp.asarray(b))
    got, _ = tblk(tmodel.state_from_jax(np.asarray(js), device="cpu"),
                  torch.from_numpy(b))
    want = np.asarray(want)
    assert np.max(np.abs(got.numpy() - want)) < TOL * np.abs(want).max()
