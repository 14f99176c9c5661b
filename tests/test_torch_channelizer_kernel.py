"""The channelizer kernel's wrapper and plain version against the JAX
package's Pallas kernel (run in interpret mode, as its own tests run it
on the CPU).  Here the wrapper runs the plain PyTorch version, because
the tensors lie on the CPU; the kernel itself is compared with the
plain version on the card by tests/test_torch_band_monitor_cuda.py and
by chip_smoke.py."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import channelizer_pallas as JCP
from comms_tpu_torch.kernels import channelizer as TCK
from comms_tpu_torch.models import channelizer as tmodel
from comms_tpu_torch.models import fm_band_monitor as tmonitor
from comms_tpu_torch.ops import channelizer as tchan

# The JAX kernel's bf16x3 DFT products are ~1e-5 relative; its own
# parity bound (tests/test_channelizer_pallas.py).
TOL = 1e-5


def _planes(rng, n):
    return (rng.normal(size=n).astype(np.float32),
            rng.normal(size=n).astype(np.float32))


@pytest.mark.parametrize("start", ["zero", "mid_stream"])
@pytest.mark.parametrize("K", [64, 16])
def test_plain_matches_jax_kernel(K, start):
    rng = np.random.default_rng(K + (start == "zero"))
    h = tchan.design_prototype(K, 8)
    N = 2 * TCK.step_samples()
    re, im = _planes(rng, N)
    if start == "zero":
        cr = ci = np.zeros(TCK.CTX_SAMPLES, np.float32)
    else:
        cr, ci = _planes(rng, TCK.CTX_SAMPLES)
    want = JCP.channelize_pallas_planar(
        jnp.asarray(re), jnp.asarray(im), h, jnp.asarray(cr),
        jnp.asarray(ci), num_channels=K, interpret=True)
    launches = TCK.launches
    got = TCK.channelize_planar(
        torch.from_numpy(re), torch.from_numpy(im), h,
        torch.from_numpy(cr), torch.from_numpy(ci), num_channels=K)
    assert TCK.launches == launches          # CPU tensors: no kernel
    yr, yi = np.asarray(want[0]), np.asarray(want[1])
    assert got[0].shape == yr.shape == (N // K, K)
    scale = max(np.abs(yr).max(), np.abs(yi).max())
    assert np.max(np.abs(got[0].numpy() - yr)) < TOL * scale
    assert np.max(np.abs(got[1].numpy() - yi)) < TOL * scale
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))
    plain = TCK.channelize_plain(
        torch.from_numpy(re), torch.from_numpy(im), h,
        torch.from_numpy(cr), torch.from_numpy(ci), num_channels=K)
    np.testing.assert_array_equal(plain[0].numpy(), got[0].numpy())


def test_complex_entry_streams_like_one_block():
    rng = np.random.default_rng(2)
    h = tchan.design_prototype(64, 8)
    N = TCK.step_samples()
    re, im = _planes(rng, 2 * N)
    x = torch.complex(torch.from_numpy(re), torch.from_numpy(im))
    ctx = torch.zeros(TCK.CTX_SAMPLES, dtype=torch.complex64)
    y1, ctx = TCK.channelize(x[:N], h, ctx)
    y2, _ = TCK.channelize(x[N:], h, ctx)
    want, _ = tchan.channelize_block(
        x, tchan.branch_taps(h.astype(np.float32), 64),
        tchan.channelizer_init_ctx(len(h), device="cpu"))
    got = torch.cat([y1, y2])
    assert np.max(np.abs((got - want).numpy())) < TOL * np.abs(
        want.numpy()).max()


@pytest.mark.parametrize("bad,match", [
    (dict(num_channels=48), "divide 128"),
    (dict(M=17), "taps_per_branch"),
    (dict(n=1000), "multiple"),
    (dict(ctx=512), "ctx must be 1024"),
])
def test_validation_errors(bad, match):
    K = bad.get("num_channels", 64)
    h = np.ones(K * bad.get("M", 8))
    n = bad.get("n", TCK.step_samples())
    z = torch.zeros(n)
    c = torch.zeros(bad.get("ctx", TCK.CTX_SAMPLES))
    with pytest.raises(ValueError, match=match):
        TCK.channelize_planar(z, z, h, c, c, num_channels=K)


def test_wrapper_rejects_other_devices_and_types():
    h = tchan.design_prototype(64, 8)
    z = torch.zeros(TCK.step_samples())
    c = torch.zeros(TCK.CTX_SAMPLES)
    with pytest.raises(ValueError, match="float32"):
        TCK.channelize_planar(z.double(), z.double(), h, c, c)
    m = torch.zeros(TCK.step_samples(), device="meta")
    cm = torch.zeros(TCK.CTX_SAMPLES, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        TCK.channelize_planar(m, m, h, cm, cm)


def test_oversized_prototype_raises_at_build():
    cfg = tmodel.ChannelizerConfig(taps_per_branch=17,
                                   block=TCK.step_samples())
    with pytest.raises(ValueError, match="context"):
        tmodel.make_block_fn(cfg, use_kernel=True)
    with pytest.raises(ValueError, match="context"):
        tmodel.make_planar_block_fn(cfg, use_kernel=True)
    mcfg = tmonitor.BandMonitorConfig(num_channels=64, taps_per_branch=17,
                                      block=TCK.step_samples())
    with pytest.raises(ValueError, match="context"):
        tmonitor.make_block_fn(mcfg, use_kernel=True)
    with pytest.raises(ValueError, match="context"):
        tmonitor.make_planar_block_fn(mcfg, use_kernel=True)


def test_auto_route_matches_jax_rule():
    ok = tmodel.ChannelizerConfig(block=TCK.step_samples())
    assert tmodel._auto_use_kernel(ok, "cuda")
    assert not tmodel._auto_use_kernel(ok, "cpu")
    for cfg in (tmodel.ChannelizerConfig(num_channels=48, block=48 * 512),
                tmodel.ChannelizerConfig(block=8192),
                tmodel.ChannelizerConfig(taps_per_branch=17,
                                         block=TCK.step_samples())):
        assert not tmodel._auto_use_kernel(cfg, "cuda")


@pytest.mark.parametrize("planar", [False, True])
def test_model_kernel_route_matches_tensor_route(planar):
    # use_kernel=True on CPU tensors runs the kernel's plain version;
    # it must agree with the tensor route, state included.
    rng = np.random.default_rng(3 + planar)
    cfg = tmodel.ChannelizerConfig(block=TCK.step_samples())
    make = tmodel.make_planar_block_fn if planar else tmodel.make_block_fn
    bk, bt = make(cfg, use_kernel=True), make(cfg, use_kernel=False)
    sk = tmodel.init_state(cfg, device="cpu")
    st = tmodel.init_state(cfg, device="cpu")
    for b in range(2):
        re, im = (torch.from_numpy(p) for p in _planes(rng, cfg.block))
        args = (re, im) if planar else (torch.stack([re, im], -1),)
        yk, sk = bk(sk, *args)
        yt, st = bt(st, *args)
        if planar:
            yk, yt = torch.stack(yk, -1), torch.stack(yt, -1)
        assert np.max(np.abs((yk - yt).numpy())) < TOL * np.abs(
            yt.numpy()).max(), b
        np.testing.assert_array_equal(sk.numpy(), st.numpy())
