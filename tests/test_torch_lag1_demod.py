"""The staged band monitor's lag-1 demod (``kernels/lag1_demod``) on the
CPU: its plain version against the tensor ops the staged step ran
before, the staged kernel route against the JAX package's staged step,
the wrapper's CPU route and its checks, and a host replay of the CUDA
kernel's plan (``tests/_lag1_replay.py``) against the plain version."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

import _lag1_replay as replay
from comms_tpu.models import fm_band_monitor as jmodel
from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import lag1_demod as LD
from comms_tpu_torch.models import fm_band_monitor as tmodel
from comms_tpu_torch.ops import demodulation as demod

# The staged route's bound against the JAX package's XLA path
# (tests/test_torch_fm_band_monitor.py).
TOL_STAGED = 2e-5
REPO = Path(__file__).resolve().parents[1]


def _tensor_demod(yr, yi, prev_pairs, at2):
    """The staged step's demod as it was written in the step itself."""
    rt = yr.T.contiguous()
    it = yi.T.contiguous()
    a, b = rt[:, 1:], rt[:, :-1]
    c, d_ = it[:, 1:], it[:, :-1]
    d_int = at2(c * b - a * d_, a * b + c * d_)
    d0 = at2(
        it[:, 0] * prev_pairs[:, 0] - rt[:, 0] * prev_pairs[:, 1],
        rt[:, 0] * prev_pairs[:, 0] + it[:, 0] * prev_pairs[:, 1])
    d = torch.cat([d0[:, None], d_int], dim=1)
    return d, torch.stack([rt[:, -1], it[:, -1]], dim=-1)


def _planes(rng, frames, k):
    return tuple(torch.from_numpy(rng.normal(size=(frames, k))
                                  .astype(np.float32)) for _ in range(2))


def _prev(rng, k, start):
    if start == "zero":
        return torch.zeros((k, 2))
    return torch.from_numpy(rng.normal(size=(k, 2)).astype(np.float32))


@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("start", ["zero", "mid"])
@pytest.mark.parametrize("k", [16, 64])
def test_plain_equals_the_staged_tensor_demod(k, start, fast):
    rng = np.random.default_rng(k + (start == "mid"))
    yr, yi = _planes(rng, 1000, k)
    # stream start: a frame of signed zeros and every quadrant
    yr[0, :4] = torch.tensor([-1.0, 1.0, -0.0, -2.0])
    yi[0, :4] = torch.tensor([-1.0, -0.0, 0.0, 3.0])
    prev = _prev(rng, k, start)
    at2 = demod.fast_atan2 if fast else torch.atan2
    want = _tensor_demod(yr, yi, prev, at2)
    got = LD.lag1_demod_plain(yr, yi, prev, fast=fast)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.is_contiguous()
        assert torch.equal(g, w)
        assert torch.equal(torch.signbit(g), torch.signbit(w))


@pytest.mark.parametrize("k", [16, 64])
def test_staged_kernel_route_matches_jax_staged(k):
    rng = np.random.default_rng(30 + k)
    kw = dict(num_channels=k, block=16384)
    jcfg, tcfg = jmodel.BandMonitorConfig(**kw), tmodel.BandMonitorConfig(
        **kw)
    jblk = jmodel.make_planar_block_fn(jcfg)
    tblk = tmodel.make_planar_block_fn(tcfg, use_kernel=True)
    js, ts = jmodel.init_state(jcfg), tmodel.init_state(tcfg, device="cpu")
    n0 = LD.launches
    for b in range(2):
        re, im = (rng.normal(size=tcfg.block).astype(np.float32)
                  for _ in range(2))
        want, js = jblk(js, jnp.asarray(re), jnp.asarray(im))
        got, ts = tblk(ts, torch.from_numpy(re), torch.from_numpy(im))
        want = np.asarray(want)
        scale = max(np.abs(want).max(), 1.0)
        assert np.max(np.abs(got.numpy() - want)) < TOL_STAGED * scale, b
        w = np.asarray(js[1])
        assert np.max(np.abs(ts[1].numpy() - w)) < 1e-5 * max(
            np.abs(w).max(), 1.0)
    assert LD.launches == n0


@pytest.mark.parametrize("use_kernel", [True, False])
def test_staged_routes_take_their_demod(monkeypatch, use_kernel):
    calls = []

    def counted(name, fn):
        def run(*a, **kw):
            calls.append(name)
            return fn(*a, **kw)
        return run

    monkeypatch.setattr(LD, "lag1_demod",
                        counted("kernel", LD.lag1_demod))
    monkeypatch.setattr(LD, "lag1_demod_plain",
                        counted("plain", LD.lag1_demod_plain))
    cfg = tmodel.BandMonitorConfig(num_channels=16, block=16384)
    step = tmodel.make_planar_block_fn(cfg, use_kernel=use_kernel)
    st = tmodel.init_state(cfg, device="cpu")
    rng = np.random.default_rng(3)
    for _ in range(2):
        re, im = (torch.from_numpy(rng.normal(size=cfg.block)
                                   .astype(np.float32)) for _ in range(2))
        _, st = step(st, re, im)
    assert calls == ["kernel" if use_kernel else "plain"] * 2


@pytest.mark.parametrize("k", [16, 64])
def test_wrapper_on_cpu_runs_plain(monkeypatch, k):
    def no_build():
        raise AssertionError("the CPU route built the library")

    monkeypatch.setattr(_build, "load", no_build)
    rng = np.random.default_rng(k)
    yr, yi = _planes(rng, 300, k)
    prev = _prev(rng, k, "mid")
    n0 = LD.launches
    for fast in (True, False):
        got = LD.lag1_demod(yr, yi, prev, fast=fast)
        want = LD.lag1_demod_plain(yr, yi, prev, fast=fast)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert LD.launches == n0


def _bad(case):
    f32 = dict(dtype=torch.float32)
    yr, yi, prev = torch.ones(64, 16), torch.ones(64, 16), torch.zeros(16, 2)
    if case == "float64 plane":
        yr = yr.double()
    elif case == "float64 prev":
        prev = prev.double()
    elif case == "strided plane":
        yi = torch.ones(16, 64, **f32).T
    elif case == "strided prev":
        prev = torch.zeros(2, 16, **f32).T
    elif case == "prev [K, 3]":
        prev = torch.zeros(16, 3, **f32)
    elif case == "prev [2K, 2]":
        prev = torch.zeros(32, 2, **f32)
    elif case == "K = 3":
        yr, yi, prev = torch.ones(64, 3), torch.ones(64, 3), torch.zeros(3, 2)
    elif case == "K = 256":
        yr, yi = torch.ones(64, 256), torch.ones(64, 256)
        prev = torch.zeros(256, 2)
    elif case == "planes differ":
        yi = torch.ones(65, 16, **f32)
    elif case == "1-D planes":
        yr, yi = yr.reshape(-1), yi.reshape(-1)
    elif case == "no frames":
        yr, yi = torch.ones(0, 16), torch.ones(0, 16)
    return yr, yi, prev


@pytest.mark.parametrize("case", [
    "float64 plane", "float64 prev", "strided plane", "strided prev",
    "prev [K, 3]", "prev [2K, 2]", "K = 3", "K = 256", "planes differ",
    "1-D planes", "no frames"])
def test_wrapper_refuses_before_dispatch(monkeypatch, case):
    def dispatched(*a, **kw):
        raise AssertionError("dispatched")

    monkeypatch.setattr(LD, "_plain", dispatched)
    monkeypatch.setattr(_build, "load", dispatched)
    n0 = LD.launches
    with pytest.raises(ValueError):
        LD.lag1_demod(*_bad(case))
    assert LD.launches == n0


def test_plain_takes_any_k_and_layout():
    # the staged tensor route serves configs the kernel does not take
    rng = np.random.default_rng(5)
    yr, yi = _planes(rng, 40, 3)
    prev = torch.zeros(2, 3).T
    d, nprev = LD.lag1_demod_plain(yr, yi, prev)
    want = _tensor_demod(yr, yi, prev, demod.fast_atan2)
    assert torch.equal(d, want[0]) and torch.equal(nprev, want[1])


@pytest.mark.parametrize("k,frames,aligned", [
    (64, 64, True),            # one tile
    (64, 3 * 64 + 17, True),   # a ragged last tile
    (64, 1000, False),         # scalar loads throughout
    (16, 256 + 5, True),
    (2, 2048 + 3, True),       # rows of 8 bytes: a cut last quad
    (128, 31, True),           # less than a tile
    (1, 4097, True),
])
def test_kernel_replay_equals_plain(k, frames, aligned):
    # the polynomial atan2 only: PyTorch's CPU atan2 rounds otherwise in
    # its vectorised and scalar loops, which the replay's order moves
    rng = np.random.default_rng(k * frames)
    yr, yi = _planes(rng, frames, k)
    yr[0, 0], yi[0, 0] = -1.0, -0.0
    prev = _prev(rng, k, "mid")
    prev[0] = 0.0
    d, nprev, writes = replay.replay(yr.numpy(), yi.numpy(), prev.numpy(),
                                     aligned=aligned)
    want = LD.lag1_demod_plain(yr, yi, prev)
    assert (writes == 1).all()
    assert torch.equal(torch.from_numpy(d), want[0])
    assert torch.equal(torch.from_numpy(nprev), want[1])


@pytest.mark.parametrize("k", [1, 2, 4, 8, 16, 32, 64, 128])
def test_kernel_plan_fits_and_its_transpose_banks(k):
    # 6 blocks an SM (228 KB, 1 KB reserved a block); the transpose is
    # conflict-free where a warp's 32 samples are 32 channels of a frame
    assert replay.SMEM_BYTES * 6 + 6 * 1024 <= 228 * 1024
    assert k * (replay.TILE // k + 1) <= 2 * replay.TILE
    ways = replay.transpose_banks(k)
    assert ways == 1 if k >= 32 else ways <= 32 // k


def test_staged_kernel_route_imports_no_dynamo():
    # A torch.library op's first call imports torch._dynamo, seconds of a
    # server's set-up; the staged step's wrappers are plain functions.
    code = (
        "import sys, torch\n"
        "from comms_tpu_torch.models import fm_band_monitor as bm\n"
        "cfg = bm.BandMonitorConfig(num_channels=16, block=16384)\n"
        "step = bm.make_planar_block_fn(cfg, use_kernel=True)\n"
        "x = torch.ones(16384)\n"
        "step(bm.init_state(cfg, device='cpu'), x, x)\n"
        "assert 'torch._dynamo' not in sys.modules\n")
    env = dict(os.environ, PYTHONPATH=str(REPO))
    res = subprocess.run([sys.executable, "-c", code], cwd=str(REPO),
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr
