"""The lag-1 demod kernel (``csrc/lag1_demod.cu``) against its plain
PyTorch version on a CUDA card, and the staged band monitor's kernel
route against its tensor route there.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a CUDA device the tests skip: the kernel has no CPU mode.
"""

import math

import numpy as np
import pytest
import torch

from comms_tpu_torch.kernels import channelizer as CK
from comms_tpu_torch.kernels import decim_fir as DF
from comms_tpu_torch.kernels import lag1_demod as LD
from comms_tpu_torch.models import fm_band_monitor as tmodel

# The products round as in plain; nvcc contracts the polynomial's Horner
# steps to FMAs, which moves d by a few ulp of pi (2.4e-7 each).
TOL_D = 1e-6
# The staged step, kernel route against tensor route: the channelizer
# kernel's FFT and the FIR kernel's sums round otherwise (the benchmark's
# limit on the audio, relative to its largest value).
TOL_AUDIO = 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _planes(rng, frames, k, dev):
    return tuple(torch.from_numpy(rng.normal(size=(frames, k))
                                  .astype(np.float32)).to(dev)
                 for _ in range(2))


def _frames(k, size):
    tf = 4096 // k
    return {"tile": tf, "ragged": 3 * tf + 17, "cell": 409_600}[size]


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
@pytest.mark.parametrize("size", ["tile", "ragged", "cell"])
@pytest.mark.parametrize("k", [16, 64])
def test_kernel_matches_plain(cuda, k, size, fast):
    rng = np.random.default_rng(k + len(size))
    yr, yi = _planes(rng, _frames(k, size), k, cuda)
    prev = torch.from_numpy(rng.normal(size=(k, 2)).astype(np.float32)).to(
        cuda)
    n0 = LD.launches
    d, nprev = LD.lag1_demod(yr, yi, prev, fast=fast)
    want = LD.lag1_demod_plain(yr, yi, prev, fast=fast)
    torch.cuda.synchronize()
    assert LD.launches == n0 + 1
    assert d.shape == want[0].shape and d.is_contiguous()
    assert float((d - want[0]).abs().max()) <= TOL_D
    assert torch.equal(nprev, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 16, 64, 128])
def test_kernel_unaligned_planes(cuda, k):
    # contiguous views 4 bytes into their storage: scalar loads
    rng = np.random.default_rng(k)
    frames = 2 * (4096 // k) + 3
    buf = _planes(rng, frames * k + 1, 1, cuda)
    yr, yi = (b.reshape(-1)[1:].view(frames, k) for b in buf)
    prev = torch.zeros((k, 2), device=cuda)
    d, nprev = LD.lag1_demod(yr, yi, prev)
    want = LD.lag1_demod_plain(yr, yi, prev)
    torch.cuda.synchronize()
    assert float((d - want[0]).abs().max()) <= TOL_D
    assert torch.equal(nprev, want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("fast", [True, False])
def test_stream_start_signed_zeros(cuda, fast):
    # From a zero prev both products of frame 0 are signed zeros:
    # Im = c*0 - a*0 and Re = a*0 + c*0 take their signs from (a, c), and
    # atan2(+-0, -0) = +-pi.  Every sign pair of (a, c), zeros included.
    vals = [-1.0, -0.0, 0.0, 1.0]
    pairs = [(a, c) for a in vals for c in vals]
    k = len(pairs)
    yr = torch.ones((64, k))
    yi = torch.ones((64, k))
    yr[0] = torch.tensor([a for a, _ in pairs])
    yi[0] = torch.tensor([c for _, c in pairs])
    yr, yi = yr.to(cuda), yi.to(cuda)
    prev = torch.zeros((k, 2), device=cuda)
    d, _ = LD.lag1_demod(yr, yi, prev, fast=fast)
    want, _ = LD.lag1_demod_plain(yr, yi, prev, fast=fast)
    torch.cuda.synchronize()
    assert torch.equal(d[:, 0], want[:, 0])
    assert torch.equal(torch.signbit(d[:, 0]), torch.signbit(want[:, 0]))
    pi = torch.tensor(math.pi, dtype=torch.float32).item()
    for i, (a, c) in enumerate(pairs):
        # Re = -0 exactly where a and c are both <= 0 in sign
        re_neg = math.copysign(1, a) < 0 and math.copysign(1, c) < 0
        im_neg = math.copysign(1, c) < 0 < math.copysign(1, a)
        want_i = (-pi if im_neg else pi) if re_neg else (-0.0 if im_neg
                                                          else 0.0)
        assert d[i, 0].item() == want_i, (a, c)
        assert math.copysign(1, d[i, 0].item()) == math.copysign(1, want_i)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [16, 64])
def test_two_halves_equal_one_call(cuda, k):
    rng = np.random.default_rng(40 + k)
    frames = 5 * (4096 // k) + 9
    yr, yi = _planes(rng, frames, k, cuda)
    prev = torch.from_numpy(rng.normal(size=(k, 2)).astype(np.float32)).to(
        cuda)
    one, p_one = LD.lag1_demod(yr, yi, prev)
    h = 2 * (4096 // k) + 5
    a, p_a = LD.lag1_demod(yr[:h], yi[:h], prev)
    b, p_b = LD.lag1_demod(yr[h:], yi[h:], p_a)
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([a, b], 1), one)
    assert torch.equal(p_b, p_one)


def _stations(n, k, seed, dev):
    """One FM station at the centre of each of the k channels, a tone
    each, deviation a quarter of the spacing, plus noise of sigma 0.01:
    every phase step stays within about +-pi/2 (chip_smoke.py's station
    capture), so the two routes' roundings cannot cross the branch cut."""
    f64 = dict(dtype=torch.float64, device=dev)
    t = torch.arange(n, **f64)
    re = torch.zeros(n, **f64)
    im = torch.zeros(n, **f64)
    for c in range(k):
        fa = 0.01 + 0.04 * c / (k - 1)
        ph = (2 * np.pi * c / k) * t + (2 * np.pi * 0.25 / k) * torch.cumsum(
            torch.sin((2 * np.pi * fa / k) * t), 0)
        re += torch.cos(ph)
        im += torch.sin(ph)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    re = re / k + 0.01 * torch.randn(n, generator=g, **f64)
    im = im / k + 0.01 * torch.randn(n, generator=g, **f64)
    return re.float(), im.float()


def _cell_cfg():
    # the benchmark cell's channels, branch taps and decimation, at a
    # block whose frames fill the FIR kernel's tiles
    cfg = tmodel.BandMonitorConfig(num_channels=64, taps_per_branch=13,
                                   block=327_680, audio_dec=5)
    assert tmodel._audio_tile_rows(cfg) > 0
    return cfg


@pytest.mark.cuda
def test_staged_step_kernel_route_against_tensor_route(cuda):
    cfg = _cell_cfg()
    re, im = _stations(3 * cfg.block, cfg.num_channels, 7, cuda)
    routes = {uk: tmodel.make_planar_block_fn(cfg, use_kernel=uk)
              for uk in (True, False)}
    states = {uk: tmodel.init_state(cfg, cuda) for uk in routes}
    for b in range(3):
        x = (re[b * cfg.block:(b + 1) * cfg.block],
             im[b * cfg.block:(b + 1) * cfg.block])
        out = {}
        for uk, step in routes.items():
            out[uk], states[uk] = step(states[uk], *x)
        torch.cuda.synchronize()
        err = float((out[True] - out[False]).abs().max())
        assert err <= TOL_AUDIO * float(out[False].abs().max()), b
        assert float((states[True][1] - states[False][1]).abs().max()) \
            <= 1e-5


@pytest.mark.cuda
def test_one_launch_a_block_and_no_host_sync(cuda):
    cfg = _cell_cfg()
    re, im = _stations(2 * cfg.block, cfg.num_channels, 8, cuda)
    step = tmodel.make_planar_block_fn(cfg)
    st = tmodel.init_state(cfg, cuda)
    _, st = step(st, re[:cfg.block], im[:cfg.block])   # warm: constants
    torch.cuda.synchronize()
    counts = (LD.launches, CK.launches, DF.launches)
    torch.cuda.set_sync_debug_mode("error")
    try:
        audio, st = step(st, re[cfg.block:], im[cfg.block:])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    assert (LD.launches, CK.launches, DF.launches) == tuple(
        c + 1 for c in counts)
    assert audio.shape == (64, cfg.audio_per_channel)
    assert torch.isfinite(audio).all()
