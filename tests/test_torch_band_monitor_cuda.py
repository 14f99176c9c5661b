"""The band monitor's CUDA kernels against their plain PyTorch versions
on a CUDA card: the channelizer, the decimating FIR (both entries) and
the fused band monitor, at small sizes.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a CUDA device the tests skip: the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

from comms_tpu_torch.kernels import band_monitor as TBM
from comms_tpu_torch.kernels import channelizer as TCK
from comms_tpu_torch.kernels import decim_fir as TDF
from comms_tpu_torch.models import fm_band_monitor as tmodel
from comms_tpu_torch.ops import channelizer as tchan

# float32 on both sides in other summation orders.  The band monitor on
# white noise can put a phase step near +-pi, where the two orders may
# land on either side of the branch cut; the station capture cannot.
TOL_CHAN = 1e-5
TOL_FIR = 5e-5
TOL_BM = 2e-4


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _planes(rng, n, dev):
    return tuple(torch.from_numpy(rng.normal(size=n).astype(np.float32))
                 .to(dev) for _ in range(2))


def _err(a, b):
    return float((a - b).abs().max()) / max(float(b.abs().max()), 1e-30)


@pytest.mark.cuda
@pytest.mark.parametrize("K", [16, 64, 128])
def test_channelizer_kernel_matches_plain(cuda, K):
    rng = np.random.default_rng(K)
    h = tchan.design_prototype(K, 8)
    re, im = _planes(rng, 2 * TCK.step_samples(), cuda)
    cr, ci = _planes(rng, TCK.CTX_SAMPLES, cuda)
    n = TCK.launches
    got = TCK.channelize_planar(re, im, h, cr, ci, num_channels=K)
    want = TCK.channelize_plain(re, im, h, cr, ci, num_channels=K)
    torch.cuda.synchronize()
    assert TCK.launches == n + 1
    for g, w in zip(got[:2], want[:2]):
        assert g.shape == w.shape and _err(g, w) < TOL_CHAN
    assert torch.equal(got[2], want[2])


@pytest.mark.cuda
@pytest.mark.parametrize("dec,taps,cplx", [(4, 32, False), (5, 63, True),
                                           (1, 129, False), (5, 640, False)])
def test_decim_fir_kernel_matches_plain_and_chops_exactly(cuda, dec, taps,
                                                          cplx):
    rng = np.random.default_rng(dec * taps)
    h = rng.normal(size=taps)
    if cplx:
        h = h + 1j * rng.normal(size=taps)
    N = 2 * 8 * dec * 128
    xr, xi = _planes(rng, (3, N), cuda)
    cr, ci = _planes(rng, (3, dec * 128), cuda)
    n = TDF.launches
    yr, yi, nr, _ = TDF.fir_decimate_planar(xr, xi, h, dec, cr, ci,
                                            tile_rows=8)
    wr, wi = TDF.fir_decimate_plain(xr, xi, h, dec, cr, ci)
    torch.cuda.synchronize()
    assert TDF.launches == n + 1
    assert _err(torch.complex(yr, yi), torch.complex(wr, wi)) < TOL_FIR
    # Chopped in two, through the carried context: bit for bit.
    half = N // 2
    ar, ai, c2r, c2i = TDF.fir_decimate_planar(
        xr[:, :half].contiguous(), xi[:, :half].contiguous(), h, dec, cr,
        ci, tile_rows=8)
    br, bi, _, _ = TDF.fir_decimate_planar(
        xr[:, half:].contiguous(), xi[:, half:].contiguous(), h, dec, c2r,
        c2i, tile_rows=8)
    assert torch.equal(torch.cat([ar, br], 1), yr)
    assert torch.equal(torch.cat([ai, bi], 1), yi)


@pytest.mark.cuda
@pytest.mark.parametrize("taps", [63, 641])
def test_poly_fir_entry_matches_plain(cuda, taps):
    rng = np.random.default_rng(taps)
    h = rng.normal(size=taps)
    dec = 5
    re, im = _planes(rng, TDF.step_samples(dec), cuda)
    cr, ci = _planes(rng, TDF.CTX_ROWS * dec * 128, cuda)
    yr, yi, _, _ = TDF.poly_fir_planar(re, im, h, cr, ci, dec)
    wr, wi = TDF.fir_decimate_plain(re, im, h, dec, cr, ci)
    torch.cuda.synchronize()
    assert _err(torch.complex(yr, yi), torch.complex(wr, wi)) < TOL_FIR


@pytest.mark.cuda
@pytest.mark.parametrize("K", [16, 64])
def test_band_monitor_kernel_matches_plain_streamed(cuda, K):
    rng = np.random.default_rng(100 + K)
    cfg = tmodel.BandMonitorConfig(num_channels=K,
                                   block=TBM.step_samples())
    st_k = tmodel.init_state_fused(cfg, cuda)
    st_p = st_k
    n = TBM.launches
    for _ in range(3):
        re, im = _planes(rng, cfg.block, cuda)
        args = (cfg.prototype, cfg.audio_taps, cfg.audio_dec)
        got = TBM.band_monitor_planar(re, im, *args, *st_k, num_channels=K)
        want = TBM.band_monitor_plain(re, im, *args, *st_p, num_channels=K)
        torch.cuda.synchronize()
        assert got[0].shape == want[0].shape
        assert _err(got[0], want[0]) < TOL_BM
        assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
        for g, w in zip(got[3:], want[3:]):
            assert _err(g, w) < TOL_CHAN
        st_k, st_p = got[1:], want[1:]
    assert TBM.launches == n + 3


def _stations(n, K, seed, dev):
    """f32 planes [n] on the card: one FM station at the centre of each
    of the K channels (a tone at 0.01 + 0.04*c/(K-1) of the channel rate,
    deviation 0.25 of the spacing), scaled by 1/K, plus noise of sigma
    0.01.  Every phase step per channel frame stays within about +-pi/2,
    far from the atan2 branch cut."""
    f64 = dict(dtype=torch.float64, device=dev)
    t = torch.arange(n, **f64)
    re = torch.zeros(n, **f64)
    im = torch.zeros(n, **f64)
    for c in range(K):
        fa = 0.01 + 0.04 * c / max(K - 1, 1)
        ph = (2 * np.pi * c / K) * t + (2 * np.pi * 0.25 / K) * torch.cumsum(
            torch.sin((2 * np.pi * fa / K) * t), 0)
        re += torch.cos(ph)
        im += torch.sin(ph)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    re = re / K + 0.01 * torch.randn(n, generator=g, **f64)
    im = im / K + 0.01 * torch.randn(n, generator=g, **f64)
    return re.float(), im.float()


def _bm(cfg, x, st, fn=TBM.band_monitor_planar):
    return fn(x[0], x[1], cfg.prototype, cfg.audio_taps, cfg.audio_dec, *st,
              num_channels=cfg.num_channels)


def _equal(a, b):
    return all(torch.equal(u, v) for u, v in zip(a, b))


@pytest.mark.cuda
@pytest.mark.parametrize("K", [2, 4, 8, 16, 32, 64, 128])
@pytest.mark.parametrize("start", ["zero", "mid_stream"])
def test_band_monitor_every_k_matches_plain(cuda, K, start):
    step = TBM.step_samples()
    cfg = tmodel.BandMonitorConfig(num_channels=K, block=step)
    re, im = _stations(3 * step, K, K, cuda)
    st = tmodel.init_state_fused(cfg, cuda)
    if start == "mid_stream":
        st = _bm(cfg, (re[:step], im[:step]), st)[1:]
    x = (re[step:], im[step:])
    n = TBM.launches
    got = _bm(cfg, x, st)
    want = _bm(cfg, x, st, TBM.band_monitor_plain)
    torch.cuda.synchronize()
    assert TBM.launches == n + 1
    assert got[0].shape == want[0].shape == (2 * step // K // 4, K)
    assert torch.isfinite(got[0]).all()
    assert _err(got[0], want[0]) < TOL_BM
    assert torch.equal(got[1], want[1]) and torch.equal(got[2], want[2])
    for g, w in zip(got[3:], want[3:]):
        assert _err(g, w) < TOL_CHAN


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 17, 1024])
@pytest.mark.parametrize("start", ["zero", "mid_stream"])
def test_band_monitor_runs_repeat_and_partition(cuda, monkeypatch, steps,
                                                start):
    # 17 steps at K=16 is 68 tiles: one tile a block by default, runs of
    # 14 (the last one part-filled) over 5 blocks; 1024 steps is the main
    # path's block.  The output does not depend on the partition.
    step = TBM.step_samples()
    cfg = tmodel.BandMonitorConfig(num_channels=16, block=step)
    g = torch.Generator(device=cuda)
    g.manual_seed(steps)
    x = torch.randn(2, (steps + 1) * step, generator=g, device=cuda)
    st = tmodel.init_state_fused(cfg, cuda)
    if start == "mid_stream":
        st = _bm(cfg, (x[0, :step], x[1, :step]), st)[1:]
    x = (x[0, step:], x[1, step:])
    n = TBM.launches
    got = _bm(cfg, x, st)
    again = _bm(cfg, x, st)
    monkeypatch.setattr(TBM, "_RUN_BLOCKS", 5)
    other = _bm(cfg, x, st)
    torch.cuda.synchronize()
    assert TBM.launches == n + 3
    assert _equal(got, again) and _equal(got, other)
    want = _bm(cfg, x, st, TBM.band_monitor_plain)
    assert _err(got[0], want[0]) < TOL_BM


@pytest.mark.cuda
@pytest.mark.parametrize("K", [16, 64])
@pytest.mark.parametrize("steps", [2, 1024])
def test_band_monitor_two_halves_equal_one_call(cuda, K, steps):
    step = TBM.step_samples()
    cfg = tmodel.BandMonitorConfig(num_channels=K, block=step)
    re, im = _stations((steps + 1) * step, K, steps, cuda)
    st = _bm(cfg, (re[:step], im[:step]),
             tmodel.init_state_fused(cfg, cuda))[1:]
    re, im = re[step:], im[step:]
    one = _bm(cfg, (re, im), st)
    h = re.shape[0] // 2
    a = _bm(cfg, (re[:h], im[:h]), st)
    b = _bm(cfg, (re[h:], im[h:]), a[1:])
    torch.cuda.synchronize()
    assert torch.equal(torch.cat([a[0], b[0]]), one[0])
    assert _equal(b[1:], one[1:])


@pytest.mark.cuda
def test_band_monitor_stream_start_signed_zero(cuda):
    # Only x[0] reaches spectrum frame 0 (through C[0, K-1] = h[0]), so
    # Y[0, ch] = h[0] * x[0] in every channel; x[0] puts it in the third
    # quadrant, against the zero carried spectrum dotp = -0 and cross =
    # +0, so d[0] = atan2(+0, -0) = pi and audio[0, ch] = h_audio[0] * pi
    # (tests/test_torch_band_monitor.py holds the JAX kernel to the same).
    cfg = tmodel.BandMonitorConfig(num_channels=16,
                                   block=TBM.step_samples())
    rng = np.random.default_rng(5)
    x = rng.normal(size=(2, cfg.block)).astype(np.float32)
    x[:, 0] = -np.sign(cfg.prototype[0])
    x = torch.from_numpy(x).to(cuda)
    got = _bm(cfg, (x[0], x[1]), tmodel.init_state_fused(cfg, cuda))
    torch.cuda.synchronize()
    pi_h0 = torch.full((16,), float(np.float32(cfg.audio_taps[0]) * np.pi),
                       device=cuda)
    assert float((got[0][0] - pi_h0).abs().max()) < 1e-6
