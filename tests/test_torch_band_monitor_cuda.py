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
