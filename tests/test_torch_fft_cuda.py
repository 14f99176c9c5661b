"""The FFT kernels K6, K7 (both entries) and K10 (stage A in its three
ingest layouts, the PSD and FFT stages, sparse demean) against their
plain PyTorch versions on a CUDA card, at small shapes.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_fft_cuda.py

Without a CUDA device the tests skip: the kernels have no CPU mode.
Bounds, relative to the largest magnitude: 1e-5 for FFT outputs and
stage A, 2e-5 for PSDs (the JAX tests' bounds); the plain versions are
cuFFT in float32, so both sides carry float32 rounding.  K7 on streams
of many segments is also held bin by bin (each bin's error relative to
that bin) at 2e-5, against the plain version and a float64 oracle.
"""

import numpy as np
import pytest
import torch

from comms_tpu_torch.kernels import fft as TFK
from comms_tpu_torch.kernels import fft_big as TFB
from comms_tpu_torch.ops import spectrum as tspec

TOL_FFT = 1e-5
TOL_PSD = 2e-5


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _rel(a, b):
    return float((a - b).abs().max() / b.abs().max())


def _bin(a, b):
    """The largest error of a PSD bin relative to that bin of ``b``."""
    return float(((a.to(b.dtype) - b).abs() / b.abs()).max())


def _planes(shape, seed, offset=0.0):
    g = torch.Generator(device="cuda")
    g.manual_seed(seed)
    x = torch.randn((2,) + tuple(shape), generator=g, device="cuda")
    return x[0] + offset, x[1] - offset


@pytest.mark.cuda
@pytest.mark.parametrize("n, rows", [
    (256, 37), (1024, 8), (4096, 3), (8192, 2), (16384, 3),
    # one row, and row counts that leave the last block part-filled (a
    # block holds 2048 / n rows up to 2048 points)
    (256, 1), (512, 1), (512, 21), (1024, 1), (1024, 13), (2048, 1),
    (2048, 7), (4096, 1), (8192, 1), (16384, 1)])
def test_fft_matches_plain(n, rows):
    _card()
    re, im = _planes((rows, n), n)
    s = 1.0 / np.sqrt(n)
    before = TFK.launches["fft"]
    yr, yi = TFK.fft_planar(re, im, n, scale=s)
    wr, wi = TFK.fft_plain(re, im, s)
    torch.cuda.synchronize()
    assert TFK.launches["fft"] == before + 1
    assert _rel(torch.complex(yr, yi), torch.complex(wr, wi)) < TOL_FFT
    # the plane-swap involution: an exact bin reversal
    ur, ui = TFK.fft_planar(im, re, n, scale=s)
    ur2, ui2 = TFK.fft_planar(ur, ui, n, scale=s)
    rev = torch.remainder(-torch.arange(n, device="cuda"), n)
    got = torch.complex(ui2, ur2)
    assert _rel(got, torch.complex(re, im)[:, rev]) < 1e-4


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 2048, 16384])
def test_fft_reads_row_strided_views(n):
    # rows of a wider plane and overlapping unfold rows are read in place
    _card()
    re, im = _planes((5, 3 * n), 2 * n)
    s = 1.0 / n
    for r, i in ((re[:, n:2 * n], im[:, n:2 * n]),
                 (re.reshape(-1).unfold(0, n, n // 2),
                  im.reshape(-1).unfold(0, n, n // 2))):
        assert not r.is_contiguous()
        yr, yi = TFK.fft_planar(r, i, n, scale=s)
        wr, wi = TFK.fft_plain(r.contiguous(), i.contiguous(), s)
        torch.cuda.synchronize()
        assert yr.is_contiguous() and yr.shape == r.shape
        assert _rel(torch.complex(yr, yi), torch.complex(wr, wi)) < TOL_FFT


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1024, 4096, 16384])
def test_psd_rows_match_plain(n):
    _card()
    rows = 7
    re, im = _planes((rows, n), n + 1, offset=0.3)
    win = tspec.hann(n)
    wts = torch.tensor([1, 0, 1, 1, 0, 1, 1], dtype=torch.float32,
                       device="cuda")
    for rw, demean in ((None, True), (wts, True), (wts, False)):
        got = TFK.psd_planar(re, im, win, n, row_weights=rw, demean=demean)
        want = TFK.psd_plain(re, im, win, rw, demean)
        torch.cuda.synchronize()
        assert _rel(got, want) < TOL_PSD, (rw is None, demean)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 512, 1024, 2048, 4096, 8192, 16384])
def test_psd_stream_matches_plain_and_rows(n):
    _card()
    N = 3 * TFK.rows_per_step(n) * n
    re, im = _planes((N,), 7 * n, offset=0.1)
    win = tspec.hann(n)
    before = TFK.launches["psd_stream"]
    got = TFK.psd_stream_planar(re, im, win, n)
    again = TFK.psd_stream_planar(re, im, win, n)
    want = TFK.psd_stream_plain(re, im, win, n)
    f64 = TFK.psd_stream_plain(re.double(), im.double(), win, n)
    rows = TFK.psd_planar(re.unfold(0, n, n // 2), im.unfold(0, n, n // 2),
                          win, n)
    torch.cuda.synchronize()
    assert TFK.launches["psd_stream"] == before + 2
    assert torch.equal(got, again)             # fixed summation order
    assert torch.equal(got, rows)              # one kernel, two entries
    assert _rel(got, want) < TOL_PSD
    assert _bin(got, want) < TOL_PSD
    assert _bin(got, f64) < TOL_PSD


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1024, 8192, 16384])
def test_psd_part_filled_runs_and_blocks(n):
    # One segment; one segment more than a full set of runs (runs of two,
    # the last run and block part-filled), read with the carry (an unfold
    # view) and without it (contiguous rows); and the stream at exactly
    # one rows_per_step(n) * n samples.
    _card()
    win = tspec.hann(n)
    T = n // 16
    full = max(TFK._PSD_RUN_THREADS // T,
               TFK._PSD_MIN_BLOCKS * (max(TFK._PSD_MIN_THREADS, T) // T))
    assert TFK.psd_partition(full, n)[0] == 1
    assert TFK.psd_partition(full + 1, n)[0] == 2
    for rows in (1, full + 1):
        re, im = _planes((rows * n,), rows + n)
        views = ((re.unfold(0, n, n // 2)[:rows],
                  im.unfold(0, n, n // 2)[:rows]),
                 (re.view(rows, n), im.view(rows, n)))
        for r, i in views:
            got = TFK.psd_planar(r, i, win, n)
            want = TFK.psd_plain(r.contiguous(), i.contiguous(), win)
            torch.cuda.synchronize()
            assert _rel(got, want) < TOL_PSD, (rows, r.stride())
    N = TFK.rows_per_step(n) * n
    re, im = _planes((N,), 5 * n, offset=-0.2)
    got = TFK.psd_stream_planar(re, im, win, n)
    rows = TFK.psd_planar(re.unfold(0, n, n // 2), im.unfold(0, n, n // 2),
                          win, n)
    want = TFK.psd_stream_plain(re, im, win, n)
    torch.cuda.synchronize()
    assert torch.equal(got, rows)
    assert _rel(got, want) < TOL_PSD


@pytest.mark.cuda
@pytest.mark.parametrize("n", [256, 1024, 4096, 16384])
def test_psd_rows_at_other_strides(n):
    # Row strides other than n/2 take the 16-point load: rows at stride n,
    # at stride n/4 (75% overlap) and rows of a wider plane; with row
    # weights that hold zeros, and with demean off.
    _card()
    rows = 9
    base, base_i = _planes((rows, 3 * n), 11 * n, offset=0.3)
    flat, flat_i = base.reshape(-1), base_i.reshape(-1)
    win = tspec.hann(n)
    wts = torch.tensor([1, 0, 1, 1, 0, 1, 1, 1, 0], dtype=torch.float32,
                       device="cuda")
    views = {"n": (flat[:rows * n].view(rows, n),
                   flat_i[:rows * n].view(rows, n)),
             "n/4": (flat.unfold(0, n, n // 4)[:rows],
                     flat_i.unfold(0, n, n // 4)[:rows]),
             "wider": (base[:, n:2 * n], base_i[:, n:2 * n])}
    for name, (r, i) in views.items():
        for rw, demean in ((None, True), (wts, True), (wts, False),
                           (None, False)):
            got = TFK.psd_planar(r, i, win, n, row_weights=rw,
                                 demean=demean)
            again = TFK.psd_planar(r, i, win, n, row_weights=rw,
                                   demean=demean)
            rc, ic = r.contiguous(), i.contiguous()
            want = TFK.psd_plain(rc, ic, win, rw, demean)
            f64 = TFK.psd_plain(rc.double(), ic.double(), win,
                                None if rw is None else rw.double(), demean)
            torch.cuda.synchronize()
            assert torch.equal(got, again), name
            assert _rel(got, want) < TOL_PSD, (name, rw is None, demean)
            assert _rel(got.double(), f64) < TOL_PSD, (name, demean)


@pytest.mark.cuda
def test_psd_demeans_a_large_offset():
    # An offset of 100 on both planes, demean on: the mean leaves each
    # segment before the window and the FFT, so every bin stays within
    # 2e-5 of float64 (1023 segments of 1024 points).
    _card()
    n = 1024
    N = 4 * TFK.rows_per_step(n) * n
    g = torch.Generator(device="cuda")
    g.manual_seed(100)
    x = torch.randn(2, N, generator=g, device="cuda")
    re, im = x[0] + 100.0, x[1] - 100.0
    win = tspec.hann(n)
    got = TFK.psd_stream_planar(re, im, win, n)
    want = TFK.psd_stream_plain(re, im, win, n)
    f64 = TFK.psd_stream_plain(re.double(), im.double(), win, n)
    torch.cuda.synchronize()
    assert _bin(got, f64) < TOL_PSD
    assert _bin(got, want) < TOL_PSD


def _layouts(re, im, n1, n2):
    """The three ingest layouts of the same segments."""
    b = re.shape[0]

    def blocked(p):
        return p.reshape(b, n1, n2 // 128, 128).permute(0, 2, 1, 3)

    return {"flat": (re, im),
            "3d": (re.reshape(b, n1, n2), im.reshape(b, n1, n2)),
            "blocked": (blocked(re).contiguous(), blocked(im).contiguous())}


@pytest.mark.cuda
@pytest.mark.parametrize("n1, n2, b", [
    (256, 512, 3), (1024, 256, 2), (2048, 2048, 1),
    # every factor as n1 and as n2, one and three segments
    (256, 2048, 1), (256, 2048, 3), (512, 1024, 1), (512, 1024, 3),
    (1024, 512, 1), (1024, 512, 3), (2048, 256, 1), (2048, 256, 3)])
def test_fft_big_stages_match_plain(n1, n2, b):
    _card()
    N = n1 * n2
    re, im = _planes((b, N), n1 + n2, offset=0.2)
    w = torch.from_numpy(tspec.hann(N).astype(np.float32)).cuda()
    means = torch.stack([re.mean(1), im.mean(1)], -1)
    want_d = TFB.stage_a_plain(re, im, n1, n2, w, means)
    d = {}
    for name, (r, i) in _layouts(re, im, n1, n2).items():
        dr, di, _ = TFB.stage_a(r, i, n1, n2, w, means)
        d[name] = torch.complex(dr, di)
    torch.cuda.synchronize()
    assert _rel(d["flat"], want_d) < TOL_FFT
    assert torch.equal(d["3d"], d["flat"])
    assert torch.equal(d["blocked"], d["flat"])

    before = dict(TFB.launches)
    psd = TFB.psd_big_planar(re, im, n1, n2, window=w, means=means)
    again = TFB.psd_big_planar(re, im, n1, n2, window=w, means=means)
    yr, yi = TFB.fft_big_planar(re, im, n1, n2)
    torch.cuda.synchronize()
    # one stage A per entry call; the PSD's stage B is a fixed plan of
    # launches per call
    assert TFB.launches["stage_a"] == before["stage_a"] + 3
    assert (TFB.launches["psd_stage_b"]
            == before["psd_stage_b"] + 2 * TFB.PSD_STAGE_B_LAUNCHES)
    assert TFB.launches["fft_stage_b"] == before["fft_stage_b"] + 1
    assert torch.equal(psd, again)             # fixed summation order
    assert _rel(psd, TFB.psd_big_plain(re, im, n1, n2, w, means)) < TOL_PSD
    wr, wi = TFB.fft_big_plain(re, im, n1, n2)
    assert _rel(torch.complex(yr, yi), torch.complex(wr, wi)) < TOL_FFT
    nowin = TFB.psd_big_planar(re, im, n1, n2)
    assert _rel(nowin, TFB.psd_big_plain(re, im, n1, n2)) < TOL_PSD


@pytest.mark.cuda
def test_fft_big_sparse_demean_and_welch_numerator():
    _card()
    n1, n2, b = 512, 512, 4
    N = n1 * n2
    re, im = _planes((b, N), 3, offset=0.05)
    w = tspec.hann(N)
    got = TFB.psd_big_planar(re, im, n1, n2, window=w, sparse_demean=True)
    want = TFB.psd_big_plain(re, im, n1, n2, w, sparse_demean=True)
    num = TFB.welch_numerator(re, im, w)
    torch.cuda.synchronize()
    assert _rel(got, want) < TOL_PSD
    assert _rel(num, got) < TOL_PSD
