"""The recurrence kernels (csrc/recurrence.cu) on a CUDA card: the Costas
loop and the per-sample AGC against their plain versions on the same
card, one launch a call and no host synchronisation; the complex entries
of ``ops`` on the kernels; vmap of both over two streams equal to two
calls, in one launch; the batched entries (B streams a launch: a partial
warp, several blocks; contiguous, row-strided and stride-2 planes)
against the batched plain versions bit for bit.

Both sides are float32 with every product and sum rounded as written, and
the card's accurate sincosf/atan2f/hypotf/logf/expf on both, so the
kernel and its plain version agree to within TOL (measured: see
PERF.md).  The Costas input is locked from the first symbol (QPSK symbols
under a small carrier offset and noise), so ulp-level differences do not
steer the loop onto another path.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_recurrence_cuda.py

Without a CUDA device the tests skip: the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

from comms_tpu_torch.kernels import recurrence as R
from comms_tpu_torch.ops import agc, demodulation

# kernel against plain on the card: the outputs are O(1) (unit-energy
# symbols, a unit-RMS AGC target), so an absolute bound
TOL = 1e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _locked_symbols(n: int, seed: int, dev):
    """QPSK symbols turned by a phase ramp of 1e-3 rad a symbol from 0.05
    rad, with Gaussian noise of sigma 0.02: the loop is locked from the
    first symbol."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2, size=(2, n))
    s = ((2 * b[0] - 1) + 1j * (2 * b[1] - 1)) / np.sqrt(2)
    s = s * np.exp(1j * (0.05 + 1e-3 * np.arange(n)))
    s = s + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    x = torch.from_numpy(s.astype(np.complex64)).to(dev)
    return x


def _close(a, b):
    return float((a - b).abs().max()) <= TOL


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 17, 2048])
def test_costas_kernel_against_plain(cuda, n):
    x = _locked_symbols(n, n, cuda)
    xr, xi = x.real.contiguous(), x.imag.contiguous()
    ph0 = torch.tensor(0.01, device=cuda)
    fr0 = torch.tensor(-2e-4, device=cuda)
    n0 = R.launches["costas_loop"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    got = R.costas_loop(xr, xi, ph0, fr0, 0.1, 0.005)
    torch.cuda.set_sync_debug_mode(0)
    assert R.launches["costas_loop"] == n0 + 1
    want = R.costas_loop_plain(xr, xi, ph0, fr0, 0.1, 0.005)
    for g, w in zip(got, want):
        assert g.shape == w.shape and g.device.type == "cuda"
        assert _close(g, w)
    # the strided re/im views of the complex tensor give the same bits
    y, (ph, fr) = demodulation.costas_loop_block(x, (ph0, fr0), 0.1, 0.005)
    assert torch.equal(y.real, got[0]) and torch.equal(y.imag, got[1])
    assert torch.equal(ph, got[2]) and torch.equal(fr, got[3])


@pytest.mark.cuda
def test_costas_kernel_order_2(cuda):
    x = _locked_symbols(512, 3, cuda)
    xr = x.real.contiguous()
    xi = torch.zeros_like(xr)
    z = torch.zeros((), device=cuda)
    got = R.costas_loop(xr, xi, z, z, 0.05, 0.002, order=2)
    want = R.costas_loop_plain(xr, xi, z, z, 0.05, 0.002, order=2)
    for g, w in zip(got, want):
        assert _close(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 4096])
def test_agc_kernel_against_plain(cuda, n):
    rng = np.random.default_rng(n)
    amp = np.where(np.arange(n) < n // 2, 0.1, 2.0)
    x = torch.from_numpy((amp * np.exp(1j * 0.3 * np.arange(n))
                          + 0.01 * rng.normal(size=n)).astype(np.complex64)
                         ).to(cuda)
    g0 = agc.agc_init(device=cuda)
    n0 = R.launches["agc_scan"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    y, g = agc.agc_scan(x, g0, rate=5e-2)
    torch.cuda.set_sync_debug_mode(0)
    assert R.launches["agc_scan"] == n0 + 1
    yr, yi, gp = R.agc_scan_plain(x.real, x.imag, g0, 1.0, 5e-2)
    assert _close(y.real, yr) and _close(y.imag, yi) and _close(g, gp)


@pytest.mark.cuda
def test_recurrences_under_vmap(cuda):
    xs = torch.stack([_locked_symbols(300, s, cuda) for s in (1, 2)])
    st = (torch.tensor([0.0, 0.02], device=cuda),
          torch.tensor([0.0, 1e-4], device=cuda))
    n0 = R.launches["costas_loop"]
    y, (ph, fr) = torch.func.vmap(
        lambda x, p, f: demodulation.costas_loop_block(x, (p, f), 0.1,
                                                       0.005))(xs, *st)
    # one launch for both streams (the batched vmap rule)
    assert R.launches["costas_loop"] == n0 + 1
    for b in range(2):
        yb, (pb, fb) = demodulation.costas_loop_block(
            xs[b], (st[0][b], st[1][b]), 0.1, 0.005)
        assert torch.equal(y[b], yb)
        assert torch.equal(ph[b], pb) and torch.equal(fr[b], fb)
    g0 = torch.ones(2, device=cuda)
    n0 = R.launches["agc_scan"]
    ya, ga = torch.func.vmap(lambda x, g: agc.agc_scan(x, g))(xs, g0)
    assert R.launches["agc_scan"] == n0 + 1
    for b in range(2):
        yb, gb = agc.agc_scan(xs[b], g0[b])
        assert torch.equal(ya[b], yb) and torch.equal(ga[b], gb)


def _planes(x, layout):
    """Re/im planes of complex [B, n] ``x``: contiguous, the stride-2 views
    of the complex tensor, or rows of a wider buffer (row stride n + 7)."""
    if layout == "views":
        v = torch.view_as_real(x)
        return v[..., 0], v[..., 1]
    if layout == "row_stride":
        B, n = x.shape
        buf = torch.zeros(2, B, n + 7, device=x.device)
        buf[0, :, 3:3 + n] = x.real
        buf[1, :, 3:3 + n] = x.imag
        return buf[0, :, 3:3 + n], buf[1, :, 3:3 + n]
    return x.real.contiguous(), x.imag.contiguous()


def _launch_no_sync(fn, key):
    n0 = R.launches[key]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert R.launches[key] == n0 + 1
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "views", "row_stride"])
@pytest.mark.parametrize("n", [0, 1, 17, 2048])
@pytest.mark.parametrize("B", [1, 33, 257])
def test_costas_batched_kernel_against_batched_plain(cuda, B, n, layout):
    x = _locked_symbols(B * n, B + n, cuda).reshape(B, n)
    xr, xi = _planes(x, layout)
    ph0 = torch.linspace(-0.05, 0.05, B, device=cuda)
    fr0 = torch.full((B,), -2e-4, device=cuda)
    for order in (4, 2):
        got = _launch_no_sync(lambda: R.costas_loop_batched(
            xr, xi, ph0, fr0, 0.1, 0.005, order), "costas_loop")
        want = R.costas_loop_batched_plain(xr, xi, ph0, fr0, 0.1, 0.005,
                                           order)
        for g, w in zip(got, want):
            assert g.shape == w.shape and g.device.type == "cuda"
            assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("layout", ["contiguous", "views", "row_stride"])
@pytest.mark.parametrize("n", [0, 1, 17, 2048])
@pytest.mark.parametrize("B", [1, 33, 257])
def test_agc_batched_kernel_against_batched_plain(cuda, B, n, layout):
    rng = np.random.default_rng(B + n)
    k = np.arange(n)
    amp = np.where(k < n // 2, 0.1, 2.0)
    x = (amp * np.exp(1j * (0.3 * k + rng.uniform(0, 6, (B, 1))))
         + 0.01 * rng.normal(size=(B, n)))
    xr, xi = _planes(torch.from_numpy(x.astype(np.complex64)).to(cuda),
                     layout)
    g0 = torch.linspace(0.5, 2.0, B, device=cuda)
    got = _launch_no_sync(lambda: R.agc_scan_batched(xr, xi, g0, 1.0, 5e-2),
                          "agc_scan")
    want = R.agc_scan_batched_plain(xr, xi, g0, 1.0, 5e-2)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g, w)
