"""The QPSK receiver's CUDA kernels against their plain PyTorch versions
on a CUDA card: the FIR (K4), the symbol kernel's three entries (K5) and
the panel reductions (K11), at small sizes; and the receiver's models on
the card against the same models on the CPU.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_qpsk_cuda.py

Without a CUDA device the tests skip: the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

from comms_tpu_torch.kernels import fir as TFK
from comms_tpu_torch.kernels import panel_reduce as TPR
from comms_tpu_torch.kernels import qpsk_sym as TQS
from comms_tpu_torch.models import qpsk_rx as trx
from comms_tpu_torch.models import qpsk_rx_stream as tstream

# float32 on both sides in other summation orders.  Symbols: the same
# angle decomposition on both sides, so only the products' order and
# sincosf's last bit differ.
TOL_FIR = 5e-5
TOL_SYM = 1e-4
TOL_PANEL = 1e-5
TOL_REDUCE = 1e-4


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
@pytest.mark.parametrize("T,cplx", [(32, False), (63, True), (257, True),
                                    (1025, False), (1, False)])
def test_fir_kernel_matches_plain_and_chops_exactly(cuda, T, cplx):
    rng = np.random.default_rng(T)
    h = rng.normal(size=T)
    if cplx:
        h = h + 1j * rng.normal(size=T)
    N = 4 * 8 * 128
    xr, xi = _planes(rng, N, cuda)
    cr, ci = (c.reshape(8, 128) for c in _planes(rng, 1024, cuda))
    n0 = TFK.launches
    yr, yi, nr, ni = TFK.fir_planar(xr, xi, h, cr, ci, tile_rows=8)
    wr, wi = TFK.fir_plain(xr, xi, h, cr, ci)
    torch.cuda.synchronize()
    assert TFK.launches == n0 + 1
    assert _err(torch.complex(yr, yi), torch.complex(wr, wi)) < TOL_FIR
    assert torch.equal(nr.reshape(-1), xr[-1024:])
    # chopping the stream in two blocks reproduces the one-shot output
    h2 = N // 2
    ar, ai, c2r, c2i = TFK.fir_planar(xr[:h2].contiguous(),
                                      xi[:h2].contiguous(), h, cr, ci,
                                      tile_rows=8)
    br, bi, _, _ = TFK.fir_planar(xr[h2:].contiguous(), xi[h2:].contiguous(),
                                  h, c2r, c2i, tile_rows=8)
    assert torch.equal(torch.cat([ar, br]), yr)
    assert torch.equal(torch.cat([ai, bi]), yi)


def _sym_args(rng, dev, shift2):
    w = torch.tensor(0.011, device=dev)
    lag = torch.tensor([-0.05, 0.7, 0.4, -0.06], device=dev)
    s2 = torch.tensor(shift2, dtype=torch.int32, device=dev)
    return w, lag, s2


@pytest.mark.cuda
@pytest.mark.parametrize("steps,shift2,with_ctx", [(1, -4, False),
                                                    (2, 3, True),
                                                    (1, 0, True)])
def test_symbol_entries_match_plain(cuda, steps, shift2, with_ctx):
    rng = np.random.default_rng(10 + steps + shift2)
    N = steps * TQS.IN_PER_STEP
    re, im = _planes(rng, N, cuda)
    cfg = trx.QpskRxConfig()
    w, lag, s2 = _sym_args(rng, cuda, shift2)
    fr, fi = trx.modulated_taps(cfg, w, lag, s2)
    ctx = _planes(rng, fr.shape[0] - 1, cuda) if with_ctx else None
    n0 = dict(TQS.launches)
    sr, si = TQS.qpsk_symbol_gemm(re, im, fr, fi, w * 4, 0.31, ctx)
    pr, pi = TQS.qpsk_symbol_plain(re, im, fr, fi, w * 4, 0.31, ctx)
    kr, ki = TQS.qpsk_symbol_gemm_scalars(re, im, cfg.mf_taps, w, lag, s2,
                                          phase0=0.31, ctx=ctx)
    torch.cuda.synchronize()
    assert TQS.launches["qpsk_symbol_gemm"] == n0["qpsk_symbol_gemm"] + 1
    assert (TQS.launches["qpsk_symbol_gemm_scalars"]
            == n0["qpsk_symbol_gemm_scalars"] + 1)
    want = torch.complex(pr, pi)
    assert sr.shape == (N // 4,)
    assert _err(torch.complex(sr, si), want) < TOL_SYM
    assert _err(torch.complex(kr, ki), want) < TOL_SYM


# 128 * 2641 samples: R = 2641 rows = 66 chunks of 40 rows and one row
# (qpsk_sym.panel_chunking), a length only the panel launcher takes.
_ONE_ROW_PAST = 128 * 2641


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 2, 3, _ONE_ROW_PAST])
@pytest.mark.parametrize("hw", [1, 8, 51, 63, 64])
def test_panels_match_plain_and_repeat_bit_for_bit(cuda, hw, steps):
    rng = np.random.default_rng(21 + hw + steps)
    N = steps * TQS.IN_PER_STEP if steps < 4 else steps
    re, im = _planes(rng, N, cuda)
    whole = TQS.kernel_ok(N, 44, 4)
    if not whole:
        rows, chunks = TQS.panel_chunking(N, hw)
        assert -(-(N - hw) // 128) == (chunks - 1) * rows + 1
    n0 = dict(TQS.launches)
    entry = TQS.qpsk_panels if whole else TQS._launch_panels
    got = entry(re, im, hw)
    again = entry(re, im, hw)
    want = TQS.qpsk_panels_plain(re, im, hw)
    torch.cuda.synchronize()
    assert TQS.launches["qpsk_panels"] == n0["qpsk_panels"] + 2 * whole
    scale = max(float(p.abs().max()) for p in want[:4])
    for g, a, w in zip(got[:4], again[:4], want[:4]):
        assert g.shape == w.shape == (128, 128 + 2 * hw)
        assert float((g - w).abs().max()) < TOL_PANEL * scale
        assert torch.equal(g, a)
    assert {k: got[4][k] for k in ("nd", "K", "Kp", "R", "width")} == {
        k: want[4][k] for k in ("nd", "K", "Kp", "R", "width")}
    if not whole:
        return
    # the symbol entries' panels are the same numbers
    z = torch.zeros(44, device=cuda)
    _, _, p2 = TQS.qpsk_symbol_gemm(re, im, z, z, 0.0, panels_hw=hw)
    w_, lag, s2 = _sym_args(rng, cuda, 0)
    _, _, p3 = TQS.qpsk_symbol_gemm_scalars(
        re, im, trx.QpskRxConfig().mf_taps, w_, lag, s2, panels_hw=hw)
    for g, a, b in zip(got[:4], p2[:4], p3[:4]):
        assert torch.equal(g, a) and torch.equal(g, b)


@pytest.mark.cuda
def test_panels_match_float64_panels(cuda):
    # 2^22 samples (one shard of the sharded receiver): 3xTF32 with
    # float32 sums against the panels of float64 copies of the planes
    rng = np.random.default_rng(22)
    re, im = _planes(rng, 1 << 22, cuda)
    hw = trx.QpskRxConfig().panel_hw
    got = TQS.qpsk_panels(re, im, hw)
    want = TQS.qpsk_panels_plain(re.double(), im.double(), hw)
    scale = max(float(p.abs().max()) for p in want[:4])
    err = max(float((g.double() - w).abs().max())
              for g, w in zip(got[:4], want[:4]))
    assert err < TOL_PANEL * scale


def _pack(panels):
    P1, P2, P3, P4, meta = panels
    w = meta["width"]
    p13 = torch.zeros((256, 256), device=P1.device)
    p24 = torch.zeros((256, 256), device=P1.device)
    p13[:128, :w], p13[128:, :w] = P1, P3
    p24[:128, :w], p24[128:, :w] = -P2, -P4
    return p13, p24


@pytest.mark.cuda
def test_panel_reductions_match_plain(cuda):
    rng = np.random.default_rng(31)
    re, im = _planes(rng, TQS.IN_PER_STEP, cuda)
    hw = trx.QpskRxConfig().panel_hw
    p13, p24 = _pack(TQS.qpsk_panels_plain(re, im, hw))
    n0 = TPR.launches
    got = TPR.panel_reductions(p13, p24, hw)
    want = TPR.panel_reductions_plain(p13, p24, hw)
    torch.cuda.synchronize()
    assert TPR.launches == n0 + 1
    scale = float(want[:2].abs().max())
    rows = [0, 1] + [8 + a for a in range(4)]
    assert float((got[rows] - want[rows]).abs().max()) < TOL_REDUCE * scale
    assert abs(float(got[2, 0] - want[2, 0])) < 1e-5
    zero = torch.ones(16, dtype=torch.bool)
    zero[rows + [2]] = False
    assert not got[zero].any() and not got[2, 1:].any()


def _qpsk_capture(n, seed=4):
    """QPSK at sps 4 through the matched filter's RRC, CFO 0.01 rad/sample
    and phase 0.6, as float32 planes (numpy)."""
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=n // 2, dtype=np.uint8)
    sym = (2.0 * bits[0::2] - 1) + 1j * (2.0 * bits[1::2] - 1)
    up = np.zeros(n, np.complex128)
    up[::4] = sym
    h = trx.QpskRxConfig().mf_taps.astype(np.float64)
    x = np.convolve(up, h)[:n] * np.exp(1j * (0.01 * np.arange(n) + 0.6))
    return (x.real.astype(np.float32), x.imag.astype(np.float32)), bits


@pytest.mark.cuda
def test_receiver_on_the_card_matches_the_cpu(cuda):
    (xr, xi), bits = _qpsk_capture(TQS.IN_PER_STEP)
    cfg = trx.QpskRxConfig()
    rx = trx.make_rx_fn_planar(cfg)
    n0 = dict(TQS.launches)
    sym_g, dg = rx(torch.from_numpy(xr).to(cuda), torch.from_numpy(xi).to(cuda))
    assert TQS.launches["qpsk_panels"] == n0["qpsk_panels"] + 1
    assert (TQS.launches["qpsk_symbol_gemm_scalars"]
            == n0["qpsk_symbol_gemm_scalars"] + 1)
    sym_c, dc = rx(torch.from_numpy(xr), torch.from_numpy(xi))
    assert int(dg["sym_phase"]) == int(dc["sym_phase"])
    assert abs(float(dg["freq"]) - float(dc["freq"])) < 1e-4
    assert abs(float(dg["timing"]) - float(dc["timing"])) < 1e-4
    assert _err(sym_g.cpu(), sym_c) < 1e-3
    (_, _), errs, m = trx.resolve_ambiguity(sym_g, bits, search=1500)
    assert errs == 0 and m == 3000


@pytest.mark.cuda
def test_fused_stream_step_never_synchronises(cuda):
    (xr, xi), _ = _qpsk_capture(2 * TQS.IN_PER_STEP, seed=5)
    cfg = trx.QpskRxConfig()
    step = tstream.make_stream_fused_fn(cfg)
    st = tstream.init_state_fast(cfg, cuda)
    B = TQS.IN_PER_STEP
    blocks = [(torch.from_numpy(xr[b * B:(b + 1) * B]).to(cuda),
               torch.from_numpy(xi[b * B:(b + 1) * B]).to(cuda))
              for b in range(2)]
    _, st = step(st, *blocks[0])               # fills the constant caches
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for re, im in blocks:
            y, st = step(st, re, im)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert y.shape == (2, B // 4) and bool(torch.isfinite(y).all())
