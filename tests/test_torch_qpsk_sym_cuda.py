"""The QPSK symbol kernel (qpsk_sym_kernel in csrc/qpsk_sym.cu) on a CUDA
card: both symbol entries against the plain versions at 1, 2, 3 and 128
TPU steps, every timing shift's sign, with a carried context and with
zeros; the traced entry at MD = 4, 44, 128 and 132; repeats, other
partitions, unaligned planes and two chained half-blocks (at ws = 0)
bit-equal to one call; the panels returned beside the symbols bit-equal
to the panel entry's; the CPU replay of the plan
(tests/_k5_sym_replay.py); one launch a call; a refused launch raising.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_*_cuda.py

Without a CUDA device the tests skip: the kernel has no CPU mode.
"""

import contextlib

import numpy as np
import pytest
import torch

from _k5_sym_replay import k5_sym_replay
from comms_tpu_torch.kernels import qpsk_sym as TQS
from comms_tpu_torch.models import qpsk_rx as trx

# float32 on both sides, the same angle decomposition: only the
# products' order and contraction differ (chip_smoke.TOL_SYM).
TOL_SYM = 1e-4
STEP = TQS.IN_PER_STEP


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def _planes(seed, n, dev):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return tuple(torch.randn(n, generator=g, device=dev) for _ in range(2))


def _err(got, want):
    g, w = torch.complex(*got), torch.complex(*want)
    return float((g - w).abs().max()) / float(w.abs().max())


def _estimates(dev, shift2):
    w = torch.tensor(0.011, device=dev)
    lag = torch.tensor([-0.05, 0.7, 0.4, -0.06], device=dev)
    return w, lag, torch.tensor(shift2, dtype=torch.int32, device=dev)


@contextlib.contextmanager
def _partition(**consts):
    keep = {k: getattr(TQS, k) for k in consts}
    for k, v in consts.items():
        setattr(TQS, k, v)
    try:
        yield
    finally:
        for k, v in keep.items():
            setattr(TQS, k, v)


@pytest.mark.cuda
@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("shift2", [-4, 0, 4])
@pytest.mark.parametrize("steps", [1, 2, 3, 128])
def test_both_entries_match_plain(cuda, steps, shift2, with_ctx):
    n = steps * STEP
    re, im = _planes(steps + 10 * shift2, n, cuda)
    cfg = trx.QpskRxConfig()
    w, lag, s2 = _estimates(cuda, shift2)
    fr, fi = trx.modulated_taps(cfg, w, lag, s2)
    ctx = _planes(99, fr.shape[0] - 1, cuda) if with_ctx else None
    n0 = dict(TQS.launches)
    sr, si = TQS.qpsk_symbol_gemm(re, im, fr, fi, w * 4, 0.31, ctx)
    kr, ki = TQS.qpsk_symbol_gemm_scalars(re, im, cfg.mf_taps, w, lag, s2,
                                          phase0=0.31, ctx=ctx)
    want = TQS.qpsk_symbol_plain(re, im, fr, fi, w * 4, 0.31, ctx)
    torch.cuda.synchronize()
    assert TQS.launches["qpsk_symbols"] == n0["qpsk_symbols"] + 2
    assert TQS.launches["qpsk_symbol_gemm"] == n0["qpsk_symbol_gemm"] + 1
    assert (TQS.launches["qpsk_symbol_gemm_scalars"]
            == n0["qpsk_symbol_gemm_scalars"] + 1)
    assert sr.shape == ki.shape == (n // 4,)
    assert _err((sr, si), want) < TOL_SYM
    assert _err((kr, ki), want) < TOL_SYM


@pytest.mark.cuda
@pytest.mark.parametrize("with_ctx", [False, True])
@pytest.mark.parametrize("md", [4, 44, 128, 132])
def test_traced_entry_at_every_reach(cuda, md, with_ctx):
    re, im = _planes(md, 2 * STEP, cuda)
    fr, fi = _planes(md + 1, md, cuda)
    ctx = _planes(md + 2, md - 1, cuda) if with_ctx else None
    got = TQS.qpsk_symbol_gemm(re, im, fr, fi, 0.0404, -1.3, ctx)
    want = TQS.qpsk_symbol_plain(re, im, fr, fi, 0.0404, -1.3, ctx)
    torch.cuda.synchronize()
    assert _err(got, want) < TOL_SYM


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 4, 16])
def test_repeats_and_partitions_equal_one_call(cuda, steps):
    n = steps * STEP
    re, im = _planes(7 + steps, n, cuda)
    cfg = trx.QpskRxConfig()
    w, lag, s2 = _estimates(cuda, -1)
    md = trx.fused_gemm_ctx_len(cfg) + 1
    ctx = _planes(8, md - 1, cuda)

    def call(x, c):
        return TQS.qpsk_symbol_gemm_scalars(x[0], x[1], cfg.mf_taps, w, lag,
                                            s2, phase0=0.31, ctx=c)

    one = call((re, im), ctx)
    runs = {"again": call((re, im), ctx)}
    for name, consts in {"three_blocks": {"_RUN_BLOCKS": 3},
                         "one_tile": {"_RUN_BLOCKS": 1 << 30},
                         "threads_64": {"_SYM_THREADS": (64,)},
                         "threads_256": {"_SYM_THREADS": (256,)}}.items():
        with _partition(**consts):
            runs[name] = call((re, im), ctx)
    torch.cuda.synchronize()
    for name, out in runs.items():
        assert all(torch.equal(u, v) for u, v in zip(one, out)), name


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [2, 4, 16])
def test_chained_halves_equal_one_call(cuda, steps):
    # at ws = 0 every symbol is de-rotated by phase0 alone, so the halves'
    # symbols are the one call's, the second from the first's last MD - 1
    # samples.  Tap 0 reads sample 4(s + 1), one past a block at its last
    # symbol (zero there): it is zero here, as in the receiver's taps at
    # every timing shift above -4
    n = steps * STEP
    re, im = _planes(17 + steps, n, cuda)
    fr, fi = _planes(18, 44, cuda)
    fr[0] = fi[0] = 0.0
    ctx = _planes(19, 43, cuda)
    one = TQS.qpsk_symbol_gemm(re, im, fr, fi, 0.0, 0.31, ctx)
    h = n // 2
    a = TQS.qpsk_symbol_gemm(re[:h], im[:h], fr, fi, 0.0, 0.31, ctx)
    b = TQS.qpsk_symbol_gemm(re[h:], im[h:], fr, fi, 0.0, 0.31,
                             (re[h - 43:h], im[h - 43:h]))
    torch.cuda.synchronize()
    assert torch.equal(one[0], torch.cat([a[0], b[0]]))
    assert torch.equal(one[1], torch.cat([a[1], b[1]]))


@pytest.mark.cuda
def test_unaligned_planes_equal_aligned(cuda):
    # planes that start off a 16-byte boundary take the kernel's plain
    # loads instead of cp.async
    re, im = _planes(5, STEP + 1, cuda)
    fr, fi = _planes(6, 44, cuda)
    off = (re[1:], im[1:])
    copy = (off[0].clone(), off[1].clone())
    a = TQS.qpsk_symbol_gemm(*off, fr, fi, 0.02, 0.1)
    b = TQS.qpsk_symbol_gemm(*copy, fr, fi, 0.02, 0.1)
    torch.cuda.synchronize()
    assert off[0].data_ptr() % 16 and not copy[0].data_ptr() % 16
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


@pytest.mark.cuda
@pytest.mark.parametrize("steps", [1, 3])
def test_panels_beside_symbols_equal_the_panel_entry(cuda, steps):
    n = steps * STEP
    re, im = _planes(40 + steps, n, cuda)
    cfg = trx.QpskRxConfig()
    hw = cfg.panel_hw
    w, lag, s2 = _estimates(cuda, 2)
    fr, fi = trx.modulated_taps(cfg, w, lag, s2)
    pan = TQS.qpsk_panels(re, im, hw)
    sr, si, p2 = TQS.qpsk_symbol_gemm(re, im, fr, fi, w * 4, 0.0,
                                      panels_hw=hw)
    kr, ki, p3 = TQS.qpsk_symbol_gemm_scalars(re, im, cfg.mf_taps, w, lag,
                                              s2, panels_hw=hw)
    alone = TQS.qpsk_symbol_gemm(re, im, fr, fi, w * 4, 0.0)
    torch.cuda.synchronize()
    for a, b, c in zip(pan[:4], p2[:4], p3[:4]):
        assert torch.equal(a, b) and torch.equal(a, c)
    assert torch.equal(sr, alone[0]) and torch.equal(si, alone[1])


@pytest.mark.cuda
@pytest.mark.parametrize("with_ctx", [False, True])
def test_kernel_matches_the_replay_of_its_plan(cuda, with_ctx):
    rng = np.random.default_rng(3 + with_ctx)
    xr, xi = rng.normal(size=(2, STEP)).astype(np.float32)
    fr, fi = rng.normal(size=(2, 44)).astype(np.float32)
    ctx = tuple(rng.normal(size=(2, 43)).astype(np.float32)) \
        if with_ctx else None
    want = k5_sym_replay(xr, xi, fr, fi, np.float32(0.044), 0.31, ctx)
    got = TQS.qpsk_symbol_gemm(
        *(torch.from_numpy(a).to(cuda) for a in (xr, xi, fr, fi)), 0.044,
        0.31, tuple(torch.from_numpy(c).to(cuda) for c in ctx)
        if ctx else None)
    assert _err(tuple(g.cpu() for g in got),
                tuple(torch.from_numpy(v) for v in want)) < TOL_SYM


@pytest.mark.cuda
def test_a_refused_launch_raises(cuda):
    re, im = _planes(1, STEP, cuda)
    fr, fi = _planes(2, 44, cuda)
    with _partition(_SYM_THREADS=(512,)):
        with pytest.raises(RuntimeError, match="CUDA error"):
            TQS.qpsk_symbol_gemm(re, im, fr, fi, 0.0, 0.0)
