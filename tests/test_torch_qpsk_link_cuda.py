"""The QPSK link's stream steps on a CUDA card: the fused stream step
lifted over 3 streams by ``BatchedStreamRunner(mode="vmap")`` (the step
runs once a stream) against ``mode="unroll"``; K5's entries lifted by
``torch.func.vmap`` directly (its custom ops, one launch a stream)
against a call a stream; the split
serving step against the fast step (the JAX test's 1e-5 bound); the
``est_lag=2`` fused step against a CPU run of the same step; the
Costas-loop receiver on the card against its CPU run (its mixer's
cos/sin at arguments up to ~82 rad against the CPU's); K5's and the
Costas kernel's launches a block.

This file imports no jax (the machine with the card has none), so it
runs there on its own, without the repository's conftest:

    python -m pytest --noconftest -m cuda tests/test_torch_qpsk_link_cuda.py

Without a CUDA device the tests skip: the kernels have no CPU mode.
"""

import numpy as np
import pytest
import torch

from comms_tpu_torch.kernels import qpsk_sym as QS
from comms_tpu_torch.kernels import recurrence as R
from comms_tpu_torch.models import qpsk_rx as trx
from comms_tpu_torch.models import qpsk_rx_stream as tqs
from comms_tpu_torch.ops import taps as ttaps
from comms_tpu_torch.runtime import BatchedStreamRunner, StreamRunner

B = QS.IN_PER_STEP
# the split step against the fast one (tests/test_qpsk_rx_stream.py:213)
TOL_SPLIT = 1e-5
# the card against the CPU on the same step: the kernels' symbols and
# panels within 1e-4 of plain (chip_smoke.TOL_SYM), carried one block
TOL_CARD = 2e-3


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


def _waveform(n: int, seed: int, cfo: float, phi: float) -> np.ndarray:
    """qpsk_tx's waveform (RRC sps 4, 32 taps, beta 0.25) of random bits,
    turned by a carrier offset."""
    rng = np.random.default_rng(seed)
    b = rng.integers(0, 2, size=(2, n // 4 + 8))
    up = np.zeros(4 * b.shape[1], np.complex128)
    up[::4] = (2 * b[0] - 1) + 1j * (2 * b[1] - 1)
    h = np.real(ttaps.rrc_taps(32, 4.0, 0.25))
    x = np.convolve(up, h)[:n]
    return (x * np.exp(1j * (cfo * np.arange(n) + phi))).astype(np.complex64)


def _blocks(x, nblk, dev):
    return [(torch.from_numpy(x[k * B:(k + 1) * B].real.copy()).to(dev),
             torch.from_numpy(x[k * B:(k + 1) * B].imag.copy()).to(dev))
            for k in range(nblk)]


@pytest.mark.cuda
def test_vmap_fused_step_equals_unroll(cuda):
    cfg = trx.QpskRxConfig()
    step = tqs.make_stream_fused_fn(cfg)
    xs = [_waveform(2 * B, s, c, p) for s, c, p in
          ((1, 0.006, 0.8), (2, -0.004, 2.1), (3, 0.002, -1.0))]
    rounds = [tuple(torch.stack([_blocks(x, 2, cuda)[k][i] for x in xs])
                    for i in range(2)) for k in range(2)]
    outs = {}
    for mode in ("unroll", "vmap"):
        got = [[] for _ in xs]
        for k in QS.launches:
            QS.launches[k] = 0
        r = BatchedStreamRunner(
            lambda s, x: step(s, *x),
            [tqs.init_state_fast(cfg, cuda) for _ in xs],
            batched_source=rounds, sinks=[g.append for g in got],
            mode=mode, depth=2, device=cuda)
        r.run()
        assert QS.launches["qpsk_symbol_gemm_scalars"] == 2 * len(xs)
        assert QS.launches["qpsk_symbols"] == 2 * len(xs)
        outs[mode] = (got, r.stream_states())
    for b in range(len(xs)):
        for k in range(2):
            np.testing.assert_array_equal(outs["vmap"][0][b][k],
                                          outs["unroll"][0][b][k])
        for key, v in outs["unroll"][1][b].items():
            assert torch.equal(outs["vmap"][1][b][key], v), key


@pytest.mark.cuda
def test_k5_entries_under_vmap(cuda):
    # the symbol kernel's _scalars entry with panels, and the panel entry,
    # vmapped over 2 streams (planes and carrier estimate batched): one
    # launch a stream, each stream's outputs equal to its own call
    cfg = trx.QpskRxConfig()
    planes = [_blocks(_waveform(B, s, c, p), 1, cuda)[0]
              for s, c, p in ((1, 0.006, 0.8), (2, -0.004, 2.1))]
    re = torch.stack([p[0] for p in planes])
    im = torch.stack([p[1] for p in planes])
    w = torch.tensor([0.006, -0.004], device=cuda)
    lag = torch.tensor([0.0, 1.0, 0.0, 0.0], device=cuda)
    shift2 = torch.zeros((), dtype=torch.int32, device=cuda)

    def entry(r, i, w_):
        sr, si, P = QS.qpsk_symbol_gemm_scalars(
            r, i, cfg.mf_taps, w_, lag, shift2, panels_hw=cfg.panel_hw)
        return (sr, si, *P[:4])

    def panels(r, i):
        return QS.qpsk_panels(r, i, cfg.panel_hw)[:4]

    n0 = dict(QS.launches)
    got = torch.func.vmap(entry)(re, im, w)
    got_p = torch.func.vmap(panels)(re, im)
    assert QS.launches["qpsk_symbol_gemm_scalars"] == \
        n0["qpsk_symbol_gemm_scalars"] + 2
    assert QS.launches["qpsk_panels"] == n0["qpsk_panels"] + 2
    for b in range(2):
        for g, want in zip(got, entry(re[b], im[b], w[b])):
            assert torch.equal(g[b], want)
        for g, want in zip(got_p, panels(re[b], im[b])):
            assert torch.equal(g[b], want)


@pytest.mark.cuda
def test_split_serving_step_matches_fast(cuda):
    cfg = trx.QpskRxConfig()
    blocks = _blocks(_waveform(3 * B, 5, 0.006, 0.8), 3, cuda)
    fast = tqs.make_stream_fast_fn(cfg)
    st = tqs.init_state_fast(cfg, cuda)
    want = []
    for re, im in blocks:
        y, st = fast(st, re, im)
        want.append(y.cpu().numpy())
    for k in QS.launches:
        QS.launches[k] = 0
    got = []
    StreamRunner(tqs.make_split_serving_step(cfg),
                 tqs.init_state_fast(cfg, cuda), blocks, sink=got.append,
                 samples_of=lambda x: B, depth=2, device=cuda).run()
    assert QS.launches["qpsk_symbol_gemm_scalars"] == 3
    assert QS.launches["qpsk_panels"] == 3
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, atol=TOL_SPLIT, rtol=TOL_SPLIT)


@pytest.mark.cuda
def test_est_lag2_on_the_card_against_the_cpu(cuda):
    cfg = trx.QpskRxConfig()
    x = _waveform(3 * B, 9, 0.006, 0.8)
    step = tqs.make_stream_fused_fn(cfg, est_lag=2)
    st_c = tqs.init_state_fused2(cfg, cuda)
    st_h = tqs.init_state_fused2(cfg, "cpu")
    for k in QS.launches:
        QS.launches[k] = 0
    for (rc, ic), (rh, ih) in zip(_blocks(x, 3, cuda), _blocks(x, 3, "cpu")):
        yc, st_c = step(st_c, rc, ic)
        yh, st_h = step(st_h, rh, ih)
        np.testing.assert_allclose(yc.cpu().numpy(), yh.numpy(),
                                   atol=TOL_CARD, rtol=TOL_CARD)
    assert QS.launches["qpsk_symbol_gemm_scalars"] == 3
    assert set(st_c) == set(tqs.init_state_fused2(cfg, "cpu"))


@pytest.mark.cuda
def test_mixer_argument_far_from_zero(cuda):
    # the Costas receiver's mixer turns a block by theta + omega * k, ~82
    # rad at k = 8191 and omega = 0.01: the card's cos/sin there against
    # the CPU's (both accurate float32: within 2 ulp of values <= 1)
    k = torch.arange(8192, dtype=torch.float32)
    a = 0.3 + 0.01 * k
    for f in (torch.cos, torch.sin):
        assert float((f(a.to(cuda)).cpu() - f(a)).abs().max()) <= 2.4e-7


@pytest.mark.cuda
def test_costas_receiver_on_the_card_against_the_cpu(cuda):
    cfg = tqs.QpskRxStreamConfig(block=8192)
    n = 4 * cfg.block
    x = _waveform(n, 11, 0.01, 0.9)
    pairs = np.stack([x.real, x.imag], -1).astype(np.float32)
    step = tqs.make_stream_fn(cfg)
    st_c, st_h = tqs.init_state(cfg, cuda), tqs.init_state(cfg, "cpu")
    n0 = R.launches["costas_loop"]
    dec_c, dec_h = [], []
    for k in range(4):
        blk = torch.from_numpy(pairs[k * cfg.block:(k + 1) * cfg.block])
        yc, st_c = step(st_c, blk.to(cuda))
        yh, st_h = step(st_h, blk)
        assert yc.shape == (cfg.syms_per_block, 2)
        dec_c.append(yc.cpu().numpy() > 0)
        dec_h.append(yh.numpy() > 0)
    assert R.launches["costas_loop"] == n0 + 4
    # after acquisition (two blocks) the decisions agree
    assert np.array_equal(np.concatenate(dec_c[2:]), np.concatenate(dec_h[2:]))
