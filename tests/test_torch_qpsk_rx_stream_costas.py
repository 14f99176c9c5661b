"""The port's Costas-loop stream receiver (``make_stream_fn``) against the
JAX package's: block by block at 1024-sample blocks (symbols and every
state leaf), a stream continued from a JAX state
(``stream_state_from_jax``), and mirrors of tests/test_qpsk_rx_stream.py's
Costas tests on the port: zero bit errors after 3 acquisition blocks over
34 blocks with a carrier-frequency step, driven through StreamRunner; the
same decisions at two block sizes; a finite output at sps 8.

Tolerances (measured on the CPU over 8 blocks of three channels, then
about 5x): the two packages' float32 sin/cos/atan2 and their complex
products differ by ulps.  The coarse carrier ``omega`` then differs by
up to 4e-8 rad/sample, the carried mixer phase ``theta`` (omega * N a
block) drifts apart by ~1e-5 a block (8e-5 after 8 blocks), and the
Costas loop takes up the same difference in its phase (8e-5), so the
symbols stay within 3.7e-5 of JAX; the matched filter's and the
interpolator's carried samples, turned by theta, within 1.4e-4.
TOL_SYM = 2e-4 on the symbols, TOL_STATE = 1e-3 on every state leaf."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.models import qpsk_rx_stream as jstream
from comms_tpu.ops import taps as jtaps
from comms_tpu_torch.models import qpsk_rx as trx
from comms_tpu_torch.models import qpsk_rx_stream as tstream
from comms_tpu_torch.runtime import StreamRunner

SPS, T, BETA = 4, 32, 0.25
TOL_SYM = 2e-4
TOL_STATE = 1e-3


def _tx(bits: np.ndarray) -> np.ndarray:
    """qpsk_tx waveform: consecutive bit pairs -> RRC-shaped samples."""
    rrc = np.asarray(jtaps.rrc_taps(T, float(SPS), BETA))
    rrc = rrc / np.sqrt(np.sum(np.abs(rrc) ** 2))
    pairs = bits.reshape(-1, 2)
    sym = ((2.0 * pairs[:, 0] - 1) + 1j * (2.0 * pairs[:, 1] - 1)
           ).astype(np.complex64)
    up = np.zeros(len(sym) * SPS, np.complex64)
    up[::SPS] = sym
    return np.convolve(up, rrc.astype(np.complex64))[: len(up)]


def _frac_delay(x: np.ndarray, d: float) -> np.ndarray:
    n = len(x)
    X = np.fft.fft(np.concatenate([x, np.zeros(256, x.dtype)]))
    k = np.fft.fftfreq(len(X))
    return np.fft.ifft(X * np.exp(-2j * np.pi * k * d))[:n].astype(
        np.complex64)


def _channel(n_sym, seed, delay=1.7, w=(0.01, 0.01), step_at=None,
             phase=0.9):
    rng = np.random.default_rng(seed)
    bits = rng.integers(0, 2, size=2 * n_sym).astype(np.uint8)
    s = _tx(bits)
    n = np.arange(len(s))
    dph = w[0] if step_at is None else np.where(n < step_at, w[0], w[1])
    ph = phase + np.cumsum(np.broadcast_to(dph, n.shape))
    return bits, _frac_delay(s, delay) * np.exp(1j * ph).astype(np.complex64)


def _pairs(r, block, b):
    seg = r[b * block:(b + 1) * block]
    return np.stack([seg.real, seg.imag], axis=-1).astype(np.float32)


def _leaves(st):
    out = {}
    for k, v in st.items():
        if k == "costas":
            out["costas_phase"], out["costas_freq"] = v
        else:
            out[k] = v
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else np.asarray(v))
            for k, v in out.items()}


def _assert_state_close(st_t, st_j, msg):
    t, j = _leaves(st_t), _leaves(st_j)
    assert set(t) == set(j)
    for k in j:
        assert t[k].shape == j[k].shape and t[k].dtype == np.float32, k
        np.testing.assert_allclose(t[k], j[k], atol=TOL_STATE, rtol=0,
                                   err_msg=f"state {k} ({msg})")


def test_make_stream_fn_matches_jax_block_by_block():
    B = 1024
    _, r = _channel(8 * B // SPS + 64, 11)
    jcfg = jstream.QpskRxStreamConfig(block=B)
    tcfg = tstream.QpskRxStreamConfig(block=B)
    jstep, tstep = jstream.make_stream_fn(jcfg), tstream.make_stream_fn(tcfg)
    st_j, st_t = jstream.init_state(jcfg), tstream.init_state(tcfg, "cpu")
    _assert_state_close(st_t, st_j, "init")
    for b in range(8):
        x = _pairs(r, B, b)
        y_j, st_j = jstep(st_j, jnp.asarray(x))
        y_t, st_t = tstep(st_t, torch.from_numpy(x))
        assert y_t.shape == (B // SPS, 2) and y_t.dtype == torch.float32
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                                   atol=TOL_SYM, rtol=0, err_msg=f"block {b}")
        _assert_state_close(st_t, st_j, f"block {b}")


def test_stream_state_from_jax_continues_a_jax_stream():
    B = 1024
    _, r = _channel(4 * B // SPS + 64, 3, w=(0.004, 0.004))
    jcfg = jstream.QpskRxStreamConfig(block=B)
    tcfg = tstream.QpskRxStreamConfig(block=B)
    jstep = jstream.make_stream_fn(jcfg)
    st_j = jstream.init_state(jcfg)
    for b in range(2):
        _, st_j = jstep(st_j, jnp.asarray(_pairs(r, B, b)))
    st_t = tstream.stream_state_from_jax(
        {k: (tuple(np.asarray(a) for a in v) if k == "costas"
             else np.asarray(v)) for k, v in st_j.items()}, device="cpu")
    tstep = tstream.make_stream_fn(tcfg)
    for b in range(2, 4):
        x = _pairs(r, B, b)
        y_j, st_j = jstep(st_j, jnp.asarray(x))
        y_t, st_t = tstep(st_t, torch.from_numpy(x))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                                   atol=TOL_SYM, rtol=0)
        _assert_state_close(st_t, st_j, f"block {b}")


def _best_align(sym: np.ndarray, bits: np.ndarray, start_sym: int,
                max_lag: int = 24):
    """Best (errors, compared, rot, lag) over rotations x symbol lags,
    compared over the full overlap."""
    best = None
    for rot in range(4):
        cand = trx.decide_bits(sym * np.exp(1j * np.pi / 2 * rot))
        for lag in range(-max_lag, max_lag + 1):
            ref_start = 2 * (start_sym + lag)
            if ref_start < 0:
                continue
            ref = bits[ref_start:]
            m = min(len(cand), len(ref))
            errs = int(np.sum(cand[:m] != ref[:m]))
            if best is None or errs < best[0]:
                best = (errs, m, rot, lag)
    return best


def test_streaming_rx_zero_ber_with_freq_step():
    cfg = tstream.QpskRxStreamConfig(block=8192)
    n_blocks = 34
    M = cfg.syms_per_block
    bits, r = _channel(n_blocks * M + 64, 11, w=(0.01, 0.012),
                       step_at=17 * cfg.block)
    blocks = [_pairs(r, cfg.block, b) for b in range(n_blocks)]
    out = []
    runner = StreamRunner(tstream.make_stream_fn(cfg),
                          tstream.init_state(cfg, "cpu"), iter(blocks),
                          sink=out.append, device="cpu")
    runner.run()
    assert len(out) == n_blocks
    # 3 acquisition blocks; everything after is perfect, the frequency
    # step at block 17 included
    skip = 3
    sym = np.concatenate(out[skip:])
    sym = sym[:, 0] + 1j * sym[:, 1]
    errs, compared, rot, lag = _best_align(sym, bits, skip * M)
    assert compared > 60000, compared
    assert errs == 0, (errs, compared, rot, lag)


def test_streaming_rx_block_size_invariance():
    n_sym = 16 * 1024 + 64
    rng = np.random.default_rng(5)
    bits = rng.integers(0, 2, size=2 * n_sym).astype(np.uint8)
    r = _frac_delay(_tx(bits), 0.6) * np.exp(
        1j * (0.4 + 0.005 * np.arange(n_sym * SPS))).astype(np.complex64)

    def run(block):
        cfg = tstream.QpskRxStreamConfig(block=block)
        step = tstream.make_stream_fn(cfg)
        st = tstream.init_state(cfg, "cpu")
        outs = []
        for b in range(len(r) // block):
            y, st = step(st, torch.from_numpy(_pairs(r, block, b)))
            outs.append(y.numpy())
        sym = np.concatenate(outs)
        return sym[:, 0] + 1j * sym[:, 1]

    a, b = run(4096), run(8192)
    m = min(len(a), len(b))
    skip = 4096
    assert np.mean(trx.decide_bits(a[skip:m])
                   != trx.decide_bits(b[skip:m])) < 1e-3


def test_streaming_rx_large_sps_context():
    cfg = tstream.QpskRxStreamConfig(block=4096, sps=8)
    assert cfg.L_CTX >= 2 * cfg.sps + 4
    step = tstream.make_stream_fn(cfg)
    st = tstream.init_state(cfg, "cpu")
    rng = np.random.default_rng(7)
    for _ in range(2):
        x = rng.normal(size=(cfg.block, 2)).astype(np.float32)
        y, st = step(st, torch.from_numpy(x))
        assert y.shape == (cfg.syms_per_block, 2)
        assert np.isfinite(y.numpy()).all()


def test_config_and_state_errors():
    with pytest.raises(ValueError, match="multiple of sps"):
        tstream.QpskRxStreamConfig(block=1001)
    cfg = tstream.QpskRxStreamConfig(block=1024)
    st = tstream.init_state(cfg, "cpu")
    assert set(st) == set(jstream.init_state(
        jstream.QpskRxStreamConfig(block=1024)))
    assert isinstance(st["costas"], tuple) and len(st["costas"]) == 2
