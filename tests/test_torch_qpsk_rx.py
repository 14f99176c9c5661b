"""The port's one-shot QPSK receiver against the JAX package's: zero-BER
loopbacks at the JAX tests' assertions, the planar and pairs entries,
fused against staged core, each core against its JAX twin, the symbol
kernel's route against the tensor route, and the sps = 2 route.  The
waveforms come from the JAX package's qpsk_tx (numpy arrays to both
sides)."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comms_tpu.models import qpsk_rx as jrx
from comms_tpu.models import qpsk_tx
from comms_tpu.ops import interp
from comms_tpu.ops import random as crandom
from comms_tpu_torch.models import qpsk_rx as trx


def _tx(seed=1, nbits=4096):
    cfg = qpsk_tx.QpskTxConfig(bits_per_block=nbits, dphase=0.0)
    iq, _ = qpsk_tx.make_block_fn(cfg)(qpsk_tx.init_state(cfg, seed))
    z = np.asarray(iq).astype(np.float32) / cfg.scale
    x = (z[:, 0] + 1j * z[:, 1]).astype(np.complex64)
    bits, _ = crandom.random_bits_block(crandom.source_init(seed), nbits)
    return x, np.asarray(bits)


def _impaired(x, cfo, phase, delay, noise):
    n = np.arange(len(x))
    xc = (x * np.exp(1j * (cfo * n + phase))).astype(np.complex64)
    if delay:
        xc = np.asarray(interp.delay_signal(jnp.asarray(xc), delay))
    if noise:
        rng = np.random.default_rng(0)
        xc = (xc + noise * (rng.normal(size=len(xc))
                            + 1j * rng.normal(size=len(xc)))
              ).astype(np.complex64)
    return xc


def _planes(xc):
    return (torch.from_numpy(np.ascontiguousarray(xc.real, np.float32)),
            torch.from_numpy(np.ascontiguousarray(xc.imag, np.float32)))


def _rx_ber(x, bits, cfg=None):
    rx = trx.make_rx_fn(cfg if cfg is not None else trx.QpskRxConfig())
    pairs = np.stack([x.real, x.imag], -1).astype(np.float32)
    sym, diag = rx(torch.from_numpy(pairs))
    return trx.resolve_ambiguity(sym, bits, search=1500), diag


def test_loopback_clean_zero_ber():
    x, bits = _tx()
    ((rot, lag), errs, m), _ = _rx_ber(x, bits)
    assert m == 3000 and errs == 0
    assert lag == 8  # tx+rx RRC group delay


def test_loopback_fractional_delay():
    x, bits = _tx()
    (_, errs0, _), diag0 = _rx_ber(x, bits)
    (_, errs, _), diag = _rx_ber(_impaired(x, 0.0, 0.0, 2.3, 0.0), bits)
    assert errs0 == 0 and errs == 0
    delta = float(diag["timing"]) - float(diag0["timing"])
    assert abs((delta - 2.3 + 2) % 4 - 2) < 0.15


def test_loopback_full_impairment_zero_ber():
    x, bits = _tx()
    (_, errs, _), diag = _rx_ber(_impaired(x, 0.01, 0.6, 2.3, 0.02), bits)
    assert errs == 0
    assert abs(float(diag["freq"]) - 0.01) < 0.01  # reference tolerance


def test_planar_entry_bit_equal_to_pairs_entry():
    x, _ = _tx()
    xc = _impaired(x, 0.004, 0.3, 0.0, 0.0)
    cfg = trx.QpskRxConfig()
    pairs = np.stack([xc.real, xc.imag], -1).astype(np.float32)
    sym_p, diag_p = trx.make_rx_fn(cfg)(torch.from_numpy(pairs))
    sym_q, diag_q = trx.make_rx_fn_planar(cfg)(*_planes(xc))
    assert torch.equal(sym_p, sym_q)
    for k in diag_p:
        assert torch.equal(diag_p[k], diag_q[k])


def test_fused_core_matches_staged_core():
    x, bits = _tx()
    xc = _impaired(x, 0.008, 0.4, 1.7, 0.0)
    cfg = trx.QpskRxConfig()
    sym_f, diag_f = trx._rx_core_fused(cfg, *_planes(xc))
    sym_s, diag_s = trx._rx_core_staged(cfg, *_planes(xc))
    # the folds are exact up to O((ND + T)/N) block-edge terms
    assert abs(float(diag_f["freq"]) - float(diag_s["freq"])) < 2e-3
    assert abs(float(diag_f["timing"]) - float(diag_s["timing"])) < 1e-2
    assert int(diag_f["sym_phase"]) == int(diag_s["sym_phase"])
    assert trx.resolve_ambiguity(sym_f, bits, search=1500)[1] == 0
    assert trx.resolve_ambiguity(sym_s, bits, search=1500)[1] == 0


@pytest.mark.parametrize("core", ["_rx_core_fused", "_rx_core_staged"])
def test_cores_match_jax(core):
    x, _ = _tx()
    xc = _impaired(x, 0.01, 0.6, 2.3, 0.02)
    jcfg = jrx.QpskRxConfig()
    sj, dj = jax.jit(lambda a, b: getattr(jrx, core)(jcfg, a, b))(
        jnp.asarray(xc.real), jnp.asarray(xc.imag))
    sp, dp = getattr(trx, core)(trx.QpskRxConfig(), *_planes(xc))
    assert abs(float(dp["freq"]) - float(dj["freq"])) < 1e-4
    assert abs(float(dp["timing"]) - float(dj["timing"])) < 1e-4
    assert int(dp["sym_phase"]) == int(dj["sym_phase"])
    sj = np.asarray(sj)
    assert sp.shape == sj.shape
    assert np.max(np.abs(sp.numpy() - sj)) < 1e-3 * np.max(np.abs(sj))


@pytest.mark.parametrize("shift2", [-4, 0, 3])
def test_symbol_kernel_route_matches_tensor_route(shift2):
    """_fused_symbol_gemm through the symbol kernel's entry (its plain
    version here) against the tensor route with its head patch, from a
    zero and from a carried context."""
    from comms_tpu_torch.kernels import qpsk_sym as TQS

    rng = np.random.default_rng(5)
    N = TQS.IN_PER_STEP
    re = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    im = torch.from_numpy(rng.normal(size=N).astype(np.float32))
    cfg_k = trx.QpskRxConfig(use_kernel=True)
    cfg_t = trx.QpskRxConfig(use_kernel=False)
    w = torch.tensor(0.011)
    lag = torch.tensor([-0.05, 0.7, 0.4, -0.06])
    s2 = torch.tensor(shift2, dtype=torch.int32)
    for ctx in (None, tuple(torch.from_numpy(rng.normal(size=43).astype(
            np.float32)) for _ in range(2))):
        a = trx._fused_symbol_gemm(cfg_k, re, im, w, lag, s2, ctx=ctx,
                                   phase0=0.31)
        b = trx._fused_symbol_gemm(cfg_t, re, im, w, lag, s2, ctx=ctx,
                                   phase0=0.31)
        scale = float(b[0].abs().max())
        for g, t in zip(a, b):
            assert float((g - t).abs().max()) < 1e-3 * scale


def test_phase_slope_of_segments():
    """The slope refinement's fit: None below two segments, else the
    residual slope of the symbols' phase (4th-power phase / 4)."""
    S = trx.SLOPE_SEGMENT
    rng = np.random.default_rng(3)
    a = (2.0 * rng.integers(0, 2, size=3 * S) - 1
         + 1j * (2.0 * rng.integers(0, 2, size=3 * S) - 1))
    s = a * np.exp(1j * (0.2 + 2e-6 * np.arange(3 * S)))
    q4 = torch.from_numpy((s ** 4).astype(np.complex64))
    dw = trx._phase_slope(q4.real, q4.imag)
    assert abs(float(dw) - 2e-6) < 1e-9
    assert trx._phase_slope(q4.real[:2 * S - 1], q4.imag[:2 * S - 1]) is None


def test_long_block_carrier_is_refined():
    """A block of four slope segments (1,048,576 samples, RRC sps 4, CFO
    0.01, delay 2.3, noise 0.02): the coarse and fine carrier together
    land within 2e-8 rad/symbol of the true 0.04, and every symbol is
    decided right, where the lag-1 fine estimate alone is off by ~1e-7
    rad/symbol (its drift grows with the block)."""
    from comms_tpu_torch.ops import taps as ttaps

    n = 4 * 4 * trx.SLOPE_SEGMENT
    rng = np.random.default_rng(11)
    bits = rng.integers(0, 2, size=n // 2).astype(np.uint8)
    up = np.zeros(n, np.complex128)
    up[::4] = (2.0 * bits[0::2] - 1) + 1j * (2.0 * bits[1::2] - 1)
    h = np.zeros(n)
    h[:32] = np.real(ttaps.rrc_taps(32, 4.0, 0.25))
    k = np.fft.fftfreq(n)
    x = np.fft.ifft(np.fft.fft(up) * np.fft.fft(h)
                    * np.exp(-2j * np.pi * 2.3 * k))
    x = x * np.exp(1j * (0.01 * np.arange(n) + 0.6))
    x = x + 0.02 * (rng.normal(size=n) + 1j * rng.normal(size=n))
    sym, diag = trx.make_rx_fn_planar(trx.QpskRxConfig())(
        *_planes(x.astype(np.complex64)))
    total = 4 * float(diag["freq"]) + float(diag["freq_fine"])
    assert abs(total - 0.04) < 2e-8
    (rot, lag), errs, _ = trx.resolve_ambiguity(sym, bits, search=1500)
    s = trx._as_complex(sym) * np.exp(1j * np.pi / 2 * rot)
    got = trx.decide_bits(s[lag + 16:n // 4 - 16])
    ref = bits[2 * 16:2 * 16 + got.shape[0]]
    assert errs == 0 and np.array_equal(got, ref)


def test_use_kernel_true_with_unmet_constraints_raises():
    x, _ = _tx()
    cfg = trx.QpskRxConfig(use_kernel=True)
    with pytest.raises(ValueError, match="outside kernel bounds"):
        trx.make_rx_fn_planar(cfg)(*_planes(x))


def test_sps2_takes_the_general_phase_branch(monkeypatch):
    """At sps = 2 the staged core sums the interpolated energies (the
    JAX package's panel branch indexes lags outside its 3-lag array) and
    decodes a clean sps-2 loopback."""
    cfg = trx.QpskRxConfig(sps=2)
    rng = np.random.default_rng(9)
    bits = rng.integers(0, 2, size=4096).astype(np.uint8)
    sym = (2.0 * bits[0::2] - 1) + 1j * (2.0 * bits[1::2] - 1)
    up = np.zeros(2 * len(sym), np.complex128)
    up[::2] = sym
    x = np.convolve(up, cfg.mf_taps)[:len(up)].astype(np.complex64)
    calls = []
    real_fir_block = trx.fir.fir_block

    def counting(*a, **kw):
        calls.append(a[1].shape)
        return real_fir_block(*a, **kw)

    monkeypatch.setattr(trx.fir, "fir_block", counting)
    sym_out, diag = trx.make_rx_fn_planar(cfg)(*_planes(x))
    assert calls == [(4 + 128 - 1, 128)]      # the Lagrange band product
    (_, errs, m) = trx.resolve_ambiguity(sym_out, bits, search=1000,
                                         max_lag=40)
    assert errs == 0 and m == 2000
