"""The port's BPSK and QPSK transmitters against the JAX package's: both
block paths over chained blocks, a float64 oracle of the reference chain
fed with the bits the port's PRNG drew, a state handed over from JAX,
``run_to_file``, the port's own raw_iq and snr, and a loopback through
the port's QPSK receiver.

Bounds: i16 output within 1 LSB of the JAX block and of the float64
oracle, with under 1% of samples differing (the JAX tests' bounds,
tests/test_models.py:55-57); the file against the oracle > 60 dB
(tests/test_aux.py:185-204); the loopback zero bit errors."""

import numpy as np
import pytest
import jax
import torch

from comms_tpu.io import raw_iq as jraw
from comms_tpu.models import bpsk_tx as jb
from comms_tpu.models import qpsk_tx as jq
from comms_tpu.ops import txshape as jtx
from comms_tpu.util import snr as jsnr
from comms_tpu_torch.io import raw_iq as traw
from comms_tpu_torch.models import bpsk_tx as tb
from comms_tpu_torch.models import qpsk_rx as trx
from comms_tpu_torch.models import qpsk_tx as tq
from comms_tpu_torch.ops import random as trand
from comms_tpu_torch.ops import txshape as ttx
from comms_tpu_torch.util import snr as tsnr
from tests._tx_oracle import lsb_diff, tx_oracle_f64 as oracle

CPU = "cpu"
DPHASE, PHASE0 = 0.777, 0.3


def _models(kind, n, mixed=True):
    """(JAX module, port module, JAX cfg, port cfg) at ``n`` symbols
    (BPSK) or bits (QPSK)."""
    if kind == "bpsk":
        return jb, tb, jb.BpskTxConfig(syms_per_block=n), \
            tb.BpskTxConfig(syms_per_block=n)
    kw = dict(dphase=DPHASE, phase0=PHASE0) if mixed else {}
    return jq, tq, jq.QpskTxConfig(bits_per_block=n, **kw), \
        tq.QpskTxConfig(bits_per_block=n, **kw)


def _fns(mod, cfg, fast):
    if fast:
        return mod.make_block_fn_fast(cfg), mod.init_state_fast
    return mod.make_block_fn(cfg), mod.init_state


def _pairs(out, fast):
    if isinstance(out, torch.Tensor):
        return ttx.unpack_iq(out) if fast else out.numpy()
    return jtx.unpack_iq(out) if fast else np.asarray(out)


def _bits_drawn(cfg, seed, fast, blocks):
    """The bits the port's PRNG drew for ``blocks`` blocks from ``seed``
    (float64 numpy)."""
    n = getattr(cfg, "syms_per_block", None) or cfg.bits_per_block
    draw = (trand.random_bits_packed_block if fast
            else trand.random_bits_block)
    key = trand.source_init(seed, CPU)
    out = []
    for _ in range(blocks):
        b, key = draw(key, n)
        out.append(b.numpy().astype(np.float64))
    return np.concatenate(out)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("kind,n,mixed", [("bpsk", 512, False),
                                          ("qpsk", 1024, False),
                                          ("qpsk", 2048, True)])
def test_blocks_match_jax_over_chained_blocks(kind, n, mixed, fast):
    jmod, tmod, jcfg, tcfg = _models(kind, n, mixed)
    jfn, jinit = _fns(jmod, jcfg, fast)
    tfn, tinit = _fns(tmod, tcfg, fast)
    jfn = jax.jit(jfn)
    js, ts = jinit(jcfg, 5), tinit(tcfg, 5, CPU)
    for _ in range(4):
        jo, js = jfn(js)
        to, ts = tfn(ts)
        got, want = _pairs(to, fast), _pairs(jo, fast)
        assert got.shape == want.shape == (tcfg.samples_per_block, 2)
        mx, frac = lsb_diff(got, want)
        assert mx <= 1 and frac < 0.01
    assert np.array_equal(np.asarray(js[0]).astype(np.int64),
                          ts[0].numpy())
    if kind == "qpsk":
        assert ts[2] == tuple(int(w) for w in js[2])


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("kind,n,mixed", [("bpsk", 512, False),
                                          ("qpsk", 1024, False),
                                          ("qpsk", 2048, True)])
def test_blocks_match_float64_oracle(kind, n, mixed, fast):
    _, tmod, _, cfg = _models(kind, n, mixed)
    fn, init = _fns(tmod, cfg, fast)
    st = init(cfg, 7, CPU)
    got = []
    for _ in range(3):
        out, st = fn(st)
        got.append(_pairs(out, fast))
    bits = _bits_drawn(cfg, 7, fast, 3)
    want = oracle(bits, kind == "qpsk", DPHASE if mixed else 0.0, PHASE0)
    mx, frac = lsb_diff(np.concatenate(got), want)
    assert mx <= 1 and frac < 0.01


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_state_from_jax_continues_the_jax_stream(kind, fast):
    jmod, tmod, jcfg, tcfg = _models(kind, 1024)
    jfn, jinit = _fns(jmod, jcfg, fast)
    tfn, _ = _fns(tmod, tcfg, fast)
    jfn = jax.jit(jfn)
    js = jinit(jcfg, 13)
    for _ in range(2):
        _, js = jfn(js)
    as_numpy = jax.tree_util.tree_map(np.asarray, js)
    convert = tmod.fast_state_from_jax if fast else tmod.state_from_jax
    ts = convert(as_numpy, device=CPU)
    for _ in range(2):
        jo, js = jfn(js)
        to, ts = tfn(ts)
        mx, frac = lsb_diff(_pairs(to, fast), _pairs(jo, fast))
        assert mx <= 1 and frac < 0.01
    assert np.array_equal(np.asarray(js[0]).astype(np.int64),
                          ts[0].numpy())
    np.testing.assert_allclose(ts[1].numpy(), np.asarray(js[1]), atol=1e-6)


@pytest.mark.parametrize("fast", [False, True])
@pytest.mark.parametrize("kind", ["bpsk", "qpsk"])
def test_run_to_file_matches_jax_file(kind, fast, tmp_path):
    jmod, tmod, jcfg, tcfg = _models(kind, 256)
    pj, pt = tmp_path / "jax.bin", tmp_path / "port.bin"
    nj = jmod.run_to_file(pj, 3, jcfg, seed=2, fast=fast)
    nt = tmod.run_to_file(pt, 3, tcfg, seed=2, fast=fast, device=CPU)
    assert nt == nj == 3 * tcfg.samples_per_block
    got = np.fromfile(pt, dtype="<i2").reshape(-1, 2)
    want = np.fromfile(pj, dtype="<i2").reshape(-1, 2)
    mx, frac = lsb_diff(got, want)
    assert got.shape == (nt, 2) and mx <= 1 and frac < 0.01
    # the file is the blocks' bytes
    fn, init = _fns(tmod, tcfg, fast)
    st = init(tcfg, 2, CPU)
    blocks = []
    for _ in range(3):
        out, st = fn(st)
        blocks.append(_pairs(out, fast))
    np.testing.assert_array_equal(got, np.concatenate(blocks))


@pytest.mark.parametrize("fast", [False, True])
def test_file_against_float64_oracle_over_60db(fast, tmp_path):
    cfg = tb.BpskTxConfig(syms_per_block=512)
    p, q = tmp_path / "dev.bin", tmp_path / "oracle.bin"
    tb.run_to_file(p, 1, cfg, seed=7, fast=fast, device=CPU)
    oracle(_bits_drawn(cfg, 7, fast, 1), qpsk=False).astype("<i2").tofile(q)
    rep = tsnr.compare_iq_files(p, q, max_lag=8)
    assert rep["snr_db"] > 60 and rep["samples"] == cfg.samples_per_block
    assert rep == jsnr.compare_iq_files(p, q, max_lag=8)


def test_raw_iq_equals_jax(tmp_path):
    rng = np.random.default_rng(3)
    x = (rng.normal(size=1000) + 1j * rng.normal(size=1000)) * 3000
    np.testing.assert_array_equal(traw.float_to_iq_i16(x, 2.0),
                                  jraw.float_to_iq_i16(x, 2.0))
    raw = traw.float_to_iq_i16(x)
    np.testing.assert_array_equal(traw.iq_i16_to_float(raw, 0.5),
                                  jraw.iq_i16_to_float(raw, 0.5))
    p = tmp_path / "a.iq"
    assert traw.write_iq(p, x) == 1000
    np.testing.assert_array_equal(traw.read_iq(p), jraw.read_iq(p))
    np.testing.assert_array_equal(traw.read_iq(p, 10), jraw.read_iq(p, 10))
    np.testing.assert_array_equal(traw.read_iq(raw.tobytes()),
                                  jraw.read_iq(raw.tobytes()))
    for tail in ("drop", "pad", "short"):
        got = list(traw.iter_iq_blocks(p, 300, tail=tail, scale=0.25))
        want = list(jraw.iter_iq_blocks(p, 300, tail=tail, scale=0.25))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
    with pytest.raises(ValueError):
        list(traw.iter_iq_blocks(p, 300, tail="bad"))
    q = tmp_path / "b.iq"
    with traw.IQWriter(q) as w:
        assert w.write(x[:600]) == 600
        w.write(x[600:])
    assert q.read_bytes() == p.read_bytes()


def test_snr_equals_jax():
    rng = np.random.default_rng(4)
    ref = rng.normal(size=4000) + 1j * rng.normal(size=4000)
    delayed = np.concatenate([np.zeros(7), ref[:-7]]) * (0.5 - 0.2j)
    noisy = ref + 0.01 * (rng.normal(size=4000) + 1j * rng.normal(size=4000))
    assert tsnr.snr_db(ref, ref) == float("inf") == jsnr.snr_db(ref, ref)
    assert tsnr.snr_db(ref, delayed, 16) == jsnr.snr_db(ref, delayed, 16)
    assert tsnr.snr_db(ref, noisy, 4) == jsnr.snr_db(ref, noisy, 4)
    assert tsnr.evm_percent(ref, noisy, 4) == jsnr.evm_percent(ref, noisy, 4)
    assert 38 < tsnr.snr_db(ref, noisy, 4) < 42


def _loopback(fast, dphase, phase0, noise):
    """Port QPSK tx (4096 bits) -> /scale (+ noise) -> port receiver.
    Returns (bit errors over the compared symbols, compared symbols)."""
    cfg = tq.QpskTxConfig(bits_per_block=4096, dphase=dphase, phase0=phase0)
    fn, init = _fns(tq, cfg, fast)
    out, _ = fn(init(cfg, 1, CPU))
    iq = torch.from_numpy(_pairs(out, fast).astype(np.float32)) / cfg.scale
    if noise:
        g = torch.Generator().manual_seed(0)
        iq = iq + noise * torch.randn(iq.shape, generator=g)
    sym, diag = trx.make_rx_fn_planar(trx.QpskRxConfig())(
        iq[:, 0].contiguous(), iq[:, 1].contiguous())
    bits = _bits_drawn(cfg, 1, fast, 1).astype(np.int8)
    (_, lag), errs, m = trx.resolve_ambiguity(sym, bits, search=1500)
    return errs, m, lag, diag


@pytest.mark.parametrize("fast", [False, True])
def test_loopback_through_port_receiver_zero_ber(fast):
    errs, m, lag, _ = _loopback(fast, 0.0, 0.0, 0.0)
    assert m == 3000 and errs == 0
    assert lag == 8  # tx + rx RRC group delay


@pytest.mark.parametrize("fast", [False, True])
def test_loopback_with_carrier_offset_and_noise_zero_ber(fast):
    errs, m, _, diag = _loopback(fast, 0.01, 0.6, 0.02)
    assert m == 3000 and errs == 0
    assert abs(float(diag["freq"]) - 0.01) < 0.01
