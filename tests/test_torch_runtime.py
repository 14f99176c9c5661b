"""The port's runtime layer (BlockOps, Pipeline, Graph) against the JAX
package's on the same inputs: the twelve tests of tests/test_runtime.py
(the reference's node tests, src/node/mod.rs:363-1009), each run on both
sides and compared, then every BlockOp over chained blocks, and the FIR
ops' route between K2's kernel and the GEMM.

Bounds: bits, symbols, indices and carried input tails exact; complex128
GEMM paths within 1e-12 (the JAX tests' own bound; the products sum in
other orders); float32 GEMM routes within 1e-6 of the largest output of
JAX's; the kernel route (on the CPU its plain version, in float32) within
TOL_K2 of the largest output, the bound of the port's K2 tests; the
port's ``run`` equal to repeated ``step`` bit for bit."""

from fractions import Fraction

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comms_tpu import runtime as J
from comms_tpu.ops import taps
from comms_tpu_torch import runtime as T
from comms_tpu_torch.runtime import block as TB

CPU = "cpu"
TOL_K2 = 5e-5      # tests/test_torch_decim_fir.py's TOL_SPLIT


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _close(got, want, atol):
    np.testing.assert_allclose(_np(got), _np(want), atol=atol, rtol=0)


# ------------------------------------------- tests/test_runtime.py's twelve

def test_linear_pipeline_bpsk_chain():
    t = taps.rrc_taps(32, 4.0, 0.25).astype(np.complex128)
    jp = J.Pipeline([
        J.PrnSource.make(0xC0, 0x01, 8, 256),
        J.BpskMod(example_convention=True, dtype=jnp.complex128),
        J.PulseShape.make(t, 4),
    ], state_dtype=jnp.complex128)
    tp = T.Pipeline([
        T.PrnSource.make(0xC0, 0x01, 8, 256),
        T.BpskMod(example_convention=True, dtype=torch.complex128),
        T.PulseShape.make(t, 4),
    ], state_dtype=torch.complex128)
    assert tp.check_block_size(256) == 1024 == jp.check_block_size(256)
    jy, js = jp.step(jp.init_state())
    ty, ts = tp.step(tp.init_state(CPU))
    assert ty.shape == (1024,) and ty.dtype == torch.complex128
    _close(ty, jy, 1e-12)
    assert np.array_equal(_np(ts[0]), _np(js[0]))
    assert float(torch.sum(ty.abs() ** 2)) > 0


def test_pipeline_run_scan_matches_python_loop():
    t = taps.rrc_taps(16, 2.0, 0.3).astype(np.complex128)
    tp = T.Pipeline([
        T.PrnSource.make(0xC0, 0x55, 8, 64),
        T.BpskMod(dtype=torch.complex128),
        T.PulseShape.make(t, 2),
    ], state_dtype=torch.complex128)
    jp = J.Pipeline([
        J.PrnSource.make(0xC0, 0x55, 8, 64),
        J.BpskMod(dtype=jnp.complex128),
        J.PulseShape.make(t, 2),
    ], state_dtype=jnp.complex128)
    ys, _ = tp.run(tp.init_state(CPU), num_blocks=5)
    assert ys.shape == (5, 128)
    s = tp.init_state(CPU)
    for b in range(5):
        y, s = tp.step(s)
        assert torch.equal(ys[b], y)          # run == repeated step
    jys, _ = jp.run(jp.init_state(), num_blocks=5)
    _close(ys, jys, 1e-12)
    with pytest.raises(ValueError):
        tp.run(tp.init_state(CPU))


def test_pipeline_block_size_rules():
    tp = T.Pipeline([T.Decimate(dec=3)])
    assert tp.check_block_size(64) == 22
    y, _ = tp.step(tp.init_state(CPU), torch.arange(64.0))
    jp = J.Pipeline([J.Decimate(dec=3)])
    jy, _ = jp.step(jp.init_state(), jnp.arange(64.0))
    assert y.shape == (22,) and np.array_equal(_np(y), _np(jy))
    assert tp.check_block_size(9) == 3

    spipe = T.Pipeline([T.Decimate(dec=3, streaming=True)])
    with pytest.raises(ValueError):
        spipe.check_block_size(64)
    assert spipe.check_block_size(9) == 3

    qpipe = T.Pipeline([T.QpskMod()])
    with pytest.raises(ValueError):
        qpipe.check_block_size(7)


def test_pipeline_fed_blocks_with_state():
    rng = np.random.default_rng(0)
    t = rng.normal(size=9).astype(np.complex128)
    x = (rng.normal(size=256) + 1j * rng.normal(size=256)).astype(
        np.complex128)
    tp = T.Pipeline([T.Fir.make(t)], state_dtype=torch.complex128)
    ys, _ = tp.run(tp.init_state(CPU), _t(x.reshape(4, 64)))
    y_once, _ = tp.step(tp.init_state(CPU), _t(x))
    assert np.allclose(_np(ys).reshape(-1), _np(y_once), atol=1e-12)
    jp = J.Pipeline([J.Fir.make(t)], state_dtype=jnp.complex128)
    jys, _ = jp.run(jp.init_state(), jnp.asarray(x.reshape(4, 64)))
    _close(ys, jys, 1e-12)


def test_graph_fan_out_fan_in():
    def build(M):
        g = M.Graph()
        g.add_input("x")
        g.add_node("double", M.Lambda(lambda v: v * 2), ["x"])
        g.add_node("triple", M.Lambda(lambda v: v * 3), ["x"])
        g.add_node("sum", lambda a, b: a + b, ["double", "triple"])
        g.set_outputs(["sum"])
        return g

    g = build(T)
    (out,), _ = g.compile()(g.init_state(device=CPU),
                             {"x": torch.arange(4.0)})
    jg = build(J)
    (jout,), _ = jg.compile()(jg.init_state(), {"x": jnp.arange(4.0)})
    assert np.allclose(_np(out), np.arange(4.0) * 5)
    assert np.array_equal(_np(out), _np(jout).astype(np.float32))


def test_graph_validate_unconnected():
    g = T.Graph()
    g.add_node("a", T.Lambda(lambda v: v), ["missing"])
    g.set_outputs(["a"])
    with pytest.raises(T.GraphNotConnectedError):
        g.validate()
    g2 = T.Graph()
    g2.add_input("x")
    with pytest.raises(T.GraphNotConnectedError):
        g2.validate()                     # no outputs
    with pytest.raises(ValueError):
        g2.add_input("x")                 # duplicate name


def test_graph_feedback_priming_doubler():
    # The reference feedback test (node/mod.rs:945-1009): step K returns
    # 2^K (their 10th received message, 512, is step 9 here).
    g = T.Graph()
    g.add_node("double", lambda prev: prev * 2, ["double"],
               feedback_from={"double": torch.ones(1)})
    g.set_outputs(["double"])
    jg = J.Graph()
    jg.add_node("double", lambda prev: prev * 2, ["double"],
                feedback_from={"double": jnp.ones((1,), jnp.float32)})
    jg.set_outputs(["double"])
    step, jstep = g.compile(), jg.compile()
    state, jstate = g.init_state(device=CPU), jg.init_state()
    seen, jseen = [], []
    for _ in range(10):
        (out,), state = step(state, {})
        (jout,), jstate = jstep(jstate, {})
        seen.append(float(out[0]))
        jseen.append(float(np.asarray(jout)[0]))
    assert seen == jseen == [2.0 ** k for k in range(1, 11)]
    assert seen[8] == 512.0


def test_graph_stateful_ops_and_rates():
    def build(M):
        g = M.Graph()
        g.add_input("iq")
        g.add_node("mix", M.Mixer(dphase=0.2), ["iq"])
        g.add_node("demod", M.FmDemod(), ["mix"])
        g.set_outputs(["demod"])
        return g

    g, jg = build(T), build(J)
    step, jstep = g.compile(), jg.compile()
    state = g.init_state(dtype=torch.complex128, device=CPU)
    jstate = jg.init_state(dtype=jnp.complex128)
    x = np.ones(64, dtype=np.complex128)
    for _ in range(2):
        (out,), state = step(state, {"iq": _t(x)})
        (jout,), jstate = jstep(jstate, {"iq": jnp.asarray(x)})
        _close(out, jout, 1e-6)
    assert np.allclose(_np(out), 0.2, atol=1e-6)
    assert np.allclose(_np(out)[0], 0.2, atol=1e-6)   # no glitch at 0
    assert state["ops"]["mix"] == tuple(int(w) for w in
                                        jstate["ops"]["mix"])


def test_fir_decimate_blockop_matches_dense():
    rng = np.random.default_rng(7)
    t = rng.normal(size=33).astype(np.complex128)
    x = (rng.normal(size=300) + 1j * rng.normal(size=300)).astype(
        np.complex128)
    op = T.FirDecimate.make(t, 5)
    assert op.rate == Fraction(1, 5)
    state = op.init_state(dtype=torch.complex128, device=CPU)
    y, state = op.apply(state, _t(x[:150]))
    y2, _ = op.apply(state, _t(x[150:]))
    dense = T.Pipeline([T.Fir.make(t), T.Decimate(dec=5, streaming=True)],
                       state_dtype=torch.complex128)
    yref, _ = dense.step(dense.init_state(CPU), _t(x))
    got = np.concatenate([_np(y), _np(y2)])
    assert np.allclose(got, _np(yref), atol=1e-12)
    jop = J.FirDecimate.make(t, 5)
    js = jop.init_state(dtype=jnp.complex128)
    jy, js = jop.apply(js, jnp.asarray(x[:150]))
    _close(y, jy, 1e-12)
    assert np.array_equal(_np(state), _np(js))     # the carried tail


def test_graph_multirate_dag_with_blockops():
    rng = np.random.default_rng(11)
    t = rng.normal(size=9).astype(np.complex128)

    def build(M):
        g = M.Graph()
        g.add_input("iq")
        g.add_node("lpf", M.Fir.make(t), ["iq"])
        g.add_node("dec", M.FirDecimate.make(t, 3), ["iq"])
        g.set_outputs(["lpf", "dec"])
        return g

    g, jg = build(T), build(J)
    x = (rng.normal(size=300) + 1j * rng.normal(size=300)).astype(
        np.complex128)
    (lpf, dec), _ = g.compile()(g.init_state(dtype=torch.complex128,
                                             device=CPU), {"iq": _t(x)})
    (jlpf, jdec), _ = jg.compile()(jg.init_state(dtype=jnp.complex128),
                                   {"iq": jnp.asarray(x)})
    assert lpf.shape == (300,) and dec.shape == (100,)
    _close(lpf, jlpf, 1e-12)
    _close(dec, jdec, 1e-12)
    assert np.allclose(_np(lpf), np.convolve(x, t)[:300], atol=1e-12)


def test_lambda_result_dtype_propagation():
    tp = T.Pipeline([
        T.Lambda(lambda v: torch.complex(v[:, 0], v[:, 1]),
                 result_dtype=torch.complex64),
        T.FmDemod(),
    ], state_dtype=torch.float32)
    state = tp.init_state(CPU)
    assert state[1].dtype == torch.complex64
    x = np.random.default_rng(0).normal(size=(3, 64, 2)).astype(np.float32)
    ys, _ = tp.run(state, _t(x))
    assert ys.shape == (3, 64) and ys.dtype == torch.float32
    jp = J.Pipeline([
        J.Lambda(lambda v: jax.lax.complex(v[:, 0], v[:, 1]),
                 result_dtype=jnp.complex64),
        J.FmDemod(),
    ], state_dtype=jnp.float32)
    jys, _ = jp.run(jp.init_state(), jnp.asarray(x))
    _close(ys, jys, 1e-6)


def test_graph_dtype_propagation_after_demod():
    rng = np.random.default_rng(5)
    t = rng.normal(size=9).astype(np.float32)

    def build(M):
        g = M.Graph()
        g.add_input("iq")
        g.add_node("demod", M.FmDemod(), ["iq"])
        g.add_node("audio", M.Fir.make(t), ["demod"])
        g.set_outputs(["audio"])
        return g

    g, jg = build(T), build(J)
    state = g.init_state(dtype=torch.complex64, device=CPU)
    assert not state["ops"]["audio"].is_complex()
    x = (rng.normal(size=64) + 1j * rng.normal(size=64)).astype(np.complex64)
    (out,), state2 = g.compile()(state, {"iq": _t(x)})
    assert state2["ops"]["audio"].dtype == state["ops"]["audio"].dtype
    (jout,), _ = jg.compile()(jg.init_state(dtype=jnp.complex64),
                              {"iq": jnp.asarray(x)})
    _close(out, jout, 1e-6)


# ------------------------------------------------------ the FIR route

ROUTES = [
    # (stream dtype, block, taps dtype, T, dec, kernel?)
    (torch.complex64, 10000, np.complex64, 63, 5, False),   # JAX's blocks
    (torch.complex64, 25600, np.complex64, 63, 5, True),
    (torch.complex64, 5120, np.float64, 63, 5, True),
    (torch.complex128, 25600, np.complex128, 63, 5, False),
    (torch.float32, 5120, np.float32, 63, 5, True),
    (torch.float32, 5120, np.float64, 63, 5, False),        # -> float64
    (torch.float32, 5120, np.complex64, 63, 5, True),
    (torch.complex64, 5120, np.float32, 641, 5, False),     # > dec*128
    (torch.complex64, 5120, np.float32, 640, 5, True),
    (torch.complex64, 4096, np.float32, 32, 4, True),
    (torch.complex64, 4000, np.float32, 32, 4, False),
    (torch.complex64, 2048, np.complex64, 257, 1, True),
    (torch.complex64, 2048, np.float32, 1026, 1, False),    # > 1025
    (torch.complex64, 2000, np.float32, 32, 1, False),
    (torch.complex64, 2048, np.float32, 1, 1, False),       # a scale
]


@pytest.mark.parametrize("case", ROUTES, ids=lambda c: "-".join(map(str, c)))
def test_fir_route_pinned(case):
    dt, n, tdt, T_, dec, kernel = case
    assert TB.takes_kernel(dt, n, np.ones(T_, tdt), dec) is kernel
    assert TB.kernel_quantum(dec) == 1024 * max(dec, 1)


def _two_blocks(jop, top, x, jdt, tdt):
    js = jop.init_state(dtype=jdt)
    ts = top.init_state(dtype=tdt, device=CPU)
    out = []
    for xb in np.split(x, 2):
        jy, js = jop.apply(js, jnp.asarray(xb))
        ty, ts = top.apply(ts, _t(xb))
        assert ty.dtype == {jnp.complex64: torch.complex64,
                            jnp.float32: torch.float32}[
            jnp.dtype(jy.dtype).type]
        out.append((jy, ty, js, ts))
    return out


KERNEL_CASES = [
    # (op kind, dec, T, complex taps, complex stream)
    ("dec", 5, 63, False, True),
    ("dec", 5, 63, True, True),
    ("dec", 4, 32, False, False),
    ("dec", 2, 256, True, False),
    ("fir", 1, 33, True, True),
    ("fir", 1, 1025, False, True),
    ("fir", 1, 17, False, False),
]


@pytest.mark.parametrize("case", KERNEL_CASES,
                         ids=lambda c: "-".join(map(str, c)))
def test_fir_kernel_route_matches_jax(case):
    kind, dec, T_, ctaps, cx = case
    rng = np.random.default_rng(T_ + dec)
    h = rng.normal(size=T_)
    if ctaps:
        h = h + 1j * rng.normal(size=T_)
    h = h.astype(np.complex64 if ctaps else np.float32)
    n = 2 * TB.kernel_quantum(dec)
    x = rng.normal(size=n) + (1j * rng.normal(size=n) if cx else 0)
    x = x.astype(np.complex64 if cx else np.float32)
    if kind == "fir":
        jop, top = J.Fir.make(h), T.Fir.make(h)
    else:
        jop, top = J.FirDecimate.make(h, dec), T.FirDecimate.make(h, dec)
    half = n // 2
    assert TB.takes_kernel(torch.from_numpy(x).dtype, half, h, dec)
    jdt = jnp.complex64 if cx else jnp.float32
    tdt = torch.complex64 if cx else torch.float32
    for jy, ty, js, ts in _two_blocks(jop, top, x, jdt, tdt):
        want = _np(jy)
        assert np.max(np.abs(_np(ty) - want)) <= TOL_K2 * np.abs(want).max()
        # the carried tail is input samples: exact, the JAX state's form
        assert ts.shape == js.shape and np.array_equal(_np(ts), _np(js))


@pytest.mark.parametrize("kind", ["fir", "dec"])
def test_fir_gemm_route_matches_jax(kind):
    rng = np.random.default_rng(3)
    h = (rng.normal(size=63) + 1j * rng.normal(size=63)).astype(np.complex64)
    x = (rng.normal(size=20000) + 1j * rng.normal(size=20000)).astype(
        np.complex64)
    if kind == "fir":
        jop, top, dec = J.Fir.make(h), T.Fir.make(h), 1
    else:
        jop, top, dec = J.FirDecimate.make(h, 5), T.FirDecimate.make(h, 5), 5
    assert not TB.takes_kernel(torch.complex64, 10000, h, dec)
    for jy, ty, js, ts in _two_blocks(jop, top, x, jnp.complex64,
                                      torch.complex64):
        want = _np(jy)
        assert np.max(np.abs(_np(ty) - want)) <= 1e-6 * np.abs(want).max()
        assert np.array_equal(_np(ts), _np(js))


def test_fir_device_constants_resolved_once():
    h = np.hamming(31).astype(np.float32)
    op = T.FirDecimate.make(h, 5)
    s = op.init_state(device=CPU)
    for _ in range(3):
        _, s = op.apply(s, torch.ones(1000, dtype=torch.complex64))
    assert len(op._dev) == 1
    assert op == T.FirDecimate.make(h, 5)       # the cache takes no part


# ------------------------------------------- every other BlockOp vs JAX

def _chain(jop, top, xs, jdt=jnp.complex64, tdt=torch.complex64):
    js = jop.init_state(dtype=jdt)
    ts = top.init_state(dtype=tdt, device=CPU)
    outs = []
    for xb in xs:
        jy, js = jop.apply(js, None if xb is None else jnp.asarray(xb))
        ty, ts = top.apply(ts, None if xb is None else _t(xb))
        outs.append((_np(jy), _np(ty)))
    return outs


def test_sources_match_jax():
    for jop, top in [
        (J.UniformSource(block=512, start=-1.0, end=1.0, seed=7),
         T.UniformSource(block=512, start=-1.0, end=1.0, seed=7)),
        (J.RandomBitSource(block=512, seed=11),
         T.RandomBitSource(block=512, seed=11)),
        (J.PrnSource.make(0xC0, 0x5A, 8, 512),
         T.PrnSource.make(0xC0, 0x5A, 8, 512)),
        (J.UniformSource(block=512, seed=3, dtype=jnp.float64),
         T.UniformSource(block=512, seed=3, dtype=torch.float64)),
    ]:
        for jy, ty in _chain(jop, top, [None] * 3):
            assert np.array_equal(jy, ty), type(top).__name__


@pytest.mark.parametrize("dt", ["float32", "float64"])
def test_normal_source_matches_jax(dt):
    ulps = {"float32": 4, "float64": 3}[dt]   # tests/test_torch_random.py
    jop = J.NormalSource(block=4096, mu=0.5, std_dev=2.0, seed=9,
                         dtype=getattr(jnp, dt))
    top = T.NormalSource(block=4096, mu=0.5, std_dev=2.0, seed=9,
                         dtype=getattr(torch, dt))
    for jy, ty in _chain(jop, top, [None] * 2):
        assert ty.dtype == jy.dtype
        bound = ulps * np.spacing(np.abs(jy - 0.5)) + np.spacing(np.abs(jy))
        assert (np.abs(jy - ty) <= bound).all()


def test_stream_ops_match_jax():
    rng = np.random.default_rng(17)
    cx = (rng.normal(size=(3, 256)) + 1j * rng.normal(size=(3, 256))
          ).astype(np.complex64)
    bits = rng.integers(0, 2, size=(3, 256)).astype(np.int8)
    perr = (0.01 * rng.normal(size=(3, 256))).astype(np.float32)
    h = taps.rrc_taps(24, 3.0, 0.3).real
    cases = [
        (J.Upsample(4), T.Upsample(4), cx, 0),
        (J.Decimate(4, streaming=True), T.Decimate(4, streaming=True), cx,
         0),
        (J.Fft(64), T.Fft(64), cx, 2e-5),
        (J.Ifft(64), T.Ifft(64), cx, 2e-4),
        (J.Ifft(64, normalize=True), T.Ifft(64, normalize=True), cx, 5e-6),
        (J.BpskMod(), T.BpskMod(), bits, 0),
        (J.QpskMod(), T.QpskMod(), bits, 0),
        (J.QpskMod(example_convention=True),
         T.QpskMod(example_convention=True), bits, 0),
        (J.Mixer(0.7, 0.3), T.Mixer(0.7, 0.3), cx, 2e-6),
        (J.Nco(0.37, 1.1), T.Nco(0.37, 1.1), perr, 2e-5),
        (J.FmDemod(fast=True), T.FmDemod(fast=True), cx, 2e-6),
        (J.RationalResample.make(h, 3, 2), T.RationalResample.make(h, 3, 2),
         cx, 2e-6),
        (J.PulseShape.make(h.astype(np.complex64), 3),
         T.PulseShape.make(h.astype(np.complex64), 3), cx, 2e-6),
    ]
    for jop, top, xs, tol in cases:
        assert top.rate == jop.rate and top.halo == jop.halo
        assert top.out_len(256) == jop.out_len(256)
        for jy, ty in _chain(jop, top, xs):
            assert jy.shape == ty.shape, top
            np.testing.assert_allclose(ty, jy, atol=tol, rtol=0,
                                       err_msg=repr(top))
