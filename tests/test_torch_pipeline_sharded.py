"""The port's sharded Pipeline and Graph on an 8-shard CPU mesh: the
tests of tests/test_pipeline_sharded.py, each holding the port's sharded
step to its one-device step (bit for bit where the JAX test asserts
that, else at its tolerance) and to the JAX package's sharded step on
the conftest's 8-device CPU mesh; and dry-run config 3.

Bounds (the JAX tests'): FIR/FM/pulse/resample chains 1e-5, mixer 1e-5
with the fixed-point phase bit for bit, NCO 2e-5 with the carried phase
within 2e-4 rad, the fuzzed chains 2e-5 of their scale, sources, PRN and
graph feedback bit for bit; the port against JAX at the same bounds."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comms_tpu import runtime as J
from comms_tpu.models.fm_receiver import FM_LPF_TAPS
from comms_tpu.ops import taps
from comms_tpu.parallel import sharding as jsh
from comms_tpu_torch import runtime as T
from comms_tpu_torch.parallel import dryrun as tdry
from comms_tpu_torch.parallel import sharding as tsh

CPU = "cpu"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _meshes():
    return jsh.time_mesh(8), tsh.time_mesh(8, device=CPU)


def _run_all(jpipe, tpipe, x, blocks=2, atol=1e-5):
    """``blocks`` chained blocks through the port sharded and unsharded
    and JAX sharded; returns the final states."""
    jmesh, tmesh = _meshes()
    jstep = jpipe.make_sharded_step(jmesh, block=x.shape[1])
    tstep = tpipe.make_sharded_step(tmesh, block=x.shape[1])
    s_ref, s_sh = tpipe.init_state(CPU), tpipe.init_state(CPU)
    js = jpipe.init_state()
    for b in range(blocks):
        y_ref, s_ref = tpipe.step(s_ref, _t(x[b]))
        y_sh, s_sh = tstep(s_sh, _t(x[b]))
        jy, js = jstep(js, jnp.asarray(x[b]))
        assert np.allclose(_np(y_sh), _np(y_ref), atol=atol), b
        assert np.allclose(_np(y_sh), _np(jy), atol=atol), b
    return s_ref, s_sh


def _both(ops):
    """The JAX and port pipelines of ``ops(M)``."""
    return J.Pipeline(ops(J)), T.Pipeline(ops(T))


def test_sharded_fir_chain():
    rng = np.random.default_rng(0)
    t = (rng.normal(size=33) + 1j * rng.normal(size=33)).astype(np.complex64)
    jp, tp = _both(lambda M: [M.Lambda(lambda v: v * 2.0), M.Fir.make(t)])
    x = (rng.normal(size=(2, 2048)) + 1j * rng.normal(size=(2, 2048))
         ).astype(np.complex64)
    _run_all(jp, tp, x)


def test_sharded_fm_chain():
    rng = np.random.default_rng(1)
    jp, tp = _both(lambda M: [
        M.FirDecimate.make(FM_LPF_TAPS.astype(np.complex64), 5),
        M.FmDemod(),
        M.FirDecimate.make(FM_LPF_TAPS.astype(np.float32), 5),
    ])
    ph = np.cumsum(0.2 + 0.05 * rng.normal(size=(2, 8 * 2000)), axis=1)
    x = np.exp(1j * ph).astype(np.complex64)
    s_ref, s_sh = _run_all(jp, tp, x)
    assert torch.equal(s_ref[0], s_sh[0])     # the input tail, exact


def test_sharded_fm_chain_kernel_route():
    # Per-shard blocks of 8 * 5120 samples take K2's route (its plain
    # version here, a GEMM whose sums are blocked by the call's length:
    # 1e-5; the kernel's FMA chains on the card are the same bits however
    # the stream is cut); the halos come from one ring exchange per op.
    rng = np.random.default_rng(9)
    tp = T.Pipeline([
        T.FirDecimate.make(FM_LPF_TAPS.astype(np.complex64), 5),
        T.FmDemod(fast=True),
        T.FirDecimate.make(FM_LPF_TAPS.astype(np.float32), 5),
    ])
    N = 8 * 5120 * 5
    ph = np.cumsum(0.2 + 0.05 * rng.normal(size=(2, N)), axis=1)
    x = np.exp(1j * ph).astype(np.complex64)
    tstep = tp.make_sharded_step(tsh.time_mesh(8, device=CPU), block=N)
    s_ref, s_sh = tp.init_state(CPU), tp.init_state(CPU)
    for b in range(2):
        y_ref, s_ref = tp.step(s_ref, _t(x[b]))
        y_sh, s_sh = tstep(s_sh, _t(x[b]))
        assert torch.allclose(y_sh, y_ref, rtol=0, atol=1e-5), b
        assert torch.equal(s_sh[0], s_ref[0])


def test_sharded_mixer_phase_offsets():
    rng = np.random.default_rng(2)
    jp, tp = _both(lambda M: [M.Mixer(dphase=0.7, phase0=0.3)])
    x = (rng.normal(size=(3, 4096)) + 1j * rng.normal(size=(3, 4096))
         ).astype(np.complex64)
    s_ref, s_sh = _run_all(jp, tp, x, blocks=3)
    assert s_ref[0] == s_sh[0]            # fixed-point phase, exact


def test_sharded_pulse_shaping_symbol_domain():
    rng = np.random.default_rng(3)
    t = taps.rrc_taps(32, 4.0, 0.25).astype(np.complex64)
    jp, tp = _both(lambda M: [M.BpskMod(), M.PulseShape.make(t, 4)])
    bits = rng.integers(0, 2, size=(2, 1024)).astype(np.int8)
    _run_all(jp, tp, bits)


def _source_steps(jp, tp, blocks):
    jmesh, tmesh = _meshes()
    jstep, tstep = jp.make_sharded_step(jmesh), tp.make_sharded_step(tmesh)
    s_ref, s_sh, js = tp.init_state(CPU), tp.init_state(CPU), jp.init_state()
    for b in range(blocks):
        y_ref, s_ref = tp.step(s_ref, None)
        y_sh, s_sh = tstep(s_sh, None)
        jy, js = jstep(js, None)
        yield b, y_ref, y_sh, jy, s_ref, s_sh, js


def test_sharded_prn_source_bit_exact():
    jp, tp = _both(lambda M: [M.PrnSource.make(0xC0, 1, 8, 64)])
    for b, y_ref, y_sh, jy, s_ref, s_sh, js in _source_steps(jp, tp, 3):
        assert torch.equal(y_sh, y_ref) and np.array_equal(_np(y_sh),
                                                           _np(jy)), b
        assert torch.equal(s_sh[0], s_ref[0])
        assert np.array_equal(_np(s_sh[0]), _np(js[0])), b


@pytest.mark.parametrize("kind", ["uniform", "normal", "bits"])
def test_sharded_random_sources_bit_exact(kind):
    def ops(M):
        if kind == "uniform":
            return [M.UniformSource(block=256, start=-1.0, end=1.0, seed=7)]
        if kind == "normal":
            return [M.NormalSource(block=256, mu=0.5, std_dev=2.0, seed=9)]
        return [M.RandomBitSource(block=256, seed=11)]

    jp, tp = _both(ops)
    for b, y_ref, y_sh, jy, *_ in _source_steps(jp, tp, 2):
        assert torch.equal(y_sh, y_ref), b
        if kind == "normal":              # 4 float32 ulp of JAX's
            jy = _np(jy)
            bound = 4 * np.spacing(np.abs(jy - 0.5)) + np.spacing(np.abs(jy))
            assert (np.abs(_np(y_sh) - jy) <= bound).all()
        else:
            assert np.array_equal(_np(y_sh), _np(jy)), b


def test_sharded_source_headed_tx_chain():
    t = taps.rrc_taps(32, 4.0, 0.25).astype(np.complex64)
    jp, tp = _both(lambda M: [M.PrnSource.make(0xC0, 0x5A, 8, 512),
                              M.BpskMod(), M.PulseShape.make(t, 4)])
    for b, y_ref, y_sh, jy, *_ in _source_steps(jp, tp, 3):
        assert np.allclose(_np(y_sh), _np(y_ref), atol=1e-6), b
        assert np.allclose(_np(y_sh), _np(jy), atol=1e-6), b


def test_sharded_validates_halo_vs_shard():
    tp = T.Pipeline([T.Fir.make(np.ones(129, np.complex64))])
    with pytest.raises(ValueError):
        tp.make_sharded_step(tsh.time_mesh(8, device=CPU), block=8 * 64)
    with pytest.raises(ValueError):
        tp.make_sharded_step(tsh.time_mesh(8, device=CPU), block=8 * 64 + 1)


def test_sharded_nco_prefix_sum():
    rng = np.random.default_rng(5)
    jp, tp = _both(lambda M: [M.Nco(dphase=0.37, phase0=1.1)])
    jmesh, tmesh = _meshes()
    jstep, tstep = jp.make_sharded_step(jmesh), tp.make_sharded_step(tmesh)
    s_ref, s_sh, js = tp.init_state(CPU), tp.init_state(CPU), jp.init_state()
    for b in range(3):
        perr = (0.01 * rng.normal(size=4096)).astype(np.float32)
        y_ref, s_ref = tp.step(s_ref, _t(perr))
        y_sh, s_sh = tstep(s_sh, _t(perr))
        jy, js = jstep(js, jnp.asarray(perr))
        assert np.allclose(_np(y_sh), _np(y_ref), atol=2e-5), b
        assert np.allclose(_np(y_sh), _np(jy), atol=2e-5), b
        for other in (float(s_ref[0]), float(np.asarray(js[0]))):
            d = abs(float(s_sh[0]) - other)
            assert min(d, abs(d - 2 * np.pi)) < 2e-4, b


def _random_ops(M, r):
    """A random chain of rate-safe ops (the JAX test's generator)."""
    ops = []
    for _ in range(int(r.integers(2, 5))):
        kind = r.choice(["fir", "firdec", "mixer", "lam", "ups"])
        if kind == "fir":
            T_ = int(r.integers(2, 40))
            ops.append(M.Fir.make((r.normal(size=T_) + 1j * r.normal(
                size=T_)).astype(np.complex64)))
        elif kind == "firdec":
            T_ = int(r.integers(4, 40))
            ops.append(M.FirDecimate.make(
                r.normal(size=T_).astype(np.complex64),
                int(r.choice([2, 4]))))
        elif kind == "mixer":
            ops.append(M.Mixer(dphase=float(r.uniform(0, 3)),
                               phase0=float(r.uniform(0, 6))))
        elif kind == "lam":
            ops.append(M.Lambda(lambda v: v * (0.5 + 0.25j)))
        else:
            ops.append(M.Upsample(int(r.choice([2, 4]))))
    return ops


@pytest.mark.parametrize("trial", range(4))
def test_sharded_random_pipelines_fuzz(trial):
    seed = 1000 + trial
    tp = T.Pipeline(_random_ops(T, np.random.default_rng(seed)))
    jp = J.Pipeline(_random_ops(J, np.random.default_rng(seed)))
    block = 8 * 1024
    local = block // 8
    try:
        tp.check_block_size(local)
    except ValueError:
        pytest.skip("chain not integral at this block (as in the JAX test)")
    for op in tp.ops:
        if 0 < local <= op.halo:
            pytest.skip("a halo exceeds the shard (as in the JAX test)")
        local = op.out_len(local)
    r = np.random.default_rng(seed + 7)
    x = (r.normal(size=(block,)) + 1j * r.normal(size=(block,))
         ).astype(np.complex64)
    jmesh, tmesh = _meshes()
    y_ref, _ = tp.step(tp.init_state(CPU), _t(x))
    y_sh, _ = tp.make_sharded_step(tmesh, block=block)(tp.init_state(CPU),
                                                        _t(x))
    jy, _ = jp.make_sharded_step(jmesh, block=block)(jp.init_state(),
                                                     jnp.asarray(x))
    scale = max(float(y_ref.abs().max()), 1e-9)
    assert np.allclose(_np(y_sh), _np(y_ref), atol=2e-5 * scale), tp
    assert np.allclose(_np(y_sh), _np(jy), atol=2e-5 * scale), tp


def test_sharded_graph_dag():
    rng = np.random.default_rng(13)
    t = rng.normal(size=17).astype(np.complex64)

    def build(M):
        g = M.Graph()
        g.add_input("iq")
        g.add_node("lpf", M.Fir.make(t), ["iq"])
        g.add_node("gain", M.Lambda(lambda v: v * 2.0), ["lpf"])
        g.add_node("dec", M.FirDecimate.make(t, 2), ["iq"])
        g.set_outputs(["gain", "dec"])
        return g

    g, jg = build(T), build(J)
    jmesh, tmesh = _meshes()
    step_ref, step_sh = g.compile(), g.make_sharded_step(tmesh)
    jstep = jg.make_sharded_step(jmesh)
    s_ref, s_sh = g.init_state(device=CPU), g.init_state(device=CPU)
    js = jg.init_state()
    x = (rng.normal(size=(2, 2048)) + 1j * rng.normal(size=(2, 2048))
         ).astype(np.complex64)
    for b in range(2):
        (g1, d1), s_ref = step_ref(s_ref, {"iq": _t(x[b])})
        (g2, d2), s_sh = step_sh(s_sh, {"iq": _t(x[b])})
        (jg2, jd2), js = jstep(js, {"iq": jnp.asarray(x[b])})
        for got, want in ((g2, g1), (d2, d1), (g2, jg2), (d2, jd2)):
            assert np.allclose(_np(got), _np(want), atol=1e-5), b


def test_sharded_decimate_guard():
    tp = T.Pipeline([T.Decimate(dec=3)])
    step = tp.make_sharded_step(tsh.time_mesh(8, device=CPU))
    x = torch.arange(8 * 9, dtype=torch.float32)
    y, _ = step(tp.init_state(CPU), x)
    y_ref, _ = tp.step(tp.init_state(CPU), x)
    assert torch.equal(y, y_ref)
    jp = J.Pipeline([J.Decimate(dec=3)])
    jy, _ = jp.make_sharded_step(jsh.time_mesh(8))(
        jp.init_state(), jnp.arange(8 * 9, dtype=jnp.float32))
    assert np.array_equal(_np(y), _np(jy))
    with pytest.raises(ValueError):
        step(tp.init_state(CPU), torch.arange(80.0))  # 10/shard, % 3 != 0


def test_sharded_rational_resample():
    rng = np.random.default_rng(21)
    h = np.asarray(taps.rrc_taps(24, 3.0, 0.3)).real
    jp, tp = _both(lambda M: [M.RationalResample.make(h, 3, 2)])
    assert tp.check_block_size(256) == 384
    x = (rng.normal(size=(2, 8 * 256)) + 1j * rng.normal(size=(2, 8 * 256))
         ).astype(np.complex64)
    _run_all(jp, tp, x)


def _feedback_graph(M, zeros):
    g = M.Graph()
    g.add_input("x")
    g.add_node("sum", lambda a, b: a + b, ["x", "acc"],
               feedback_from={"acc": zeros}, elementwise=True)
    g.add_node("acc", M.Lambda(lambda v: v), ["sum"])
    g.set_outputs(["acc"])
    return g


def test_sharded_graph_feedback_doubling():
    g_ref = _feedback_graph(T, torch.zeros(64))
    g_sh = _feedback_graph(T, torch.zeros(64))
    jg = _feedback_graph(J, jnp.zeros(64, jnp.float32))
    jmesh, tmesh = _meshes()
    step_ref, step_sh = g_ref.compile(), g_sh.make_sharded_step(tmesh)
    jstep = jg.make_sharded_step(jmesh)
    s_ref, s_sh = g_ref.init_state(device=CPU), g_sh.init_state(device=CPU)
    js = jg.init_state()
    x = torch.ones(64)
    for b in range(5):
        (y_ref,), s_ref = step_ref(s_ref, {"x": x})
        (y_sh,), s_sh = step_sh(s_sh, {"x": x})
        (jy,), js = jstep(js, {"x": jnp.ones(64, jnp.float32)})
        assert torch.equal(y_sh, y_ref), b
        assert np.array_equal(_np(y_sh), _np(jy)), b
    assert float(y_ref[0]) == 5.0


def test_sharded_graph_rejects_undeclared_raw_callable():
    g = T.Graph()
    g.add_input("x")
    g.add_node("power", lambda v: torch.sum(v.abs() ** 2) * torch.ones_like(v),
               ["x"])
    g.set_outputs(["power"])
    with pytest.raises(ValueError, match="elementwise"):
        g.make_sharded_step(tsh.time_mesh(8, device=CPU))


def test_dryrun_config3():
    tdry._dryrun_pipeline(8, tsh.time_mesh(8, device=CPU), CPU)
