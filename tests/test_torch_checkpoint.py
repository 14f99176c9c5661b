"""Checkpoints and state hand-over between the packages, and the second
half of the metrics module.

* resume is bit-exact (mirrors tests/test_aux.py:17);
* a checkpoint the JAX package writes for a Pipeline (or a Graph) loads
  into the port's counterpart and continues the stream, and one the port
  writes loads into the JAX package;
* ``state_from_jax`` turns a JAX state's numpy leaves into the port's.

Bounds: carried bits, keys, tails and fixed-point phases exact; the next
block within 1e-6 of unit-scale output (float32 rounding: the mixer's
phasor is float32 in both packages, in complex128 pipelines too)."""

import json

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comms_tpu import runtime as J
from comms_tpu.ops import taps
from comms_tpu.runtime import checkpoint as jck
from comms_tpu.runtime import metrics as jmet
from comms_tpu_torch import runtime as T
from comms_tpu_torch.runtime import boundary as tbd
from comms_tpu_torch.runtime import checkpoint as tck
from comms_tpu_torch.runtime import metrics as tmet

CPU = "cpu"


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _tx(M, cdt):
    t = taps.rrc_taps(16, 2.0, 0.3).astype(np.complex128)
    return M.Pipeline([
        M.PrnSource.make(0xC0, 0x5A, 8, 64),
        M.BpskMod(dtype=cdt),
        M.PulseShape.make(t, 2),
        M.Mixer(dphase=0.7),
    ], state_dtype=cdt)


def _fm(M, cdt, fdt):
    from comms_tpu.models.fm_receiver import FM_LPF_TAPS
    return M.Pipeline([
        M.FirDecimate.make(FM_LPF_TAPS.astype(np.complex64), 5),
        M.FmDemod(fast=True),
        M.FirDecimate.make(FM_LPF_TAPS.astype(np.float32), 5),
    ], state_dtype=cdt)


def test_checkpoint_resume_bit_exact(tmp_path):
    pipe = _tx(T, torch.complex128)
    state = pipe.init_state(CPU)
    for _ in range(3):
        _, state = pipe.step(state)
    ckpt = tmp_path / "stream.npz"
    tck.save_state(ckpt, state, meta={"blocks_done": 3})
    y_cont, state_cont = pipe.step(state)
    restored = tck.load_state(ckpt, pipe.init_state(CPU))
    y_resumed, state_res = pipe.step(restored)
    assert torch.equal(y_cont, y_resumed)
    assert state_res[3] == state_cont[3]
    side = json.loads((tmp_path / "stream.npz.json").read_text())
    assert side["meta"] == {"blocks_done": 3}
    assert side["paths"] == ["[0]", "[2]", "[3][0]", "[3][1]"]


def test_checkpoint_rejects_other_structure(tmp_path):
    pipe = _tx(T, torch.complex64)
    tck.save_state(tmp_path / "a", pipe.init_state(CPU))
    with pytest.raises(ValueError):
        tck.load_state(tmp_path / "a", (torch.zeros(3),))
    other = T.Pipeline([T.Mixer(0.1), T.PrnSource.make(0xC0, 1, 8, 64),
                        T.BpskMod(), T.PulseShape.make(np.ones(4), 2)])
    with pytest.raises(ValueError, match="structure"):
        tck.load_state(tmp_path / "a", other.init_state(CPU))


@pytest.mark.parametrize("cdt", ["complex64", "complex128"])
def test_jax_checkpoint_resumes_in_port(tmp_path, cdt):
    jp, tp = _tx(J, getattr(jnp, cdt)), _tx(T, getattr(torch, cdt))
    js = jp.init_state()
    for _ in range(3):
        _, js = jp.step(js)
    jck.save_state(tmp_path / "j.npz", js, meta={"from": "jax"})
    ts = tck.load_state(tmp_path / "j.npz", tp.init_state(CPU))
    assert np.array_equal(_np(ts[0]), _np(js[0]))           # LFSR
    assert np.array_equal(_np(ts[2]), _np(js[2]))           # pulse tail
    assert ts[3] == tuple(int(w) for w in js[3])            # mixer words
    # the mixer's phasor is float32 in both packages (exp of a float32
    # angle, rounded by XLA there and numpy here): 1e-6 in either dtype
    tol = 1e-6
    for _ in range(2):
        jy, js = jp.step(js)
        ty, ts = tp.step(ts)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=tol, rtol=0)


def test_port_checkpoint_resumes_in_jax(tmp_path):
    jp, tp = _tx(J, jnp.complex64), _tx(T, torch.complex64)
    ts = tp.init_state(CPU)
    for _ in range(3):
        _, ts = tp.step(ts)
    tck.save_state(tmp_path / "t", ts)
    js = jck.load_state(tmp_path / "t", jp.init_state())
    jy, _ = jp.step(js)
    ty, _ = tp.step(ts)
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-6, rtol=0)


def test_jax_fm_checkpoint_resumes_in_port(tmp_path):
    # complex and real tails, an FM prev sample (0-d complex -> pairs)
    jp, tp = _fm(J, jnp.complex64, jnp.float32), _fm(T, torch.complex64,
                                                     torch.float32)
    rng = np.random.default_rng(4)
    x = np.exp(1j * np.cumsum(0.2 + 0.05 * rng.normal(size=(3, 2000)),
                              axis=1)).astype(np.complex64)
    js = jp.init_state()
    for b in range(2):
        _, js = jp.step(js, jnp.asarray(x[b]))
    jck.save_state(tmp_path / "fm", js)
    ts = tck.load_state(tmp_path / "fm", tp.init_state(CPU))
    for a, b in zip(ts, js):
        assert np.array_equal(_np(a), _np(b))
    jy, _ = jp.step(js, jnp.asarray(x[2]))
    ty, _ = tp.step(ts, torch.from_numpy(x[2]))
    np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-6, rtol=0)


def test_graph_checkpoint_carries_across(tmp_path):
    def build(M, zeros):
        g = M.Graph()
        g.add_input("x")
        g.add_node("sum", lambda a, b: a + b, ["x", "acc"],
                   feedback_from={"acc": zeros})
        g.add_node("acc", M.Lambda(lambda v: v), ["sum"])
        g.add_node("mix", M.Mixer(0.3), ["acc"])
        g.set_outputs(["mix"])
        return g

    # complex streams: the JAX Mixer on a real stream casts its phasor to
    # the real dtype (a defect of the reference package, not copied)
    jg = build(J, jnp.zeros(16, jnp.complex64))
    tg = build(T, torch.zeros(16, dtype=torch.complex64))
    jx = jnp.ones(16, jnp.complex64)
    js = jg.init_state()
    for _ in range(2):
        _, js = jg.compile()(js, {"x": jx})
    jck.save_state(tmp_path / "g", js)
    ts = tck.load_state(tmp_path / "g", tg.init_state(device=CPU))
    assert ts["ops"]["mix"] == tuple(int(w) for w in js["ops"]["mix"])
    assert torch.equal(ts["fb"]["sum@fb:acc"],
                       torch.from_numpy(np.asarray(js["fb"]["sum@fb:acc"])))
    (ty,), _ = tg.compile()(ts, {"x": torch.ones(16, dtype=torch.complex64)})
    (jy,), _ = jg.compile()(js, {"x": jx})
    # |y| = 3 after three sums: 1e-6 of the largest output
    np.testing.assert_allclose(_np(ty), _np(jy),
                               atol=1e-6 * np.abs(_np(jy)).max(), rtol=0)
    side = json.loads((tmp_path / "g.npz.json").read_text())
    assert side["paths"] == tck._path_fingerprint(ts)


def test_state_from_jax():
    jp, tp = _tx(J, jnp.complex64), _tx(T, torch.complex64)
    js = jp.init_state()
    for _ in range(2):
        _, js = jp.step(js)
    leaves = [np.asarray(l) for l in jax.tree_util.tree_leaves(js)]
    ts = tck.state_from_jax(tp, leaves, device=CPU)
    ts2 = tck.state_from_jax(tp, jax.tree_util.tree_map(np.asarray, js),
                             device=CPU)
    jy, _ = jp.step(js)
    for s in (ts, ts2):
        assert s[2].dtype == torch.complex64 and s[0].dtype == torch.int8
        ty, _ = tp.step(s)
        np.testing.assert_allclose(_np(ty), _np(jy), atol=1e-6, rtol=0)
    with pytest.raises(ValueError):
        tck.state_from_jax(tp, leaves[:-1], device=CPU)


def test_boundary_codecs():
    z = np.array([1 + 2j, -3.5j], np.complex64)
    p = tbd.host_complex_to_pairs(z)
    assert p.shape == (2, 2) and np.array_equal(tbd.host_pairs_to_complex(p),
                                                z)
    state = (torch.tensor(z), torch.arange(3), {"k": torch.tensor(1 + 1j)})
    enc = tbd.encode_state(state)
    assert enc[0].shape == (2, 2) and enc[2]["k"].shape == (2,)
    dec = tbd.decode_state(enc, state)
    assert torch.equal(dec[0], state[0]) and torch.equal(dec[1], state[1])
    assert dec[2]["k"] == state[2]["k"]


def test_roofline_memory_bound():
    # The JAX test's numbers at its own rates, passed explicitly.
    kw = dict(hbm_gbps=jmet.V5E_HBM_GBPS, peak_tflops=jmet.V5E_F32_TFLOPS)
    r = tmet.roofline(bytes_moved=819e9, flops=1e9, seconds=1.0, **kw)
    assert r == jmet.roofline(bytes_moved=819e9, flops=1e9, seconds=1.0)
    assert r["bound"] == "memory" and abs(r["pct_of_sol"] - 100.0) < 1.0
    c = tmet.roofline(bytes_moved=1e6, flops=67e12, seconds=2.0,
                      hbm_gbps=3350.0, peak_tflops=67.0)
    assert c["bound"] == "compute" and c["pct_of_sol"] == 50.0


def test_profiling_helpers(tmp_path):
    assert tmet.sync_overhead(reps=2, device=CPU) >= 0.0
    with tmet.trace(tmp_path / "trace"):
        with tmet.named_scope("block"):
            torch.ones(8).sum()
    assert any(p.suffix == ".json" for p in (tmp_path / "trace").iterdir())
