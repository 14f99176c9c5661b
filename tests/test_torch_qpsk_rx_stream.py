"""The port's streaming QPSK receiver against the JAX package's: the fast
and fused steps over two IN_PER_STEP blocks of a modulated waveform with
CFO (the JAX fused step runs its Pallas kernel in interpret mode), a
stream continued mid-way from a JAX state, zero BER after the warm-up
block, StreamRunner against a plain loop, and the fused step's errors;
the fused step at ``est_lag=2`` against JAX's over three blocks (zero BER
after its two warm-up blocks, a stream continued from a JAX state with
its carried panels); the split steps against the fast step, by hand and
through StreamRunner at depth 2 (mirrors of tests/test_qpsk_rx_stream.py's
split tests, at its 1e-5 bound)."""

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import qpsk_sym_pallas as JQS
from comms_tpu.models import qpsk_rx as jrx
from comms_tpu.models import qpsk_rx_stream as jstream
from comms_tpu.models import qpsk_tx
from comms_tpu.ops import random as crandom
from comms_tpu_torch.models import qpsk_rx as trx
from comms_tpu_torch.models import qpsk_rx_stream as tstream
from comms_tpu_torch.runtime import StreamRunner

B = JQS.IN_PER_STEP
# tests/test_qpsk_rx_stream.py's bounds for the fused step against the
# fast one (symbols, state), and for the split steps against the fast one
TOL_SYM = 2e-3
TOL_STATE = 1e-3
TOL_SPLIT = 1e-5


@pytest.fixture(scope="module")
def signal():
    """A continuous qpsk_tx waveform of 2 blocks with CFO and phase."""
    nbits = 2 * (2 * B // 4) + 256
    tcfg = qpsk_tx.QpskTxConfig(bits_per_block=nbits, dphase=0.0)
    iq, _ = qpsk_tx.make_block_fn(tcfg)(qpsk_tx.init_state(tcfg, 3))
    z = np.asarray(iq).astype(np.float32) / tcfg.scale
    x = (z[:, 0] + 1j * z[:, 1]).astype(np.complex128)
    bits, _ = crandom.random_bits_block(crandom.source_init(3), nbits)
    n = np.arange(len(x))
    xc = (x * np.exp(1j * (0.006 * n + 0.8))).astype(np.complex64)
    blocks = [(np.ascontiguousarray(xc[b * B:(b + 1) * B].real),
               np.ascontiguousarray(xc[b * B:(b + 1) * B].imag))
              for b in range(2)]
    return blocks, np.asarray(bits)


@pytest.fixture(scope="module")
def signal3():
    """The same waveform over 3 blocks (est_lag=2 warms up for two)."""
    nbits = 2 * (3 * B // 4) + 256
    tcfg = qpsk_tx.QpskTxConfig(bits_per_block=nbits, dphase=0.0)
    iq, _ = qpsk_tx.make_block_fn(tcfg)(qpsk_tx.init_state(tcfg, 4))
    z = np.asarray(iq).astype(np.float32) / tcfg.scale
    x = (z[:, 0] + 1j * z[:, 1]).astype(np.complex128)
    bits, _ = crandom.random_bits_block(crandom.source_init(4), nbits)
    n = np.arange(len(x))
    xc = (x * np.exp(1j * (0.006 * n + 0.8))).astype(np.complex64)
    blocks = [(np.ascontiguousarray(xc[b * B:(b + 1) * B].real),
               np.ascontiguousarray(xc[b * B:(b + 1) * B].imag))
              for b in range(3)]
    return blocks, np.asarray(bits)


def _torch(block):
    return tuple(torch.from_numpy(p.copy()) for p in block)


def _assert_state_close(st_t, st_j, msg):
    for k in st_j:
        np.testing.assert_allclose(st_t[k].numpy(), np.asarray(st_j[k]),
                                   atol=TOL_STATE, rtol=TOL_STATE,
                                   err_msg=f"state {k} ({msg})")


@pytest.mark.parametrize("name", ["make_stream_fast_fn",
                                  "make_stream_fused_fn"])
def test_stream_steps_match_jax(signal, name):
    blocks, bits = signal
    jcfg, tcfg = jrx.QpskRxConfig(), trx.QpskRxConfig()
    jstep = getattr(jstream, name)(jcfg)
    tstep = getattr(tstream, name)(tcfg)
    st_j = jstream.init_state_fast(jcfg)
    st_t = tstream.init_state_fast(tcfg, device="cpu")
    outs = []
    for b, (re, im) in enumerate(blocks):
        y_j, st_j = jstep(st_j, jnp.asarray(re), jnp.asarray(im))
        y_t, st_t = tstep(st_t, *_torch((re, im)))
        y_j = np.asarray(y_j)
        assert y_t.shape == y_j.shape == (2, B // 4)
        np.testing.assert_allclose(y_t.numpy(), y_j, atol=TOL_SYM,
                                   rtol=TOL_SYM, err_msg=f"block {b}")
        _assert_state_close(st_t, st_j, f"block {b}")
        outs.append(y_t.numpy())
    # zero bit errors after the warm-up block (tx + rx group delay: 8
    # symbols)
    M = B // 4
    margin = 32
    ref = bits[2 * (M + margin - 8):]
    (_, errs, m) = trx.resolve_ambiguity(outs[1][:, margin:], ref,
                                         search=1500, max_lag=16)
    assert m >= 2048 and errs == 0


def test_state_from_jax_continues_a_jax_stream(signal):
    blocks, _ = signal
    jcfg, tcfg = jrx.QpskRxConfig(), trx.QpskRxConfig()
    jstep = jstream.make_stream_fast_fn(jcfg)
    st_j = jstream.init_state_fast(jcfg)
    _, st_j = jstep(st_j, *(jnp.asarray(p) for p in blocks[0]))
    st_t = tstream.state_from_jax(st_j, device="cpu")
    assert st_t["shift2"].dtype == torch.int32
    assert set(st_t) == set(tstream.init_state_fast(tcfg, device="cpu"))
    y_j, st_j = jstep(st_j, *(jnp.asarray(p) for p in blocks[1]))
    for make in (tstream.make_stream_fast_fn, tstream.make_stream_fused_fn):
        y_t, st_t2 = make(tcfg)(dict(st_t), *_torch(blocks[1]))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                                   atol=TOL_SYM, rtol=TOL_SYM)
        _assert_state_close(st_t2, st_j, make.__name__)


def test_stream_runner_equals_a_plain_loop(signal):
    blocks, _ = signal
    cfg = trx.QpskRxConfig()
    step = tstream.make_stream_fused_fn(cfg)
    st = tstream.init_state_fast(cfg, device="cpu")
    want = []
    for blk in blocks:
        y, st = step(st, *_torch(blk))
        want.append(y.numpy())
    got = []
    runner = StreamRunner(lambda s, x: step(s, *x),
                          tstream.init_state_fast(cfg, device="cpu"),
                          iter(blocks),
                          sink=got.append, samples_of=lambda x: len(x[0]),
                          depth=2, device="cpu")
    runner.run()
    assert len(got) == 2
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    for k, v in st.items():
        assert torch.equal(runner.state[k], v)


def test_fused_step_errors():
    with pytest.raises(ValueError, match="sps=4"):
        tstream.make_stream_fused_fn(trx.QpskRxConfig(sps=8))
    with pytest.raises(ValueError, match="halfwidth"):
        tstream.make_stream_fused_fn(trx.QpskRxConfig(num_taps=48))
    step = tstream.make_stream_fused_fn(trx.QpskRxConfig())
    st = tstream.init_state_fast(device="cpu")
    z = torch.zeros(B // 2)
    with pytest.raises(ValueError, match="outside kernel bounds"):
        step(st, z, z)


def _jax_np(state):
    return {k: np.asarray(v) for k, v in state.items()}


def test_est_lag2_matches_jax(signal3):
    blocks, bits = signal3
    jcfg, tcfg = jrx.QpskRxConfig(), trx.QpskRxConfig()
    jstep = jstream.make_stream_fused_fn(jcfg, est_lag=2)
    tstep = tstream.make_stream_fused_fn(tcfg, est_lag=2)
    st_j = jstream.init_state_fused2(jcfg)
    st_t = tstream.init_state_fused2(tcfg, device="cpu")
    assert set(st_t) == set(st_j)
    for k in ("p1", "p2", "p3", "p4"):
        assert tuple(st_t[k].shape) == tuple(np.shape(st_j[k]))
    outs = []
    for b, (re, im) in enumerate(blocks):
        y_j, st_j = jstep(st_j, jnp.asarray(re), jnp.asarray(im))
        y_t, st_t = tstep(st_t, *_torch((re, im)))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                                   atol=TOL_SYM, rtol=TOL_SYM,
                                   err_msg=f"block {b}")
        # the carried panels are block sums: the panel-sized estimate
        # chain's bound, relative to the panels' scale
        for k in ("p1", "p2", "p3", "p4"):
            scale = float(np.abs(np.asarray(st_j[k])).max())
            assert float(np.abs(st_t[k].numpy() - np.asarray(st_j[k]))
                         .max()) <= TOL_STATE * scale, (k, b)
        _assert_state_close(
            {k: v for k, v in st_t.items() if not k.startswith("p")},
            {k: v for k, v in st_j.items() if not k.startswith("p")},
            f"block {b}")
        outs.append(y_t.numpy())
    # zero bit errors after the two warm-up blocks
    M = B // 4
    margin = 32
    ref = bits[2 * (2 * M + margin - 8):]
    (_, errs, m) = trx.resolve_ambiguity(outs[2][:, margin:], ref,
                                         search=1500, max_lag=16)
    assert m >= 2048 and errs == 0


def test_state_from_jax_carries_the_panels(signal3):
    blocks, _ = signal3
    jcfg, tcfg = jrx.QpskRxConfig(), trx.QpskRxConfig()
    jstep = jstream.make_stream_fused_fn(jcfg, est_lag=2)
    st_j = jstream.init_state_fused2(jcfg)
    for re, im in blocks[:2]:
        _, st_j = jstep(st_j, jnp.asarray(re), jnp.asarray(im))
    st_t = tstream.state_from_jax(_jax_np(st_j), device="cpu")
    assert set(st_t) == set(st_j)
    y_j, _ = jstep(st_j, *(jnp.asarray(p) for p in blocks[2]))
    y_t, _ = tstream.make_stream_fused_fn(tcfg, est_lag=2)(
        st_t, *_torch(blocks[2]))
    np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j), atol=TOL_SYM,
                               rtol=TOL_SYM)


def test_est_lag_is_checked():
    with pytest.raises(ValueError, match="est_lag"):
        tstream.make_stream_fused_fn(trx.QpskRxConfig(), est_lag=3)


def test_stream_split_matches_fast():
    # tests/test_qpsk_rx_stream.py:191 on the port: the split pair is the
    # fast step cut in two, the same states and symbols
    cfg = trx.QpskRxConfig()
    fast = tstream.make_stream_fast_fn(cfg)
    sym_fn, est_fn = tstream.make_stream_split_fns(cfg)
    st_f = tstream.init_state_fast(cfg, device="cpu")
    st_s = tstream.init_state_fast(cfg, device="cpu")
    rng = np.random.default_rng(11)
    n = 4096
    for b in range(3):
        x = torch.from_numpy(rng.normal(size=(2, n)).astype(np.float32))
        re, im = x[0], x[1]
        y_f, st_f = fast(st_f, re, im)
        y_s, st_s = sym_fn(st_s, re, im)
        om, lag, sh2 = est_fn(re, im)
        st_s = {**st_s, "omega": om, "lag": lag, "shift2": sh2}
        np.testing.assert_allclose(y_s.numpy(), y_f.numpy(), atol=TOL_SPLIT,
                                   rtol=TOL_SPLIT)
        assert set(st_s) == set(st_f)
        for k in st_f:
            np.testing.assert_allclose(
                st_s[k].numpy(), st_f[k].numpy(), atol=TOL_SPLIT,
                rtol=TOL_SPLIT, err_msg=f"state key {k} (blk {b})")


def test_split_serving_step_through_streamrunner():
    # tests/test_qpsk_rx_stream.py:220 on the port, at depth 2
    cfg = trx.QpskRxConfig()
    fast = tstream.make_stream_fast_fn(cfg)
    step = tstream.make_split_serving_step(cfg)
    rng = np.random.default_rng(23)
    n, S = 4096, 4
    blocks = [tuple(rng.normal(size=n).astype(np.float32) for _ in range(2))
              for _ in range(S)]
    st_f = tstream.init_state_fast(cfg, device="cpu")
    want = []
    for re, im in blocks:
        y, st_f = fast(st_f, torch.from_numpy(re), torch.from_numpy(im))
        want.append(y.numpy())
    got = []
    runner = StreamRunner(step, tstream.init_state_fast(cfg, device="cpu"),
                          blocks, sink=got.append, samples_of=lambda x: n,
                          depth=2, device="cpu")
    runner.run()
    assert len(got) == S
    for b, (w, g) in enumerate(zip(want, got)):
        np.testing.assert_allclose(g, w, atol=TOL_SPLIT, rtol=TOL_SPLIT,
                                   err_msg=f"block {b}")


def test_split_serving_step_matches_jax(signal):
    # the port's split serving step against the JAX package's on the
    # modulated waveform, at the fused test's bounds
    blocks, _ = signal
    jstep = jstream.make_split_serving_step(jrx.QpskRxConfig())
    tstep = tstream.make_split_serving_step(trx.QpskRxConfig())
    st_j = jstream.init_state_fast(jrx.QpskRxConfig())
    st_t = tstream.init_state_fast(trx.QpskRxConfig(), device="cpu")
    for b, (re, im) in enumerate(blocks):
        y_j, st_j = jstep(st_j, (jnp.asarray(re), jnp.asarray(im)))
        y_t, st_t = tstep(st_t, _torch((re, im)))
        np.testing.assert_allclose(y_t.numpy(), np.asarray(y_j),
                                   atol=TOL_SYM, rtol=TOL_SYM,
                                   err_msg=f"block {b}")
        _assert_state_close(st_t, st_j, f"block {b}")
