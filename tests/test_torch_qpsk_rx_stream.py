"""The port's streaming QPSK receiver against the JAX package's: the fast
and fused steps over two IN_PER_STEP blocks of a modulated waveform with
CFO (the JAX fused step runs its Pallas kernel in interpret mode), a
stream continued mid-way from a JAX state, zero BER after the warm-up
block, StreamRunner against a plain loop, and the fused step's errors."""

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
# fast one (symbols, state)
TOL_SYM = 2e-3
TOL_STATE = 1e-3


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
