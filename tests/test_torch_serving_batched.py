"""The port's BatchedStreamRunner against separate runs and against the
JAX package (mirrors tests/test_serving_batched.py): B independent
streams served a round at a time.

* ``unroll`` and ``map``: outputs and carried states bit-identical to B
  separate StreamRunner runs (FM, the QPSK stream step, the BPSK
  transmitter); FM against the JAX package's separate runs within 1e-6
  (the port's FM step against JAX's, tests/test_torch_fm_receiver.py);
* ``vmap``: within 1e-5 of separate runs (the JAX test's bound) and
  streams independent bit for bit; a step that reads a tensor's data
  pointer (as a ctypes kernel launch outside a custom op does) raises a
  ValueError; the QPSK fast step under vmap equals ``unroll`` bit for
  bit (on the card its K5 launches are custom ops with a per-slice vmap
  rule, tests/test_torch_qpsk_link_cuda.py);
* the stream's final drain is timed, and the default sample count is B
  times the block."""

import time

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch

from comms_tpu.models import fm_receiver as jfm
from comms_tpu_torch.models import bpsk_tx as tbt
from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.models import qpsk_rx as trx
from comms_tpu_torch.models import qpsk_rx_stream as tqs
from comms_tpu_torch.models import qpsk_tx as tqt
from comms_tpu_torch.ops import random as trand
from comms_tpu_torch.runtime import _tree
from comms_tpu_torch.runtime.stream import BatchedStreamRunner, StreamRunner

CPU = "cpu"


def _fm_inputs(B, block, nblocks, seed=0):
    rng = np.random.RandomState(seed)
    return rng.randint(0, 256, (B, nblocks, block, 2)).astype(np.uint8)


def _run_separately(blk, states, xs):
    """Oracle: B independent StreamRunner streams."""
    outs, finals = [], []
    for b in range(len(states)):
        got = []
        r = StreamRunner(blk, states[b], list(xs[b]), sink=got.append,
                         device=CPU)
        r.run()
        outs.append(got)
        finals.append(r.state)
    return outs, finals


def _leaves_equal(a, b):
    for x, y in zip(_tree.leaves(a), _tree.leaves(b)):
        x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
        y = y.numpy() if isinstance(y, torch.Tensor) else np.asarray(y)
        assert np.array_equal(x, y)


@pytest.mark.parametrize("mode", ["unroll", "map"])
def test_batched_fm_bitexact_vs_separate_runs(mode):
    B, nblk = 3, 3
    cfg = tfm.FmReceiverConfig(block=25 * 64)
    blk = tfm.make_block_fn(cfg)
    xs = _fm_inputs(B, cfg.block, nblk, seed=3)
    want, want_states = _run_separately(
        blk, [tfm.init_state(cfg, CPU) for _ in range(B)], xs)
    sinks_out = [[] for _ in range(B)]
    runner = BatchedStreamRunner(
        blk, [tfm.init_state(cfg, CPU) for _ in range(B)],
        sources=[list(xs[b]) for b in range(B)],
        sinks=[sinks_out[b].append for b in range(B)],
        depth=2, mode=mode, device=CPU)
    runner.run()
    jcfg = jfm.FmReceiverConfig(block=25 * 64)
    jblk = jax.jit(jfm.make_block_fn(jcfg))
    for b in range(B):
        assert len(sinks_out[b]) == nblk
        js = jfm.init_state(jcfg)
        for k in range(nblk):
            np.testing.assert_array_equal(sinks_out[b][k], want[b][k])
            ja, js = jblk(js, jnp.asarray(xs[b, k]))
            np.testing.assert_allclose(sinks_out[b][k], np.asarray(ja),
                                       atol=1e-6, rtol=0)
    for b, st in enumerate(runner.stream_states()):
        _leaves_equal(st, want_states[b])


def test_batched_fm_vmap_close_and_streams_independent():
    B, nblk = 3, 2
    cfg = tfm.FmReceiverConfig(block=25 * 64)
    blk = tfm.make_block_fn(cfg)
    xs = _fm_inputs(B, cfg.block, nblk, seed=5)
    want, want_states = _run_separately(
        blk, [tfm.init_state(cfg, CPU) for _ in range(B)], xs)

    def run_batched(xs_in):
        sinks_out = [[] for _ in range(B)]
        r = BatchedStreamRunner(
            blk, [tfm.init_state(cfg, CPU) for _ in range(B)],
            sources=[list(xs_in[b]) for b in range(B)],
            sinks=[sinks_out[b].append for b in range(B)], mode="vmap",
            device=CPU)
        r.run()
        return sinks_out, r.stream_states()

    got, states = run_batched(xs)
    for b in range(B):
        for k in range(nblk):
            np.testing.assert_allclose(got[b][k], want[b][k], atol=1e-5,
                                       rtol=1e-5)
        for x, y in zip(_tree.leaves(states[b]),
                        _tree.leaves(want_states[b])):
            assert torch.allclose(x, y, atol=1e-5, rtol=1e-5)
    xs2 = xs.copy()
    xs2[2] = xs2[2][:, ::-1]
    got2, _ = run_batched(xs2)
    for b in (0, 1):
        for k in range(nblk):
            np.testing.assert_array_equal(got2[b][k], got[b][k])


def test_vmap_refuses_what_it_cannot_trace():
    def step(state, x):
        x.data_ptr()            # what a ctypes kernel launch reads
        return x * 2, state

    r = BatchedStreamRunner(step, [torch.zeros(1)] * 2,
                            batched_source=[torch.ones(2, 8)], mode="vmap",
                            device=CPU)
    with pytest.raises(ValueError, match="vmap"):
        r.run()
    with pytest.raises(ValueError, match="tensor"):
        BatchedStreamRunner(lambda s, x: (x, s), [(0, 1)] * 2,
                            batched_source=[], mode="vmap", device=CPU)
    with pytest.raises(ValueError, match="mode"):
        BatchedStreamRunner(lambda s, x: (x, s), [()], batched_source=[],
                            mode="scan", device=CPU)


def _qpsk_stream(seed, cfo, phi, nbits=16384):
    """A continuous qpsk_tx waveform with its ground-truth bits."""
    tcfg = tqt.QpskTxConfig(bits_per_block=nbits, dphase=0.0)
    iq, _ = tqt.make_block_fn(tcfg)(tqt.init_state(tcfg, seed, CPU))
    z = iq.numpy().astype(np.float32) / tcfg.scale
    x = (z[:, 0] + 1j * z[:, 1]).astype(np.complex128)
    bits, _ = trand.random_bits_block(trand.source_init(seed, CPU), nbits)
    n = np.arange(len(x))
    xc = (x * np.exp(1j * (cfo * n + phi))).astype(np.complex64)
    return xc, bits.numpy()


def test_batched_qpsk_fast_matches_separate_and_decodes():
    """The estimate-pipelined QPSK step lifted over 2 streams with
    different carrier offsets: per-stream outputs equal separate runs
    bit for bit, and both streams decode with zero bit errors after
    warm-up (the JAX test's decode check)."""
    Bs, nblk = 2, 4
    streams = [_qpsk_stream(3, 0.006, 0.8), _qpsk_stream(7, -0.004, 2.1)]
    cfg = trx.QpskRxConfig()
    step = tqs.make_stream_fast_fn(cfg)

    def wrapped(state, x):
        return step(state, x[0], x[1])

    N = len(streams[0][0]) // nblk
    M = N // cfg.sps
    srcs = [[(seg.real.astype(np.float32), seg.imag.astype(np.float32))
             for seg in (xc[b * N:(b + 1) * N] for b in range(nblk))]
            for xc, _ in streams]
    want, _ = _run_separately(
        wrapped, [tqs.init_state_fast(cfg, CPU) for _ in range(Bs)], srcs)
    sinks_out = [[] for _ in range(Bs)]
    BatchedStreamRunner(
        wrapped, [tqs.init_state_fast(cfg, CPU) for _ in range(Bs)],
        sources=srcs, sinks=[sinks_out[b].append for b in range(Bs)],
        depth=2, mode="unroll", device=CPU).run()
    for s in range(Bs):
        assert len(sinks_out[s]) == nblk
        for b in range(nblk):
            np.testing.assert_array_equal(sinks_out[s][b], want[s][b])
    for s, (_xc, bits) in enumerate(streams):
        sym_all = np.concatenate(sinks_out[s][1:], axis=1)
        margin = 32
        cand = sym_all[:, margin:]
        ref = bits[2 * (M + margin - 8):]
        (rot, lag), errs, m = trx.resolve_ambiguity(
            cand[0] + 1j * cand[1], ref, search=1500, max_lag=16)
        assert m >= 2048 and errs == 0, (s, rot, lag, errs, m)


def test_batched_qpsk_fast_vmap_equals_unroll():
    # 2 streams of 4 blocks of 4096 samples: vmap lifts the fast step
    # (plain PyTorch on the CPU) and gives unroll's outputs and states
    Bs, nblk = 2, 4
    streams = [_qpsk_stream(3, 0.006, 0.8, 8192),
               _qpsk_stream(7, -0.004, 2.1, 8192)]
    cfg = trx.QpskRxConfig()
    step = tqs.make_stream_fast_fn(cfg)

    def wrapped(state, x):
        return step(state, x[0], x[1])

    N = len(streams[0][0]) // nblk
    srcs = [[(seg.real.astype(np.float32), seg.imag.astype(np.float32))
             for seg in (xc[b * N:(b + 1) * N] for b in range(nblk))]
            for xc, _ in streams]
    got = {}
    for mode in ("unroll", "vmap"):
        outs = [[] for _ in range(Bs)]
        r = BatchedStreamRunner(
            wrapped, [tqs.init_state_fast(cfg, CPU) for _ in range(Bs)],
            sources=srcs, sinks=[outs[b].append for b in range(Bs)],
            depth=2, mode=mode, device=CPU)
        r.run()
        got[mode] = (outs, r.stream_states())
    for s in range(Bs):
        for b in range(nblk):
            np.testing.assert_array_equal(got["vmap"][0][s][b],
                                          got["unroll"][0][s][b])
        _leaves_equal(got["vmap"][1][s], got["unroll"][1][s])


@pytest.mark.parametrize("mode", ["unroll", "vmap"])
def test_batched_transmitter(mode):
    # Two transmitters with other seeds: bit-equal to separate runs in
    # both modes (the step's integer and exact-product paths).
    cfg = tbt.BpskTxConfig(syms_per_block=256)
    blk = tbt.make_block_fn(cfg)

    def step(state, _placeholder):
        return blk(state)

    seeds = (0, 5)
    want = []
    for sd in seeds:
        st, got = tbt.init_state(cfg, sd, CPU), []
        for _ in range(3):
            iq, st = blk(st)
            got.append(iq.numpy())
        want.append(got)
    outs = [[] for _ in seeds]
    BatchedStreamRunner(step, [tbt.init_state(cfg, sd, CPU) for sd in seeds],
                        batched_source=[torch.zeros(2, 1)] * 3,
                        sinks=[o.append for o in outs], mode=mode,
                        device=CPU).run()
    for b in range(len(seeds)):
        for k in range(3):
            np.testing.assert_array_equal(outs[b][k], want[b][k])


def test_batched_source_prestacked_and_default_sample_count():
    B, nblk = 4, 3
    cfg = tfm.FmReceiverConfig(block=25 * 16)
    blk = tfm.make_block_fn(cfg)
    xs = _fm_inputs(B, cfg.block, nblk, seed=9)
    batched = [torch.from_numpy(xs[:, k]) for k in range(nblk)]
    runner = BatchedStreamRunner(
        blk, [tfm.init_state(cfg, CPU) for _ in range(B)],
        batched_source=batched, mode="unroll", device=CPU)
    meter = runner.run()
    assert runner.blocks_done == nblk
    assert meter.samples == B * nblk * cfg.block


def test_batched_runner_times_the_final_drain():
    # The reference's meter stops at the last dispatch; the port's
    # StreamRunner (and so this subclass) times the final drain too.
    delay = 0.02
    runner = BatchedStreamRunner(
        lambda s, x: (x, s), [None, None],
        sources=[[np.zeros(4, np.float32)] * 5] * 2,
        sinks=[lambda y: time.sleep(delay), lambda y: None], depth=4,
        device=CPU)
    meter = runner.run()
    assert meter.blocks == 5 and meter.samples == 40
    assert meter.seconds >= 5 * delay
