"""The port's spans (``runtime/metrics.named_scope``) on the CPU.

* Under ``torch.profiler`` a ``StreamRunner`` (and a
  ``BatchedStreamRunner``) of N blocks emits exactly N spans of each of
  ``stream.upload``, ``stream.step``, ``stream.d2h``, ``stream.drain``,
  ``stream.wait``, ``stream.copy`` and ``stream.sink``, the last three
  inside their ``stream.drain``, each carrying its block's sequence
  number as its argument;
* a block lent to the sink opens ``stream.lend`` inside its
  ``stream.copy`` (driven with a stand-in for a completed CUDA event);
* ``Pipeline.step`` and a compiled ``Graph`` emit their op spans, and the
  kernel wrappers their ``kernel.<module>`` spans (on the CPU around
  their plain versions);
* with no profiler recording, no ``record_function`` is entered, and the
  served outputs and states equal a profiled run's bit for bit.

No jax: the spans are the port's own.
"""

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from comms_tpu_torch import runtime as T
from comms_tpu_torch.kernels import channelizer as TCK
from comms_tpu_torch.kernels import decim_fir as TDF
from comms_tpu_torch.kernels import fft as TFFT
from comms_tpu_torch.kernels import fft_big as TFB
from comms_tpu_torch.kernels import fir as TFIR
from comms_tpu_torch.kernels import halo_ring as THR
from comms_tpu_torch.models import fm_band_monitor as tbm
from comms_tpu_torch.models import fm_receiver as tfm
from comms_tpu_torch.runtime import _tree
from comms_tpu_torch.runtime import metrics as tmet
from comms_tpu_torch.runtime.stream import BatchedStreamRunner, StreamRunner

CPU = "cpu"
RUNNER = ("stream.upload", "stream.step", "stream.d2h", "stream.drain",
          "stream.wait", "stream.copy", "stream.sink")
DRAIN_CHILDREN = ("stream.wait", "stream.copy", "stream.sink")


class _Counting(torch.profiler.record_function):
    """``record_function`` that notes every span entered, with its
    argument."""
    entered = []

    def __enter__(self):
        _Counting.entered.append((self.name, self.args))
        return super().__enter__()


@pytest.fixture
def counting(monkeypatch):
    _Counting.entered = []
    monkeypatch.setattr(torch.profiler, "record_function", _Counting)
    return _Counting.entered


def _profiled(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof.events()


def _spans(events, name):
    return sorted((e for e in events if e.name == name),
                  key=lambda e: e.time_range.start)


def _inside(child, parent) -> bool:
    return (parent.time_range.start <= child.time_range.start
            and child.time_range.end <= parent.time_range.end)


def _toy_step(state, x):
    return x * 2.0 + state, state + 1.0


def _toy_blocks(n, shape=(64,)):
    rng = np.random.default_rng(7)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _check_runner_spans(events, entered, n):
    for name in RUNNER:
        assert len(_spans(events, name)) == n, name
        # the argument is the block's sequence number, in FIFO order
        assert [a for s, a in entered if s == name] == \
            [str(i) for i in range(n)], name
    drains = _spans(events, "stream.drain")
    for name in DRAIN_CHILDREN:
        for child, drain in zip(_spans(events, name), drains):
            assert _inside(child, drain), name
    for a, b in zip(_spans(events, "stream.wait"), _spans(events,
                                                          "stream.copy")):
        assert a.time_range.end <= b.time_range.start
    for a, b in zip(_spans(events, "stream.copy"), _spans(events,
                                                          "stream.sink")):
        assert a.time_range.end <= b.time_range.start


@pytest.mark.parametrize("depth", [1, 3])
def test_stream_runner_spans(counting, depth):
    n = 5
    got = []
    r = StreamRunner(_toy_step, torch.zeros(64), iter(_toy_blocks(n)),
                     sink=got.append, depth=depth, device=CPU)
    _, events = _profiled(r.run)
    assert len(got) == n
    _check_runner_spans(events, counting, n)
    assert r.blocks_drained == n


@pytest.mark.parametrize("mode", ["unroll", "vmap"])
def test_batched_runner_spans(counting, mode):
    B, n = 3, 4
    sinks = [[] for _ in range(B)]
    r = BatchedStreamRunner(
        _toy_step, [torch.zeros(16) for _ in range(B)],
        sources=[iter(_toy_blocks(n, (16,))) for _ in range(B)],
        sinks=[s.append for s in sinks], depth=2, mode=mode, device=CPU)
    _, events = _profiled(r.run)
    assert [len(s) for s in sinks] == [n] * B
    _check_runner_spans(events, counting, n)


def test_runner_without_sink_drains_without_copy(counting):
    n = 3
    r = StreamRunner(_toy_step, torch.zeros(64), iter(_toy_blocks(n)),
                     depth=2, device=CPU)
    _, events = _profiled(r.run)
    for name in ("stream.upload", "stream.step", "stream.d2h",
                 "stream.drain", "stream.wait"):
        assert len(_spans(events, name)) == n, name
    assert not _spans(events, "stream.copy")
    assert not _spans(events, "stream.sink")


class _Done:
    def synchronize(self):
        pass


def test_lent_blocks_open_a_lend_span_inside_their_copy(counting):
    got = []
    r = StreamRunner(None, None, (), sink=got.append, depth=2, device=CPU)

    def drain_four():
        for k in range(4):
            r._drain((r._own(torch.full((4,), float(k))),), _Done())

    _, events = _profiled(drain_four)
    # got keeps every block: blocks 0 and 1 are lent, 2 and 3 copied
    copies, lends = _spans(events, "stream.copy"), _spans(events,
                                                          "stream.lend")
    assert len(copies) == 4 and len(lends) == r.blocks_lent == 2
    assert all(_inside(a, b) for a, b in zip(lends, copies))
    assert [a for s, a in counting if s == "stream.lend"] == ["0", "1"]


FM_BLOCK = 128_000      # both FirDecimate stages on K2's route


def _fm_blocks(n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, (FM_BLOCK, 2), dtype=np.uint8)
            for _ in range(n)]


def test_pipeline_op_and_kernel_spans(counting):
    pipe = tfm.make_pipeline(tfm.FmReceiverConfig(block=FM_BLOCK))
    state = pipe.init_state(device=CPU)
    x = torch.as_tensor(_fm_blocks(1)[0])
    _, events = _profiled(lambda: pipe.step(state, x))
    for name in ("0_Lambda", "1_FirDecimate", "2_FmDemod",
                 "3_FirDecimate"):
        assert len(_spans(events, name)) == 1, name
    fir = _spans(events, "kernel.decim_fir")
    assert len(fir) == 2
    assert _inside(fir[0], _spans(events, "1_FirDecimate")[0])
    assert _inside(fir[1], _spans(events, "3_FirDecimate")[0])


def test_graph_node_spans(counting):
    g = T.Graph()
    g.add_input("x")
    g.add_node("double", T.Lambda(lambda v: v * 2), ["x"])
    g.add_node("triple", T.Lambda(lambda v: v * 3), ["x"])
    g.add_node("sum", lambda a, b: a + b, ["double", "triple"])
    g.set_outputs(["sum"])
    step = g.compile()
    ((out,), _), events = _profiled(lambda: step(g.init_state(device=CPU),
                                                 {"x": torch.arange(4.0)}))
    assert torch.equal(out, torch.arange(4.0) * 5)
    for name in ("double", "triple", "sum"):
        assert len(_spans(events, name)) == 1, name


def test_staged_band_monitor_kernel_spans(counting):
    cfg = tbm.BandMonitorConfig(num_channels=16, taps_per_branch=8,
                                block=16 * 4096, audio_dec=4)
    step = tbm.make_planar_block_fn(cfg, use_kernel=True)
    state = tbm.init_state(cfg, CPU)
    rng = np.random.default_rng(1)
    re, im = (torch.as_tensor(rng.standard_normal(cfg.block)
                              .astype(np.float32)) for _ in range(2))
    _, events = _profiled(lambda: step(state, re, im))
    assert len(_spans(events, "kernel.channelizer")) == 1
    assert len(_spans(events, "kernel.decim_fir")) == 1


def _wrapper_calls():
    rng = np.random.default_rng(2)

    def planes(n):
        return (torch.as_tensor(rng.standard_normal(n).astype(np.float32)),
                torch.as_tensor(rng.standard_normal(n).astype(np.float32)))

    def decim():
        xr, xi = planes(8 * 4 * 128)
        cr, ci = TDF.decim_ctx_zero(4, CPU)
        TDF.fir_decimate_planar(xr, xi, np.ones(32), 4, cr, ci, tile_rows=8)

    def poly():
        xr, xi = planes(TDF.step_samples(4))
        L = TDF.CTX_ROWS * 4 * 128
        TDF.poly_fir_planar(xr, xi, np.ones(32), torch.zeros(L),
                            torch.zeros(L), 4)

    def fir():
        xr, xi = planes(8 * 128)
        cr, ci = TFIR.planar_ctx_zero(CPU)
        TFIR.fir_planar(xr, xi, np.ones(16), cr, ci, tile_rows=8)

    def chan():
        xr, xi = planes(TCK.step_samples())
        z = torch.zeros(TCK.CTX_SAMPLES)
        TCK.channelize_planar(xr, xi, np.ones(16 * 4), z, z.clone(), 16)

    def fft():
        xr, xi = planes(4 * 256)
        TFFT.fft_planar(xr.reshape(4, 256), xi.reshape(4, 256), n=256)

    def psd():
        n = 256
        xr, xi = planes(TFFT.rows_per_step(n) * n)
        TFFT.psd_stream_planar(xr, xi, np.hanning(n), n=n)

    def big():
        xr, xi = planes(2 * 256 * 256)
        d, _ = TFB._stage_a_d(xr.reshape(2, -1), xi.reshape(2, -1), 256,
                              256)
        TFB.fft_stage_b(d, 256, 256)

    def halo():
        rings = [[torch.arange(8.0) + 10 * k for k in range(4)]]
        THR.exchange(rings, 2)

    return {"decim_fir": (decim, 1), "decim_fir.poly": (poly, 1),
            "fir": (fir, 1), "channelizer": (chan, 1), "fft": (fft, 1),
            "fft.psd_stream": (psd, 1), "fft_big": (big, 2),
            "halo_ring": (halo, 1)}


@pytest.mark.parametrize("which", sorted(_wrapper_calls()))
def test_kernel_wrapper_spans(counting, which):
    call, spans = _wrapper_calls()[which]
    _, events = _profiled(call)
    name = "kernel." + which.split(".")[0]
    assert len(_spans(events, name)) == spans
    assert not [e for e in events if e.name.startswith("kernel.")
                and e.name != name]


def test_closed_span_is_one_shared_noop(counting):
    assert not torch._C._autograd._profiler_enabled()
    a, b = tmet.named_scope("stream.step", 3), tmet.named_scope("x")
    assert a is b
    with a:
        with b:       # shared, so it nests with itself
            pass
    assert counting == []


def test_scoped_keeps_the_function(counting):
    @tmet.scoped("kernel.example")
    def f(a, b=2):
        """doc"""
        return a + b

    assert f.__name__ == "f" and f.__doc__ == "doc"
    assert f(1, b=3) == 4
    assert counting == []
    _, events = _profiled(lambda: f(1))
    assert len(_spans(events, "kernel.example")) == 1


def _serve_fm(n):
    pipe = tfm.make_pipeline(tfm.FmReceiverConfig(block=FM_BLOCK))
    got = []
    r = StreamRunner(pipe.step, pipe.init_state(device=CPU),
                     iter(_fm_blocks(n)), sink=got.append, depth=2,
                     device=CPU)
    r.run()
    return got, r.state


def test_unprofiled_run_enters_no_span_and_equals_a_profiled_one(counting):
    n = 3
    got, state = _serve_fm(n)
    assert counting == []
    (pgot, pstate), _ = _profiled(lambda: _serve_fm(n))
    names = {s for s, _ in counting}
    assert set(RUNNER) <= names and "kernel.decim_fir" in names
    assert len(got) == len(pgot) == n
    for a, b in zip(got, pgot):
        assert np.array_equal(a, b)
    for a, b in zip(_tree.leaves(state), _tree.leaves(pstate)):
        assert torch.equal(a, b)
