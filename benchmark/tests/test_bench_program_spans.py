"""The readers of the program's own spans (``benchlib/spans.py``) on
events made by hand: each gives its value where the spans are, and None
where the trace holds none of them (a program without the spans) or no
device operation (a CPU run)."""

import pytest

from benchlib import serve, trace
from benchlib.trace import Op, TraceView

SPAN_METRICS = ("sink_copy_ms", "sink_wait_ms", "wrapper_host_ms",
                "idle_sink_pct", "idle_enqueue_pct")


def _view(spans=True, device=True):
    dev = [Op("void decim_fir_kernel<5, false>(x)", 10, 20),
           Op("void at::native::elementwise_kernel<1>(y)", 15, 30),
           Op("Memcpy DtoH (Device -> Pinned)", 50, 60),
           Op("void channelize_kernel<64>(z)", 60, 70)] if device else []
    host = [Op(trace.WINDOW, 0, 100), Op("bench.drain", 27, 91),
            Op("cudaEventSynchronize", 31, 48)]
    if spans:
        host += [Op("stream.step", 5, 25),
                 Op("kernel.channelizer", 8, 12),
                 Op("kernel.decim_fir", 11, 14),
                 Op("stream.d2h", 25, 27),
                 Op("stream.drain", 28, 90),
                 Op("stream.wait", 29, 49),
                 Op("kernel.halo_ring", 20, 21),
                 Op("stream.copy", 50, 80),
                 Op("stream.sink", 80, 89)]
    return TraceView(2, host[0], dev, host,
                     frozenset({"decim_fir_kernel", "channelize_kernel"}))


def _run(view):
    return serve.RunView(samples_per_block=1000, setup_s=3.0, window_s=2.0,
                         delivered=10, latencies_s=[0.001], dispatch_s=[0.001],
                         launches=[], trace=view)


def _read(name, run):
    return serve.Manifest().reader(name).read(run)


def test_readers_on_the_spans():
    run = _run(_view())
    assert _read("sink_copy_ms", run) == pytest.approx(30e-3 / 2)
    assert _read("sink_wait_ms", run) == pytest.approx(20e-3 / 2)
    # 8..14 once, however the two wrappers overlap, and 20..21
    assert _read("wrapper_host_ms", run) == pytest.approx(7e-3 / 2)
    # idle 30..50 and 70..90 inside the drain, 5..10 inside the step
    assert _read("idle_sink_pct", run) == pytest.approx(40.0)
    assert _read("idle_enqueue_pct", run) == pytest.approx(5.0)


def test_the_named_idle_fits_inside_the_idle_share():
    run = _run(_view())
    idle = _read("idle_pct", run)
    assert idle == pytest.approx(60.0)
    assert (_read("idle_sink_pct", run) + _read("idle_enqueue_pct", run)
            <= idle)


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_no_spans_no_reading(name):
    assert _read(name, _run(_view(spans=False))) is None
    assert _read(name, _run(None)) is None
    # a CPU run's trace: spans, but no device operation to pair them with
    assert _read(name, _run(_view(device=False))) is None


def test_gaps_named_by_the_program_spans():
    gaps = trace.breakdown(_view())["idle_gaps"]
    names = [n for n, _ in gaps]
    assert names[0] == "stream.sink"                       # 80..100's middle
    assert "cudaEventSynchronize" in names                  # inside the wait
    assert "bench.drain" not in names


@pytest.mark.parametrize("name", SPAN_METRICS)
def test_manifest_entry(name):
    m = serve.Manifest()
    spec = [e for e in m.data["per_layer"] if e["name"] == name]
    assert len(spec) == 1
    spec = spec[0]
    assert spec["source"] == "program_span" and spec["better"] == "lower"
    assert spec["moves"] == "rx_msps" and "workloads" not in spec
    assert all(spec in m.per_layer(w["name"]) for w in m.data["workloads"])
