"""The trace reduction and the per-layer readers on events made by
hand."""

import pytest

from benchlib import serve, trace
from benchlib.trace import Op, TraceView


def test_short_names():
    assert trace.short_name(
        "void (anonymous namespace)::decim_fir_kernel<4, false>(float const*"
        ", float const*)") == "decim_fir_kernel"
    assert trace.short_name(
        "void at::native::vectorized_elementwise_kernel<4, at::native::"
        "CUDAFunctor_add<float>>(int, ...)") == "vectorized_elementwise_kernel"
    assert trace.short_name("Memcpy DtoH (Device -> Pinned)") == "Memcpy DtoH"


def test_port_kernel_names_from_the_sources():
    names = trace.port_kernel_names(serve.ROOT)
    assert {"decim_fir_kernel", "channelize_kernel",
            "halo_ring_floor_kernel", "stage_b_reduce_kernel"} <= names
    assert "__launch_bounds__" not in names


def _view():
    dev = [Op("void decim_fir_kernel<4, false>(x)", 10, 20),
           Op("void at::native::elementwise_kernel<1>(y)", 15, 30),
           Op("Memcpy DtoH (Device -> Pinned)", 50, 60),
           Op("void channelize_kernel<64>(z)", 60, 70)]
    host = [Op(trace.WINDOW, 0, 100), Op("bench.drain", 28, 90),
            Op("cudaEventSynchronize", 31, 49)]
    return TraceView(2, host[0], dev, host,
                     frozenset({"decim_fir_kernel", "channelize_kernel"}))


def test_busy_counts_overlaps_once():
    v = _view()
    assert v.busy_s == pytest.approx(40e-6)
    assert v.window_s == pytest.approx(100e-6)


def test_breakdown_names_gaps_by_the_innermost_host_span():
    b = trace.breakdown(_view())
    assert b["device_ops"][0] == ["elementwise_kernel", pytest.approx(15e-6)]
    gaps = b["idle_gaps"]
    assert gaps[0] == ["bench.drain", pytest.approx(30e-6)]        # 70..100
    assert ["cudaEventSynchronize", pytest.approx(20e-6)] in gaps  # 30..50
    assert [trace.WINDOW, pytest.approx(10e-6)] in gaps            # 0..10


def test_readers():
    run = serve.RunView(samples_per_block=1000, setup_s=3.0, window_s=2.0,
                        delivered=10, latencies_s=[0.001 * i for i in
                                                   range(1, 101)],
                        dispatch_s=[0.001, 0.003],
                        launches=[("k2", dict(rows=1, n=5120, dec=5, taps=63,
                                              planes=2, ctx=64))],
                        trace=_view())
    m = serve.Manifest()

    def read(name):
        return m.reader(name).read(run)

    assert read("rx_msps") == pytest.approx(10 * 1000 / 2.0 / 1e6)
    assert read("block_p95_ms") == pytest.approx(95.05)
    assert read("setup_s") == 3.0
    assert read("dispatch_ms") == pytest.approx(2.0)
    assert read("step_device_ms") == pytest.approx(1e3 * 45e-6 / 2)
    assert read("torch_ops_ms") == pytest.approx(1e3 * 25e-6 / 2)
    assert read("idle_pct") == pytest.approx(60.0)
    # one K2 event for two blocks of one launch each: no reading
    assert read("k2_roofline") is None
    run.trace.blocks = 1
    from benchlib import device, kernels
    bound = device.bound_s(*kernels.cost("k2", run.launches[0][1]))[0]
    assert read("k2_roofline") == pytest.approx(100 * bound / 10e-6)
    assert read("k8_roofline") is None     # no K8 launch listed
