"""The bytes and operations of the lag-1 demod kernel's launch, counted
by hand at ``bm64_staged``'s shape, and ``demod_roofline``'s reading of a
traced segment."""

import json
from types import SimpleNamespace

import pytest

from benchlib import demod_cost, device, serve

N, K = 26_214_400, 64          # bm64_staged: a block, 64 channels


def test_lag1_demod_cost_against_hand_arithmetic():
    nbytes, flops = demod_cost.lag1_demod(n=N, k=K)
    # both planes in and d out, 4 bytes a sample each; prev in and out
    assert nbytes == 4 * (3 * N + 4 * K) == 314_573_824
    # 32 float32 operations a sample
    assert demod_cost.DEMOD_FLOPS_A_SAMPLE == 32
    assert flops == 32 * N == 838_860_800
    assert demod_cost.lag1_demod(1, 1) == (28, 32)
    # the bound is the bytes' (0.0939 ms at 3.35 TB/s)
    t, by = device.bound_s(nbytes, flops)
    assert by == "bytes"
    assert t * 1e3 == pytest.approx(0.093903, rel=1e-5)


def _run(blocks, ms, names=("lag1_demod_kernel",), launches=None):
    ops = [SimpleNamespace(short=n, seconds=ms / 1e3)
           for _ in range(blocks) for n in names]
    k8 = ("k8", dict(n=N, k=K, taps_per_branch=13, ctx=831))
    return SimpleNamespace(
        trace=SimpleNamespace(device_ops=ops, blocks=blocks),
        launches=[k8, ("k2", dict(rows=32))] if launches is None
        else launches)


def test_demod_roofline_reads_one_launch_a_block():
    bound = 314_573_824 / 3.35e12
    got = demod_cost.roofline_pct(_run(48, 0.12))
    assert got == pytest.approx(100 * bound / 0.12e-3, rel=1e-12)
    # not one launch a block, no kernel (the parent's step), no shape of
    # the channelizer, or no trace: nothing
    for run in (_run(48, 0.12, names=("lag1_demod_kernel",) * 2),
                _run(48, 0.12, names=("elementwise_kernel",)),
                _run(48, 0.12, launches=[]),
                SimpleNamespace(trace=None, launches=[])):
        assert demod_cost.roofline_pct(run) is None


def test_manifest_lists_demod_roofline_for_the_staged_cell():
    data = json.loads((serve.ROOT / "BENCHMARK.json").read_text())
    m = next(e for e in data["per_layer"] if e["name"] == "demod_roofline")
    assert m["workloads"] == ["bm64_staged"] and m["moves"] == "rx_msps"
    assert m["layer"] == next(e["layer"] for e in data["per_layer"]
                              if e["name"] == "k8_roofline")
    assert (serve.BENCH / "metrics" / "demod_roofline.py").is_file()
