"""A run of each cell on the CPU at tiny sizes, the served step broken
underneath in each way the cells can break, and the imports a run
makes.  The harness's look for a card is skipped (``device="cpu"``);
the rest of the run is the benchmark's own."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchlib import serve

SIZES = {"bm64_staged": {"block_samples": 20480},
         "fm_pipeline": {"block_samples": 51200}}
SEED = 2 ** 31 + 99


def _run(workload, fault=None, trace=False, seconds=0.3, **kw):
    return serve.run_cell(workload, SEED, seconds, trace,
                          t0=time.perf_counter(), device="cpu",
                          sizes=SIZES[workload], fault=fault, **kw)


def _stale_state(step):
    """A step that returns its state unchanged."""
    def run(state, x):
        y, _ = step(state, x)
        return y, state
    return run


def _half_batch(step):
    """Half of each block's outputs left out, the mean of the rest in
    their place."""
    def run(state, x):
        y, s = step(state, x)
        h = y.shape[-1] // 2
        y = y.clone()
        y[..., h:] = y[..., :h].mean(-1, keepdim=True)
        return y, s
    return run


def _altered_answer(step):
    """One output sample altered where it is produced."""
    def run(state, x):
        y, s = step(state, x)
        y = y.clone()
        flat = y.view(-1)
        flat[flat.numel() // 3] += 0.01 * float(flat.abs().max())
        return y, s
    return run


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_cell_runs_correct_on_the_cpu(workload):
    result, compared = _run(workload)
    assert result["correct"], compared
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert set(result["metrics"]) == {"rx_msps", "block_p95_ms", "setup_s"}
    assert list(result)[-1] == "compared"
    assert compared["max_rel_err"]["value"] <= compared["max_rel_err"]["limit"]


@pytest.mark.parametrize("fault", [_stale_state, _half_batch,
                                   _altered_answer])
@pytest.mark.parametrize("workload", sorted(SIZES))
def test_a_broken_step_is_not_correct(workload, fault):
    result, compared = _run(workload, fault=fault)
    assert not result["correct"], compared
    assert result["failed"] >= 1


@pytest.mark.parametrize("workload", sorted(SIZES))
def test_traced_run_reports_per_layer_metrics(workload):
    result, _ = _run(workload, trace=True)
    assert result["correct"]
    # on the CPU the trace holds no device operation: only the host's
    # dispatch time has something to read
    assert set(result["metrics"]) == {"dispatch_ms"}
    assert result["device"]["window_s"] > 0
    assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}


def test_run_without_a_card_exits_without_a_result():
    r = subprocess.run(
        [sys.executable, str(serve.BENCH / "run.py"), "--workload",
         "fm_pipeline", "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=serve.ROOT)
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    assert r.returncode != 0
    assert r.stdout.strip() == ""
    assert "no CUDA device" in r.stderr


def test_a_run_loads_no_jax_module():
    code = (
        "import sys, time, json; sys.path[:0] = [%r, %r]\n"
        "from benchlib import serve\n"
        "for wl, sz in %r.items():\n"
        "    r, _ = serve.run_cell(wl, 5, 0.2, True, t0=time.perf_counter(),"
        " device='cpu', sizes=sz)\n"
        "print(json.dumps(serve.forbidden_modules()))\n"
        "print(json.dumps(sorted(k for k in sys.modules"
        " if k.split('.')[0] == 'comms_tpu_torch')[:3]))\n"
    ) % (str(serve.BENCH), str(serve.ROOT), SIZES)
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=600)
    assert r.returncode == 0, r.stderr[-2000:]
    bad, port = (json.loads(x) for x in r.stdout.strip().splitlines()[-2:])
    assert bad == []
    assert port            # the program was loaded: its name is not JAX's


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "comms_tpu_torch_fake", object())
    monkeypatch.setitem(sys.modules, "jaxish.sub", object())
    assert serve.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "comms_tpu.sub", object())
    assert serve.forbidden_modules() == ["comms_tpu.sub"]
