"""The QPSK Costas gateway (the benchmark's ``qpsk_costas_gateway``) on
the CPU at a small size: the Costas-loop receiver lifted over the
carriers by ``runtime.stream.lift(mode="vmap")``, served through the
benchmark's own run against its float64 reference; the lifted step
against ``BatchedStreamRunner(mode="vmap")``; a round's operations, its
one Costas op and its spans, whatever the number of carriers; the
reference's settled orbit; three broken steps the check refuses; and
the reference's imports."""

import collections
import subprocess
import sys
import time
import warnings
from pathlib import Path

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from comms_tpu_torch.models import qpsk_rx_stream as rx
from comms_tpu_torch.runtime import BatchedStreamRunner
from comms_tpu_torch.runtime.stream import lift

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT / "benchmark") not in sys.path:
    sys.path.insert(0, str(ROOT / "benchmark"))

from benchlib import serve  # noqa: E402

CELL = "costas_gateway_b4096"
SEED = 2 ** 33 + 7
B, N = 3, 2048
STAGES = ("carrier", "mf", "timing", "interp", "costas")


def _sizes(streams=B, n=N):
    cfg = serve.Manifest().config("qpsk_costas_gateway")
    return {"streams": streams, "block_samples": n,
            "input": dict(cfg["input"], carrier_samples=n)}


class _Settled(serve.Manifest):
    """The cell's traffic with a warm-up as long as the reference's
    settling run: every carrier's state is then on its settled orbit
    before the window, as it is on the card after thousands of rounds."""

    def traffic(self, name):
        tr = super().traffic(name)
        cfg = self.config("qpsk_costas_gateway")
        return dict(tr, warmup_blocks=cfg["check"]["settle_blocks"]
                    + tr["ring_blocks"])


def _run(fault=None, seconds=0.2):
    return serve.run_cell(CELL, SEED, seconds, False, t0=time.perf_counter(),
                          manifest=_Settled(), device="cpu", sizes=_sizes(),
                          fault=fault)


def _cell(streams=B, n=N, seed=SEED):
    return serve.cell(serve.Manifest(), CELL, seed, torch.device("cpu"),
                      _sizes(streams, n))


def _stale_state(step):
    def run(state, x):
        y, _ = step(state, x)
        return y, state
    return run


def _swapped_carriers(step):
    """Carriers 0 and 1 handed each other's symbols."""
    def run(state, x):
        y, s = step(state, x)
        return y[[1, 0, *range(2, y.shape[0])]], s
    return run


def _altered_answer(step):
    def run(state, x):
        y, s = step(state, x)
        y = y.clone()
        flat = y.view(-1)
        flat[flat.numel() // 3] += 0.01 * float(flat.abs().max())
        return y, s
    return run


def test_served_cell_is_correct_on_the_cpu():
    result, compared = _run()
    assert result["correct"], compared
    assert result["failed"] == 0 and result["attempted"] >= 1
    assert compared["lost_blocks"]["value"] == 0
    assert set(result["metrics"]) == {"rx_msps", "block_p95_ms", "setup_s"}


@pytest.mark.parametrize("fault", [_stale_state, _swapped_carriers,
                                   _altered_answer])
def test_a_broken_step_is_not_correct(fault):
    result, compared = _run(fault=fault)
    assert not result["correct"], compared
    assert compared["max_rel_err"]["value"] > \
        compared["max_rel_err"]["limit"]


def _rounds(n=1024, streams=3, rounds=3):
    g = torch.Generator().manual_seed(5)
    return [torch.randn((streams, n, 2), generator=g) * 0.3
            for _ in range(rounds)]


def test_lifted_step_equals_the_batched_runner_bit_for_bit():
    cfg = rx.QpskRxStreamConfig(block=1024)
    xs = _rounds()
    states = [rx.init_state(cfg, "cpu") for _ in range(3)]
    step, state = lift(rx.make_stream_fn(cfg), states, mode="vmap")
    want = []
    for x in xs:
        y, state = step(state, x)
        want.append(y.numpy())
    got = []
    runner = BatchedStreamRunner(
        rx.make_stream_fn(cfg), [rx.init_state(cfg, "cpu") for _ in range(3)],
        batched_source=xs, mode="vmap", device="cpu")
    runner.sink = lambda y: got.append(y.copy())
    runner.run()
    assert len(got) == len(want)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    leaves = torch.utils._pytree.tree_leaves
    for u, v in zip(leaves(runner.state), leaves(state), strict=True):
        assert torch.equal(u, v)


class _Ops(TorchDispatchMode):
    def __init__(self):
        super().__init__()
        self.ops = collections.Counter()
        self.costas = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.ops[str(func)] += 1
        if "costas_loop" in str(func):
            self.costas.append(tuple(args[0].shape))
        return func(*args, **(kwargs or {}))


def _one_round(streams):
    """A vmapped round at ``streams`` carriers after a first one: its
    operations, its Costas ops' plane shapes and any warning of vmap's
    per-slice fallback."""
    cfg = rx.QpskRxStreamConfig(block=1024)
    step, state = lift(rx.make_stream_fn(cfg),
                       [rx.init_state(cfg, "cpu") for _ in range(streams)],
                       mode="vmap")
    x = _rounds(streams=streams, rounds=1)[0]
    _, state = step(state, x)
    torch._C._functorch._set_vmap_fallback_warning_enabled(True)
    try:
        with warnings.catch_warnings(record=True) as caught, _Ops() as mode:
            warnings.simplefilter("always")
            step(state, x)
    finally:
        torch._C._functorch._set_vmap_fallback_warning_enabled(False)
    return mode, [str(w.message) for w in caught]


def test_a_round_is_the_same_operations_at_any_number_of_carriers():
    two, eight = _one_round(2), _one_round(8)
    assert two[0].ops == eight[0].ops
    assert not two[1] and not eight[1]


@pytest.mark.parametrize("streams", [2, 8])
def test_one_costas_op_a_round_carries_every_carrier(streams):
    # one op whose planes hold every carrier as a lane: on the card that
    # op is one launch (the ``cuda`` test counts it there)
    mode, _ = _one_round(streams)
    assert mode.costas == [(streams, 256)]


def test_stage_spans_open_once_a_round_inside_vmap():
    from torch.profiler import ProfilerActivity, profile

    cfg = rx.QpskRxStreamConfig(block=1024)
    step, state = lift(rx.make_stream_fn(cfg),
                       [rx.init_state(cfg, "cpu") for _ in range(4)],
                       mode="vmap")
    xs = _rounds(streams=4, rounds=2)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        for x in xs:
            _, state = step(state, x)
    names = collections.Counter(e.name for e in prof.events()
                                if e.name.startswith("qpsk_costas."))
    assert names == {f"qpsk_costas.{s}": 2 for s in STAGES}


def test_reference_settles_onto_one_orbit_over_the_ring_period():
    c = _cell()
    ref = serve.Manifest().reference("qpsk_costas_gateway")
    R_ = c.traffic["ring_blocks"]
    out = ref.settled(c.ring, c.cfg, "float64", periods=2)
    limit = c.cfg["check"]["max_rel_err"]
    for j in range(R_):
        assert out[j].shape == (B, N // 4, 2)
        assert serve.rel_err(out[j + R_], out[j]) < limit / 10


def test_reference_imports_nothing_of_the_program_or_of_jax():
    code = (
        "import sys; sys.path[:0] = ['benchmark']\n"
        "import importlib.util as u\n"
        "s = u.spec_from_file_location('ref', "
        "'benchmark/configs/qpsk_costas_gateway.py')\n"
        "m = u.module_from_spec(s); s.loader.exec_module(m)\n"
        "print(sorted(k for k in sys.modules if k.split('.')[0] in "
        "('jax', 'jaxlib', 'flax', 'comms_tpu', 'comms_tpu_torch')))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"
