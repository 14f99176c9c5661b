"""One run of one cell: set-up, the measured window, the traced segment,
the comparison with the plain reference, and the result.

Everything that belongs to one configuration, traffic mix, served path,
capture or metric is a file of its own, found by name:

    BENCHMARK.json                   cells and metrics
    benchmark/configs/<config>.json  sizes, input, limits; its plain
    benchmark/configs/<config>.py      reference beside it
    benchmark/traffic/<traffic>.json the mix: path, ring, depth
    benchmark/paths/<path>.py        the served path (the program)
    benchmark/captures/<capture>.py  the input generator
    benchmark/metrics/<metric>.py    a metric's reader

Block g is ring block g mod R of a ring in device memory, where the
capture was made (as a GPUDirect digitizer leaves it).

The window: blocks are handed to ``runtime/stream.StreamRunner`` until
``seconds`` have passed since the first hand-off, then the runner drains
what is in flight; the window ends when the last block reaches the sink.
A block's latency runs from its hand-off to its delivery to the sink.
"""

from __future__ import annotations

import dataclasses
import hashlib
import importlib.util
import json
import sys
import time
import warnings
from collections import deque
from pathlib import Path

import numpy as np
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "comms_tpu")


class NoCard(RuntimeError):
    pass


def forbidden_modules() -> list:
    """Loaded modules whose whole top-level name is one of FORBIDDEN."""
    return sorted(m for m in sys.modules if m.split(".")[0] in FORBIDDEN)


def _module(path: Path):
    """The module in ``path``, loaded once per file."""
    path = path.resolve()
    name = (f"bench_{path.parent.name}_{path.stem}_"
            f"{hashlib.sha1(str(path).encode()).hexdigest()[:8]}")
    if name in sys.modules:
        return sys.modules[name]
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


class Manifest:
    """``BENCHMARK.json`` and the files it names, found by name."""

    def __init__(self, root: Path = ROOT):
        self.root = Path(root)
        self.bench = self.root / "benchmark"
        self.data = json.loads((self.root / "BENCHMARK.json").read_text())

    def _named(self, key: str, name: str) -> dict:
        for e in self.data[key]:
            if e["name"] == name:
                return e
        raise KeyError(f"{key} has no entry {name!r}")

    def workload(self, name: str) -> dict:
        return self._named("workloads", name)

    def config(self, name: str) -> dict:
        return json.loads((self.root / self._named("configs", name)["file"])
                          .read_text())

    def reference(self, name: str):
        file = self.root / self._named("configs", name)["file"]
        return _module(file.with_suffix(".py"))

    def traffic(self, name: str) -> dict:
        return json.loads((self.bench / "traffic" / f"{name}.json")
                          .read_text())

    def path(self, name: str):
        return _module(self.bench / "paths" / f"{name}.py")

    def capture(self, name: str):
        return _module(self.bench / "captures" / f"{name}.py")

    def reader(self, name: str):
        return _module(self.bench / "metrics" / f"{name}.py")

    def end_to_end(self) -> list:
        return self.data["end_to_end"]

    def per_layer(self, workload: str) -> list:
        """The per-layer metrics that list ``workload``, and those that
        list no cell (every cell reports them)."""
        return [m for m in self.data["per_layer"]
                if workload in m.get("workloads", [workload])]


@dataclasses.dataclass
class RunView:
    """What the metric readers read of a run."""
    samples_per_block: int
    setup_s: float
    window_s: float
    delivered: int
    latencies_s: list
    dispatch_s: list
    launches: list
    trace: object = None       # trace.TraceView of the traced segment


class _Window:
    """Hand-off and delivery times of a run of blocks, and the outputs
    the check keeps: the last ``keep`` of the blocks picked by the seed
    (every ``stride``-th, from an offset drawn from it) and the last."""

    def __init__(self, item, start: int, seconds=None, blocks=None,
                 keep: int = 0, stride: int = 1, offset: int = 0):
        self.item, self.start = item, start
        self.seconds, self.blocks = seconds, blocks
        self.handoff, self.delivery = [], []
        self.picked = deque(maxlen=max(keep - 1, 0))
        self.last = None
        self.stride, self.offset, self.keep = stride, offset, keep

    def source(self):
        g = self.start
        while True:
            now = time.perf_counter()
            if self.blocks is not None and g - self.start >= self.blocks:
                return
            if (self.seconds is not None and self.handoff
                    and now - self.handoff[0] >= self.seconds):
                return
            self.handoff.append(now)
            yield self.item(g)
            g += 1

    def sink(self, y):
        self.delivery.append(time.perf_counter())
        if self.keep:
            g = self.start + len(self.delivery) - 1
            if (g + self.offset) % self.stride == 0:
                self.picked.append((g, y))
            self.last = (g, y)

    def kept(self) -> dict:
        out = dict(self.picked)
        if self.last is not None:
            out[self.last[0]] = self.last[1]
        return out


def _timed(step, out: list):
    def run(state, x):
        t = time.perf_counter()
        r = step(state, x)
        out.append(time.perf_counter() - t)
        return r
    return run


def _serve(runner_cls, step, state, window, depth, samples, device):
    runner = runner_cls(step, state, window.source(), sink=window.sink,
                        samples_of=lambda x: samples, depth=depth,
                        device=device)
    runner.run()
    return runner.state


def rel_err(got, want) -> float:
    """max |got - want| / max |want|, in float64."""
    w = want.to(torch.float64)
    g = torch.as_tensor(got).to(w.device, torch.float64)
    return float((g - w).abs().max() / w.abs().max())


def compare(reference, ring: dict, cfg: dict, kept: dict,
            prec: str = "float64") -> float:
    """The worst ``rel_err`` of the kept outputs against the reference
    in ``prec``, block by block."""
    return max(rel_err(y, reference.block_output(ring, g, cfg, prec))
               for g, y in kept.items())


@dataclasses.dataclass
class Cell:
    """A cell made ready to serve: its entries and files, the served
    path on the device, and the input ring made from the seed."""
    workload: dict
    cfg: dict
    traffic: dict
    served: object
    ring: dict
    item: object          # item(g): the input of global block g


def cell(m: Manifest, workload: str, seed: int, device,
         sizes: dict = None) -> Cell:
    """Look the cell up by name, build its served path on ``device``
    (the library is loaded, or built in a checkout's first run) and make
    its ring from ``seed``.  ``sizes`` overrides configuration keys."""
    w = m.workload(workload)
    cfg = m.config(w["config"])
    cfg.update(sizes or {})
    tr = m.traffic(w["traffic"])
    served = m.path(tr["path"]).Served(cfg, device)
    R = tr["ring_blocks"]
    ring = m.capture(cfg["input"]["capture"]).make(
        cfg["input"], R, served.samples, int(seed) % 2 ** 63, device)
    return Cell(w, cfg, tr, served, ring,
                lambda g: served.item(ring, g % R))


def run_cell(workload: str, seed: int, seconds: float, trace: bool, *,
             t0: float, manifest: Manifest = None, device=None,
             sizes: dict = None, fault=None) -> tuple:
    """One run; returns ``(result, compared)``: the result line's
    object and the numbers compared, each with its limit.

    ``device`` None takes the card and raises NoCard where there is
    none, or fewer than the cell asks for; tests pass the CPU.
    ``sizes`` overrides configuration keys (tests run tiny blocks);
    ``fault`` wraps the served step (tests break it on purpose)."""
    m = manifest or Manifest()
    chips = m.workload(workload)["chips"]
    if device is None:
        if not torch.cuda.is_available():
            raise NoCard("no CUDA device: the benchmark runs on the card "
                         "only")
        if torch.cuda.device_count() < chips:
            raise NoCard(f"{workload} needs {chips} cards, "
                         f"{torch.cuda.device_count()} present")
        device = torch.device("cuda", 0)
    device = torch.device(device)
    cuda = device.type == "cuda"
    from comms_tpu_torch.runtime import StreamRunner

    c = cell(m, workload, seed, device, sizes)
    cfg, tr, served, ring, item = c.cfg, c.traffic, c.served, c.ring, c.item
    seed = int(seed) % 2 ** 63
    N = served.samples
    step = fault(served.step) if fault else served.step
    depth = tr["depth"]

    # set-up: the cell's own step over its own blocks
    g = 0
    state = served.init_state()
    warm = _Window(item, g, blocks=tr["warmup_blocks"])
    state = _serve(StreamRunner, _timed(step, []), state, warm, depth, N,
                   device)
    g += tr["warmup_blocks"]
    if cuda:
        torch.cuda.synchronize(device)

    # the measured window
    dispatch = []
    win = _Window(item, g, seconds=seconds, keep=tr["check_blocks"],
                  stride=tr["check_stride"],
                  offset=seed % tr["check_stride"])
    state = _serve(StreamRunner, _timed(step, dispatch), state, win, depth,
                   N, device)
    t_end = time.perf_counter()
    g += len(win.handoff)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    run = RunView(
        samples_per_block=N, setup_s=win.handoff[0] - t0,
        window_s=t_end - win.handoff[0], delivered=len(win.delivery),
        latencies_s=[d - h for h, d in zip(win.handoff, win.delivery)],
        dispatch_s=dispatch, launches=served.launches())

    if trace:
        from benchlib import trace as T

        prof = _traced_segment(StreamRunner, _timed(step, []), state, item,
                               g, tr, N, device)
        run.trace = T.from_profiler(prof, tr["trace_blocks"],
                                    T.port_kernel_names(m.root))
    kept = win.kept()
    del state, served, step
    c.served = None
    if cuda:
        torch.cuda.empty_cache()

    # the comparison, once the window has closed and the state is freed
    limit = cfg["check"]["max_rel_err"]
    lost = len(win.handoff) - len(win.delivery)
    ref = m.reference(c.workload["config"])
    errs = {g_: compare(ref, ring, cfg, {g_: y})
            for g_, y in kept.items()}
    worst = max(errs.values()) if errs else float("inf")
    bad = sum(1 for e in errs.values() if not e <= limit)
    compared = {"max_rel_err": {"value": worst, "limit": limit},
                "lost_blocks": {"value": lost, "limit": 0}}
    correct = bool(worst <= limit and lost == 0)

    metrics = {}
    chosen = m.per_layer(workload) if trace else m.end_to_end()
    for spec in chosen:
        v = m.reader(spec["name"]).read(run)
        if v is not None:
            metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    if cuda:
        from benchlib import device as D
        card = D.card(device.index or 0)
        dev = {"platform": "gpu", "kind": card["kind"],
               "count": chips, "memory_peak_bytes": int(peak),
               "power_limit_w": card["power_limit_w"]}
    else:
        dev = {"platform": "cpu", "kind": "cpu", "count": 0,
               "memory_peak_bytes": 0, "power_limit_w": None}
    result = {"correct": correct, "attempted": len(win.handoff),
              "failed": lost + bad, "metrics": metrics, "device": dev}
    if run.trace is not None:
        from benchlib import trace as T
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = T.breakdown(run.trace)
    result["compared"] = compared
    return result, compared


def _traced_segment(StreamRunner, step, state, item, g, tr, N, device):
    """``torch.profiler`` over ``trace_blocks`` more blocks served as in
    the window, from an idle device; a first, discarded session of two
    blocks takes the profiler's start-up out of the trace."""
    from torch.profiler import ProfilerActivity, profile, record_function

    from benchlib import trace as T

    class Runner(StreamRunner):
        def _drain(self, y, event):
            with record_function("bench.drain"):
                super()._drain(y, event)

    def traced_step(s, x):
        with record_function("bench.step"):
            return step(s, x)

    # one profiler session after another is what this segment does
    warnings.filterwarnings("ignore", message=".*clears events at the end")
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    depth = tr["depth"]
    with profile(activities=acts):
        state = _serve(Runner, traced_step, state,
                       _Window(item, g, blocks=2), depth, N, device)
    g += 2
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    with profile(activities=acts) as prof:
        with record_function(T.WINDOW):
            _serve(Runner, traced_step, state,
                   _Window(item, g, blocks=tr["trace_blocks"]), depth, N,
                   device)
    return prof


def percentile(values, q: float) -> float:
    return float(np.percentile(np.asarray(values, np.float64), q))
