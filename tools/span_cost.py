#!/usr/bin/env python3
"""Host cost of the port's spans (``runtime/metrics.named_scope``) on a
CUDA card's host.

    PYTHONPATH=. python3 tools/span_cost.py [--blocks 48] [--reps 3] \
        [CELL ...]

from the root of a checkout (cells default to every cell of
``BENCHMARK.json``).  Prints one JSON line each for

- ``closed``: µs a ``with named_scope(name, i)`` with no profiler
  recording, beside an empty ``with`` on a shared no-op context, the
  flag check alone, and ``record_function`` entered with no profiler
  recording (what a span cost before the flag check);
- ``open``: µs a span while ``torch.profiler`` records the host and the
  card;
- ``wrappers``: host µs a call of K2's and K8's wrappers
  (``decim_fir.fir_decimate_planar``, ``channelizer.channelize_planar``)
  at 1,638,400 samples, untraced and traced, median of ``--calls``;
- each cell, served as the benchmark serves it (``benchmark/benchlib``:
  its ring, its depth, its copying sink), ``--blocks`` blocks a pass:
  host ms a block untraced, traced with the program's spans, and traced
  with them closed (the flag read as off), ``--reps`` passes each in
  turn, and the program's spans a block; of the traced passes with
  spans, the idle share of the pass under each ``stream.*`` span and
  under none, the ten longest idle gaps with the innermost program span
  around each, and each session's clock mapping (the least lead, in µs,
  of PyTorch's own kernels over the runtime call that launched them: a
  negative lead is a kernel placed before its launch);

and last the whole as one JSON line with the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "benchmark"), str(ROOT)]

from comms_tpu_torch.runtime import metrics  # noqa: E402
from comms_tpu_torch.runtime.stream import StreamRunner  # noqa: E402

ACTS = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
PROGRAM = ("stream.", "kernel.", "qpsk_stream.")


def _per_call_us(body, n: int) -> float:
    t = time.perf_counter()
    body(n)
    return (time.perf_counter() - t) / n * 1e6


def closed_costs(n: int = 200_000) -> dict:
    closed = metrics._CLOSED
    flag = metrics._recording

    def empty(n):
        for i in range(n):
            with closed:
                pass

    def check(n):
        for i in range(n):
            flag()

    def span(n):
        for i in range(n):
            with metrics.named_scope("stream.step", i):
                pass

    def unrecorded(n):
        for i in range(n):
            with torch.profiler.record_function("stream.step", str(i)):
                pass

    out = {}
    for name, body in (("empty_with", empty), ("flag_check", check),
                       ("named_scope", span),
                       ("record_function", unrecorded)):
        k = n // 10 if name == "record_function" else n
        out[name + "_us"] = min(_per_call_us(body, k) for _ in range(3))
    return out


def open_cost(n: int = 20_000) -> dict:
    def span(n):
        for i in range(n):
            with metrics.named_scope("stream.step", i):
                pass

    with profile(activities=ACTS):
        us = min(_per_call_us(span, n) for _ in range(3))
    return {"named_scope_open_us": us}


def wrapper_costs(device, calls: int) -> dict:
    from comms_tpu_torch.kernels import channelizer as CK
    from comms_tpu_torch.kernels import decim_fir as DF
    from comms_tpu_torch.models.fm_receiver import FM_LPF_TAPS

    n = 64 * 25600
    xr, xi = (torch.randn(n, device=device) for _ in range(2))
    cr, ci = DF.decim_ctx_zero(5, device)
    taps = FM_LPF_TAPS.astype(np.float32)
    proto = np.full(64 * 13, 1.0 / (64 * 13))
    z = torch.zeros(CK.CTX_SAMPLES, device=device)
    wrappers = {
        "k2": lambda: DF.fir_decimate_planar(xr, xi, taps, 5, cr, ci,
                                             tile_rows=8),
        "k8": lambda: CK.channelize_planar(xr, xi, proto, z, z, 64)}

    def host_us(f):
        f()
        torch.cuda.synchronize(device)
        ts = []
        for i in range(calls):
            t = time.perf_counter()
            f()
            ts.append((time.perf_counter() - t) * 1e6)
            if i % 16 == 15:
                torch.cuda.synchronize(device)
        return statistics.median(ts)

    out = {}
    for name, f in wrappers.items():
        out[name + "_untraced_us"] = host_us(f)
        with profile(activities=ACTS):
            out[name + "_traced_us"] = host_us(f)
    return out


RUNNER = ("stream.upload", "stream.step", "stream.d2h", "stream.drain",
          "stream.wait", "stream.copy", "stream.sink")


def _attribution(prof, blocks: int) -> dict:
    """Idle shares by the serving loop's spans, the longest gaps, and
    the session's clock mapping."""
    import re

    from benchlib import spans as S
    from benchlib import trace as T
    from benchlib.serve import RunView

    view = T.from_profiler(prof, blocks, frozenset())
    run = RunView(0, 0.0, 0.0, 0, [], [], [], trace=view)
    out = {"idle_pct": 100.0 * (1 - view.busy_s / view.window_s)}
    for name in RUNNER:
        out["idle_pct." + name] = S.idle_pct_under(run, name)
    lo, hi = view.window.start_us, view.window.end_us
    program = [o for o in view.host_ops if o.name.startswith(PROGRAM)]
    top = [o for o in program if o.name in RUNNER[:4]]
    covered = T._union(top, lo, hi)
    idle_in = sum((e - s) - T.busy_us(view.device_ops, s, e)
                  for s, e in covered)
    out["idle_pct.outside"] = out["idle_pct"] - 100.0 * idle_in / (hi - lo)
    def innermost(ops, mid):
        around = [o for o in ops if o.start_us <= mid <= o.end_us
                  and o.name != T.WINDOW]
        return (min(around, key=lambda o: o.end_us - o.start_us).name
                if around else None)

    busy = T._union(view.device_ops, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = sorted(((edges[i + 1] - edges[i], edges[i], edges[i + 1])
                   for i in range(0, len(edges), 2)
                   if edges[i + 1] > edges[i]), reverse=True)[:10]
    out["gaps_ms"] = []
    for d, s_, e_ in gaps:
        mid = (s_ + e_) / 2
        span = innermost(program, mid)
        if span is None:
            # where a gap outside every program span lies, and what the
            # host was doing in it
            span = [(s_ - lo) / 1e3, (hi - e_) / 1e3,
                    sorted({o.name for o in view.host_ops if o.end_us > s_
                            and o.start_us < e_ and o.name != T.WINDOW})]
        out["gaps_ms"].append([d / 1e3, innermost(view.host_ops, mid), span])
    CUDA = torch.autograd.DeviceType.CUDA
    ev = list(prof.profiler.kineto_results.events())
    calls = {e.correlation_id(): e for e in ev if e.device_type() != CUDA
             and re.match(r"cu(da)?[A-Z]", e.name())}
    leads = [(e.start_ns() - calls[e.correlation_id()].start_ns()) / 1e3
             for e in ev if e.device_type() == CUDA
             and not e.is_user_annotation() and e.correlation_id() in calls]
    out["least_lead_us"] = min(leads) if leads else None
    return out


def _spans_a_block(prof, blocks: int) -> float:
    n = sum(1 for e in prof.events() if getattr(e, "is_user_annotation",
                                                False)
            and e.device_type != torch.autograd.DeviceType.CUDA
            and (e.name.startswith(PROGRAM) or e.name[:1].isdigit()))
    return n / blocks


def cell_costs(name: str, blocks: int, reps: int, device) -> dict:
    from benchlib import serve

    c = serve.cell(serve.Manifest(), name, 1, device)
    step, N = c.served.step, c.served.samples
    depth = c.traffic["depth"]
    state = c.served.init_state()
    g = 0

    def serve_pass(state, g):
        torch.cuda.synchronize(device)
        w = serve._Window(c.item, g, blocks=blocks)
        t = time.perf_counter()
        state = serve._serve(StreamRunner, step, state, w, depth, N, device)
        return state, (time.perf_counter() - t) * 1e3 / blocks

    state, _ = serve_pass(state, g)              # warm-up
    g += blocks
    times = {"untraced": [], "traced": [], "traced_closed": []}
    spans = None
    attribution = []
    flag = metrics._recording
    for _ in range(reps):
        for kind in times:
            if kind == "untraced":
                state, ms = serve_pass(state, g)
            else:
                if kind == "traced_closed":
                    metrics._recording = lambda: False
                try:
                    with profile(activities=ACTS) as prof:
                        with torch.profiler.record_function("bench.window"):
                            state, ms = serve_pass(state, g)
                finally:
                    metrics._recording = flag
                if kind == "traced":
                    spans = _spans_a_block(prof, blocks)
                    attribution.append(_attribution(prof, blocks))
            g += blocks
            times[kind].append(ms)
    out = {"cell": name, "blocks": blocks, "spans_a_block": spans,
           "traced_attribution": attribution}
    for kind, v in times.items():
        out[kind + "_ms_a_block"] = v
        out[kind + "_median"] = statistics.median(v)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cells", nargs="*")
    ap.add_argument("--blocks", type=int, default=48)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--calls", type=int, default=200)
    a = ap.parse_args(argv)
    # one host core, as the benchmark's runs hold it (benchmark/run.py)
    os.sched_setaffinity(0, {max(os.sched_getaffinity(0))})
    device = torch.device("cuda", 0)
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True).stdout.strip()
    result = {"card": q, "closed": closed_costs(), "open": open_cost(),
              "wrappers": wrapper_costs(device, a.calls)}
    for k in ("closed", "open", "wrappers"):
        print(json.dumps(result[k]), flush=True)
    cells = a.cells or [w["name"] for w in json.loads(
        (ROOT / "BENCHMARK.json").read_text())["workloads"]]
    result["cells"] = []
    for name in cells:
        r = cell_costs(name, a.blocks, a.reps, device)
        print(json.dumps(r), flush=True)
        result["cells"].append(r)
        torch.cuda.empty_cache()
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
