"""The traced segment's reduction: ``torch.profiler`` events to device
operations and host spans, the device's busy time, and the breakdown
(the device operations that took the most time, the longest idle gaps
named by what the host was doing then)."""

from __future__ import annotations

import dataclasses
import re
from pathlib import Path

WINDOW = "bench.window"


@dataclasses.dataclass(frozen=True)
class Op:
    name: str
    start_us: float
    end_us: float

    @property
    def seconds(self) -> float:
        return (self.end_us - self.start_us) / 1e6

    @property
    def short(self) -> str:
        return short_name(self.name)


@dataclasses.dataclass
class TraceView:
    """What the per-layer readers read of a traced segment."""
    blocks: int
    window: Op
    device_ops: list      # kernels, copies and sets on the card, in order
    host_ops: list        # host spans: the harness's, PyTorch's, CUDA's
    port_kernels: frozenset

    @property
    def window_s(self) -> float:
        return self.window.seconds

    @property
    def busy_s(self) -> float:
        return busy_us(self.device_ops, self.window.start_us,
                       self.window.end_us) / 1e6

    def is_port(self, op: Op) -> bool:
        return op.short in self.port_kernels


def short_name(name: str) -> str:
    """A kernel's bare name: no return type, namespace, template
    arguments or parameters (``decim_fir_kernel``)."""
    s = name.replace("(anonymous namespace)::", "")
    s = s[5:] if s.startswith("void ") else s
    s = s.split("(")[0].split("<")[0].strip()
    return s.split("::")[-1] or name


def port_kernel_names(root: Path) -> frozenset:
    """Names of the ``__global__`` functions in the program's CUDA
    sources (``comms_tpu_torch/csrc/*.cu``)."""
    names = set()
    for src in sorted((root / "comms_tpu_torch" / "csrc").glob("*.cu")):
        text = src.read_text()
        for m in re.finditer(r"__global__", text):
            i = m.end()
            depth = 0
            ident = None
            while i < len(text) and text[i] not in "{;":
                c = text[i]
                if c == "(":
                    if depth == 0 and ident and ident != "__launch_bounds__":
                        names.add(ident)
                        break
                    depth += 1
                elif c == ")":
                    depth -= 1
                elif depth == 0 and (c.isalnum() or c == "_"):
                    j = i
                    while j < len(text) and (text[j].isalnum()
                                             or text[j] == "_"):
                        j += 1
                    ident = text[i:j]
                    i = j
                    continue
                i += 1
    return frozenset(names)


def _union(ops, lo: float, hi: float):
    iv = sorted((max(o.start_us, lo), min(o.end_us, hi)) for o in ops
                if o.end_us > lo and o.start_us < hi)
    out = []
    for s, e in iv:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def busy_us(ops, lo: float, hi: float) -> float:
    """Time inside [lo, hi] (us) that at least one of ``ops`` covers,
    overlaps counted once."""
    return sum(e - s for s, e in _union(ops, lo, hi))


def from_profiler(prof, blocks: int, port_kernels: frozenset) -> TraceView:
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        op = Op(e.name, float(e.time_range.start), float(e.time_range.end))
        if e.device_type == cuda:
            if not getattr(e, "is_user_annotation", False):
                dev.append(op)
        else:
            host.append(op)
    windows = [o for o in host if o.name == WINDOW]
    if not windows:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    dev.sort(key=lambda o: o.start_us)
    return TraceView(blocks, windows[0], dev, host, port_kernels)


def breakdown(view: TraceView, top: int = 10) -> dict:
    """``device_ops``: device seconds by kernel or copy name, the most
    first; ``idle_gaps``: the longest idle stretches of the window, each
    named by the innermost host span under its middle."""
    by = {}
    for o in view.device_ops:
        by[o.short] = by.get(o.short, 0.0) + o.seconds
    ops = sorted(by.items(), key=lambda kv: -kv[1])[:top]
    lo, hi = view.window.start_us, view.window.end_us
    busy = _union(view.device_ops, lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for s, e in gaps[:top]:
        mid = (s + e) / 2
        under = [o for o in view.host_ops if o.start_us <= mid <= o.end_us
                 and o.name != WINDOW]
        name = min(under, key=lambda o: o.end_us - o.start_us).name \
            if under else WINDOW
        named.append([name, (e - s) / 1e6])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
