"""Throughput counters, a device-completion barrier and profiling
helpers.

Counterpart of :mod:`comms_tpu.runtime.metrics`: the meter, the barrier,
the fixed cost of a barrier (:func:`sync_overhead`), profiler
annotations (:func:`named_scope`, ``torch.profiler.record_function``), a
Chrome trace of a region (:func:`trace`) and :func:`roofline`, whose
peaks the caller passes: the card's, never a TPU's.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import torch

from comms_tpu_torch.runtime import _tree

__all__ = ["ThroughputMeter", "device_sync", "sync_overhead", "named_scope",
           "trace", "roofline"]


@dataclasses.dataclass
class ThroughputMeter:
    """Samples/s counter for a block-streaming loop.

    >>> m = ThroughputMeter()
    >>> with m.block(num_samples=262144): y, s = step(s, x)
    >>> m.report()
    """

    samples: int = 0
    seconds: float = 0.0
    blocks: int = 0

    @contextlib.contextmanager
    def block(self, num_samples: int):
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0
        self.samples += int(num_samples)
        self.blocks += 1

    @contextlib.contextmanager
    def wait(self):
        """Time spent finishing blocks already counted (a stream's final
        drain): seconds, no samples."""
        t0 = time.perf_counter()
        yield
        self.seconds += time.perf_counter() - t0

    @property
    def msps(self) -> float:
        return self.samples / self.seconds / 1e6 if self.seconds else 0.0

    def report(self) -> dict:
        return {
            "samples": self.samples,
            "blocks": self.blocks,
            "seconds": round(self.seconds, 4),
            "Msamples_per_s": round(self.msps, 2),
        }

    def __str__(self):
        return json.dumps(self.report())


def device_sync(tree) -> float:
    """Wait until every CUDA device holding a tensor of ``tree`` has
    finished its queued work (``torch.cuda.synchronize``), and return a
    checksum of the first element of each tensor, so that a timed region
    ends on values that exist."""
    tensors = [t for t in _tree.leaves(tree) if isinstance(t, torch.Tensor)]
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    total = 0.0
    for t in tensors:
        if t.numel():
            v = t.reshape(-1)[0]
            total += float(v.real if v.is_complex() else v)
    return total


def sync_overhead(reps: int = 5, device="cuda") -> float:
    """Measured seconds of a null launch plus its value read back (a
    synchronisation), the fixed cost :func:`device_sync` adds to a timed
    region: the best of ``reps``."""
    x = torch.zeros((), dtype=torch.float32, device=device)
    float(x + 1.0)                     # first launch, drains the queue
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        float(x + 1.0)
        best = min(best, time.perf_counter() - t0)
    return best


def named_scope(name: str):
    """Profiler annotation for an op region
    (``torch.profiler.record_function``)."""
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """``torch.profiler`` trace around a region, the card's activity
    included where there is one; writes a Chrome trace into ``log_dir``
    (TensorBoard's profiler plugin or chrome://tracing reads it)."""
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(
            activities=acts,
            on_trace_ready=torch.profiler.tensorboard_trace_handler(
                str(log_dir))) as prof:
        yield prof


def roofline(bytes_moved: int, flops: int, seconds: float,
             hbm_gbps: float, peak_tflops: float) -> dict:
    """Percent-of-speed-of-light for a measured kernel execution.

    ``bytes_moved``: device-memory traffic (read + write); ``flops``:
    useful floating operations; ``hbm_gbps`` and ``peak_tflops``: the
    card's memory rate and peak for the operations' type.  The bound is
    max(bytes/rate, flops/peak)."""
    t_mem = bytes_moved / (hbm_gbps * 1e9)
    t_cmp = flops / (peak_tflops * 1e12)
    t_sol = max(t_mem, t_cmp)
    return {
        "sol_seconds": t_sol,
        "bound": "memory" if t_mem >= t_cmp else "compute",
        "pct_of_sol": round(100.0 * t_sol / seconds, 1) if seconds else 0.0,
        "achieved_gbps": round(bytes_moved / seconds / 1e9, 1)
        if seconds else 0.0,
        "achieved_tflops": round(flops / seconds / 1e12, 3)
        if seconds else 0.0,
    }
