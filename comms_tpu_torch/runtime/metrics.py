"""Throughput counters and a device-completion barrier.

Counterpart of the first half of :mod:`comms_tpu.runtime.metrics`.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import time

import torch

__all__ = ["ThroughputMeter", "device_sync"]


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


def _leaves(tree):
    if isinstance(tree, (tuple, list)):
        for t in tree:
            yield from _leaves(t)
    elif isinstance(tree, dict):
        for t in tree.values():
            yield from _leaves(t)
    else:
        yield tree


def device_sync(tree) -> float:
    """Wait until every CUDA device holding a tensor of ``tree`` has
    finished its queued work (``torch.cuda.synchronize``), and return a
    checksum of the first element of each tensor, so that a timed region
    ends on values that exist."""
    tensors = [t for t in _leaves(tree) if isinstance(t, torch.Tensor)]
    for dev in {t.device for t in tensors if t.device.type == "cuda"}:
        torch.cuda.synchronize(dev)
    total = 0.0
    for t in tensors:
        if t.numel():
            v = t.reshape(-1)[0]
            total += float(v.real if v.is_complex() else v)
    return total
