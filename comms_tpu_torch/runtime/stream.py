"""Streaming executor: host IO overlapped with device compute.

Counterpart of :class:`comms_tpu.runtime.stream.StreamRunner`: a serving
loop that drives a block function over a block source with up to
``depth`` blocks in flight —

    upload block k        (pinned staging copy, async H2D)
    dispatch block k      (kernels queue on the current stream)
    start D2H of result k (async, into pinned memory), record event k
    drain result k-depth  (wait on its event only when it is consumed)
    sink result k-depth

``depth`` bounds how far the host runs ahead of the sink (the
reference's channel capacity, ``src/node/graph.rs:44-47``).

Three hazards the design handles:

* a non-blocking H2D copy from pageable memory runs synchronously, so
  host blocks are first copied into pinned staging memory;
* that copy also protects against a source that reuses its buffer (the
  copy is made before the next block is asked for);
* a non-blocking D2H copy read before it completes is garbage, so a
  result reaches the sink only after its block's event has completed.

Staging and result buffers come from PyTorch's pinned-memory cache,
which does not hand a buffer out again until the copies recorded on it
have completed.  Sources are iterables of numpy arrays or tensors, or of
tuples/lists/dicts of them; a tensor already on the runner's device is
used as it is.
"""

from __future__ import annotations

from collections import deque
from typing import Any, Callable, Iterable, Optional

import torch

from comms_tpu_torch.runtime.metrics import ThroughputMeter

__all__ = ["StreamRunner"]


def _tree_map(fn, tree):
    if isinstance(tree, tuple):
        return tuple(_tree_map(fn, t) for t in tree)
    if isinstance(tree, list):
        return [_tree_map(fn, t) for t in tree]
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


class StreamRunner:
    """Drive ``block_fn(state, x) -> (y, state)`` over a block source.

    Args:
      block_fn: block step.
      state: initial state (tensors on ``device``).
      source: iterable of input blocks (numpy or tensors).
      sink: optional callable receiving each output block as numpy.
      meter: optional ThroughputMeter; ``samples_of(x)`` counts the
        samples per input block (defaults to ``len``).
      depth: max in-flight (dispatched, not yet drained) blocks.
      device: where the blocks run.
    """

    def __init__(self, block_fn: Callable, state: Any,
                 source: Iterable[Any],
                 sink: Optional[Callable[[Any], None]] = None,
                 meter: Optional[ThroughputMeter] = None,
                 samples_of: Callable[[Any], int] = len,
                 depth: int = 1, device="cuda"):
        self.block_fn = block_fn
        self.state = state
        self.source = source
        self.sink = sink
        self.meter = meter if meter is not None else ThroughputMeter()
        self.samples_of = samples_of
        self.depth = max(1, int(depth))
        self.device = torch.device(device)
        self.blocks_done = 0

    def _upload(self, leaf):
        if isinstance(leaf, torch.Tensor) and leaf.device.type != "cpu":
            # device-resident: no host round trip ("cuda" and "cuda:0"
            # name one device, so compare by moving, which is a no-op
            # when the tensor is already there)
            return leaf.to(self.device)
        host = torch.as_tensor(leaf)
        if self.device.type != "cuda":
            return host.to(self.device)
        staged = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        staged.copy_(host)
        return staged.to(self.device, non_blocking=True)

    @staticmethod
    def _start_host_copy(leaf):
        if leaf.device.type != "cuda":
            return leaf
        buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        buf.copy_(leaf, non_blocking=True)
        return buf

    def _drain(self, y, event) -> None:
        if event is not None:
            event.synchronize()
        if self.sink is None:
            return
        if event is None:
            self.sink(_tree_map(lambda t: t.numpy(), y))
        else:
            # The sink gets its own copy, so the pinned buffer goes back
            # to the cache: a sink that keeps every block would
            # otherwise force a new (slow, synchronising) pinned
            # allocation per block.
            self.sink(_tree_map(lambda t: t.numpy().copy(), y))

    def run(self, max_blocks: Optional[int] = None) -> ThroughputMeter:
        """Stream until the source ends (or ``max_blocks``).  Returns
        the throughput meter."""
        cuda = self.device.type == "cuda"
        pending: deque = deque()   # oldest-first (result, event)
        for i, x in enumerate(self.source):
            if max_blocks is not None and i >= max_blocks:
                break
            with self.meter.block(self.samples_of(x)):
                y, self.state = self.block_fn(self.state,
                                              _tree_map(self._upload, x))
                if self.sink is not None:
                    y = _tree_map(self._start_host_copy, y)
                event = None
                if cuda:
                    event = torch.cuda.Event()
                    event.record(torch.cuda.current_stream(self.device))
                pending.append((y, event))
                if len(pending) > self.depth:
                    self._drain(*pending.popleft())
                self.blocks_done += 1
        # The blocks still in flight are part of the measured stream: a
        # meter that stopped at the last dispatch would count their
        # samples without their time.
        with self.meter.wait():
            while pending:
                self._drain(*pending.popleft())
        return self.meter
