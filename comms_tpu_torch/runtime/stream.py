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

Under a ``torch.profiler`` session each block opens one span
(:func:`~comms_tpu_torch.runtime.metrics.named_scope`) per boundary:
``stream.upload``, ``stream.step``, ``stream.d2h`` (the D2H copies and
the event's record), and ``stream.drain`` with its children
``stream.wait`` (the event), ``stream.copy`` (the hand-off of every
leaf to the sink, with a child ``stream.lend`` where the block is lent)
and ``stream.sink``.  Each span's argument is the block's sequence
number; the runner is FIFO, so a block's spans pair up by their order.

Four hazards the design handles:

* a non-blocking H2D copy from pageable memory runs synchronously, so
  host blocks are first copied into pinned staging memory;
* that copy also protects against a source that reuses its buffer (the
  copy is made before the next block is asked for);
* a non-blocking D2H copy read before it completes is garbage, so a
  result reaches the sink only after its block's event has completed;
* the sink is lent the pinned D2H buffers themselves, as numpy arrays
  over their memory, which goes back to the pinned-memory cache only
  when the sink drops the arrays.  A sink that kept every block would
  pin all of it, and force a new (slow, synchronising) pinned
  allocation per block; so a block is lent only while fewer than
  ``depth`` lent blocks are still alive (the runner watches the arrays
  it lent through weak references), and copied otherwise.  A leaf the
  step returned on the host is always copied: the step may reuse it.

Staging and result buffers come from PyTorch's pinned-memory cache,
which does not hand a buffer out again until the copies recorded on it
have completed.  Sources are iterables of numpy arrays or tensors, or of
tuples/lists/dicts of them; a tensor already on the runner's device is
used as it is.

:class:`BatchedStreamRunner` serves B independent streams through one
runner: each round stacks the B blocks and runs the per-stream step over
them (a loop over the streams, or ``torch.func.vmap``), the step that
:func:`lift` makes of the per-stream step.
"""

from __future__ import annotations

import weakref
from collections import deque
from typing import Any, Callable, Iterable, Optional, Sequence

import numpy as np
import torch

from comms_tpu_torch.runtime import _tree
from comms_tpu_torch.runtime.metrics import ThroughputMeter, named_scope

__all__ = ["StreamRunner", "BatchedStreamRunner", "lift"]


class StreamRunner:
    """Drive ``block_fn(state, x) -> (y, state)`` over a block source.

    Args:
      block_fn: block step.
      state: initial state (tensors on ``device``).
      source: iterable of input blocks (numpy or tensors).
      sink: optional callable receiving each output block as numpy
        arrays it owns: nothing else writes their memory while they live.
      meter: optional ThroughputMeter; ``samples_of(x)`` counts the
        samples per input block (defaults to ``len``).
      depth: max in-flight (dispatched, not yet drained) blocks.
      device: where the blocks run.

    ``blocks_drained`` counts the blocks drained, ``blocks_lent`` those
    the sink was lent rather than given a copy of.
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
        self.blocks_drained = 0
        self.blocks_lent = 0
        self._owned = {}    # id -> weakref of the runner's host buffers
        self._lent = []     # weakrefs to the arrays of each lent block

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

    def _start_host_copy(self, leaf):
        if leaf.device.type != "cuda":
            return leaf
        buf = torch.empty(leaf.shape, dtype=leaf.dtype, pin_memory=True)
        buf.copy_(leaf, non_blocking=True)
        return self._own(buf)

    def _own(self, buf):
        """Note ``buf`` as a host buffer of the runner's own, which the
        drain may lend to the sink."""
        self._owned[id(buf)] = weakref.ref(buf)
        return buf

    def _hand_off(self, y, seq):
        """Block ``y``'s leaves as the sink's arrays: the block is lent
        (the runner's own buffers as arrays over their memory) while
        fewer than ``depth`` lent blocks are alive, else copied."""
        mine = set()
        for t in _tree.leaves(y):
            ref = self._owned.pop(id(t), None)
            if ref is not None and ref() is t:
                mine.add(id(t))
        # ``t.numpy()``'s base is a new tensor over ``t``'s storage, not
        # ``t``: a lent block is alive while one of its arrays is (a
        # view, such as a stream's row of a batched round, keeps its
        # array as its base).
        self._lent = [b for b in self._lent
                      if any(r() is not None for r in b)]
        if not mine or len(self._lent) >= self.depth:
            return _tree.tree_map(lambda t: t.numpy().copy(), y)
        refs = []

        def lend(t):
            if id(t) not in mine:
                return t.numpy().copy()
            a = t.numpy()
            refs.append(weakref.ref(a))
            return a

        with named_scope("stream.lend", seq):
            out = _tree.tree_map(lend, y)
        self._lent.append(refs)
        self.blocks_lent += 1
        return out

    def _drain(self, y, event) -> None:
        seq = self.blocks_drained
        self.blocks_drained += 1
        with named_scope("stream.drain", seq):
            with named_scope("stream.wait", seq):
                if event is not None:
                    event.synchronize()
            if self.sink is None:
                return
            with named_scope("stream.copy", seq):
                if event is None:
                    out = _tree.tree_map(lambda t: t.numpy(), y)
                else:
                    out = self._hand_off(y, seq)
            with named_scope("stream.sink", seq):
                self.sink(out)

    def run(self, max_blocks: Optional[int] = None) -> ThroughputMeter:
        """Stream until the source ends (or ``max_blocks``).  Returns
        the throughput meter."""
        cuda = self.device.type == "cuda"
        pending: deque = deque()   # oldest-first (result, event)
        for i, x in enumerate(self.source):
            if max_blocks is not None and i >= max_blocks:
                break
            seq = self.blocks_done
            with self.meter.block(self.samples_of(x)):
                with named_scope("stream.upload", seq):
                    x = _tree.tree_map(self._upload, x)
                with named_scope("stream.step", seq):
                    y, self.state = self.block_fn(self.state, x)
                with named_scope("stream.d2h", seq):
                    if self.sink is not None:
                        y = _tree.tree_map(self._start_host_copy, y)
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


def _stack(*leaves):
    if isinstance(leaves[0], torch.Tensor):
        return torch.stack(leaves)
    return np.stack(leaves)


def lift(block_fn: Callable, states: Sequence[Any], mode: str = "unroll"):
    """The per-stream step ``block_fn(state, x) -> (y, state)`` over a
    leading stream axis of the blocks, and its carried start state:
    ``(step, state0)`` for the B = ``len(states)`` per-stream ``states``.

    * ``mode="unroll"`` and ``mode="map"``: a loop over the streams, each
      the unbatched step on its slice; ``state0`` is the tuple of the B
      states.
    * ``mode="vmap"``: ``torch.func.vmap`` of the step; ``state0`` stacks
      the states leaf by leaf (every leaf must be a tensor).

    ``step(state0, x)`` with ``x``'s leaves ``[B, ...]`` returns the
    outputs stacked ``[B, ...]`` and the next carried state.
    :class:`BatchedStreamRunner` serves this step; a caller with its own
    serving loop can serve the same step."""
    B = len(states)
    if B < 1:
        raise ValueError("need at least one stream state")
    if mode in ("unroll", "map"):
        def lifted(states, x):
            ys, sts = [], []
            for b in range(B):
                y, s = block_fn(states[b], _tree.tree_map(lambda a: a[b], x))
                ys.append(y)
                sts.append(s)
            return _tree.tree_map(lambda *ls: torch.stack(ls), *ys), \
                tuple(sts)
        return lifted, tuple(states)
    if mode != "vmap":
        raise ValueError(
            f"mode must be 'unroll', 'map' or 'vmap', got {mode!r}")
    for leaf in _tree.leaves(states[0]):
        if not isinstance(leaf, torch.Tensor):
            raise ValueError(
                "mode='vmap' stacks the states: every state leaf "
                f"must be a tensor, got {type(leaf).__name__}")
    vm = torch.func.vmap(block_fn)

    def lifted(state, x):
        try:
            return vm(state, x)
        except RuntimeError as e:
            raise ValueError(
                "torch.func.vmap cannot run this block function over "
                "the stream axis: a step that reads a value on the "
                "host, or launches a CUDA kernel through ctypes outside "
                "a custom op with a vmap rule (the FM chain, "
                "decimating-FIR, channelizer and band-monitor kernels "
                "K1, K2, K8, K9, and K4 on K2's kernel), cannot be "
                "vmapped.  The JAX package has the same "
                "limit for those kernels: their Pallas operands live in "
                "memory_space=ANY, which jax.vmap cannot lift "
                "(comms_tpu/runtime/stream.py, BatchedStreamRunner); "
                "use mode='unroll'") from e
    return lifted, _tree.tree_map(lambda *ls: torch.stack(ls), *states)


class BatchedStreamRunner(StreamRunner):
    """Serve ``B`` independent streams, one round of B blocks at a time.

    Counterpart of :class:`comms_tpu.runtime.stream.BatchedStreamRunner`.
    The per-stream step is lifted over a leading stream axis:

    * ``mode="unroll"`` (default) and ``mode="map"``: a loop over the
      streams, each stream's step the unbatched step on its slice, so
      outputs and states equal B separate runs bit for bit (the JAX
      package's ``lax.map`` is the same loop here).  The carried state
      is the tuple of the B per-stream states.
    * ``mode="vmap"``: ``torch.func.vmap`` of the step over stacked
      states (every state leaf must be a tensor).  Batched products may
      round otherwise.  The QPSK symbol and panel kernels (K5) are
      custom ops whose vmap rule launches them once a stream; the
      recurrence kernels' rule launches once for all the streams (one
      lane a stream), so a round of the Costas receiver is one Costas
      launch.  So the QPSK stream steps and the Costas receiver lift; a
      step that launches another ctypes kernel (K1, K2 and K4 on it, K8,
      K9: as in the JAX package, whose Pallas kernels on
      ``memory_space=ANY`` operands cannot be vmapped) raises a
      ValueError that says so.

    The runner keeps :class:`StreamRunner`'s loop, so the stream's final
    drain is timed.

    Args:
      block_fn: per-stream step ``(state, x) -> (y, state)``.
      states: length-B list of per-stream initial states.
      sources: length-B list of per-stream block iterables (stacked each
        round), OR ``batched_source``, an iterable of pre-stacked
        ``[B, ...]`` blocks (device-resident serving).
      sinks: optional length-B list of per-stream callables; each gets its
        own stream's output block.
      samples_of: samples of a round (default B * leading-leaf length).
      depth: in-flight rounds, as in :class:`StreamRunner`.
      device: where the blocks run.
    """

    def __init__(self, block_fn: Callable, states: Sequence[Any],
                 sources: Optional[Sequence[Iterable[Any]]] = None,
                 sinks: Optional[Sequence[Callable[[Any], None]]] = None,
                 meter: Optional[ThroughputMeter] = None,
                 samples_of: Optional[Callable[[Any], int]] = None,
                 depth: int = 1, mode: str = "unroll",
                 batched_source: Optional[Iterable[Any]] = None,
                 device="cuda"):
        lifted, state0 = lift(block_fn, states, mode)
        B = len(states)

        if batched_source is None:
            if sources is None:
                raise ValueError("pass sources or batched_source")
            if len(sources) != B:
                raise ValueError(
                    f"{len(sources)} sources for {B} stream states")

            def _stacked():
                for xs in zip(*sources):
                    yield _tree.tree_map(_stack, *xs)
            source: Iterable[Any] = _stacked()
        else:
            source = batched_source

        sink = None
        if sinks is not None:
            if len(sinks) != B:
                raise ValueError(f"{len(sinks)} sinks for {B} stream states")

            def sink(y):
                for b, s in enumerate(sinks):
                    s(_tree.tree_map(lambda a: a[b], y))

        if samples_of is None:
            def samples_of(x):
                return B * len(_tree.leaves(x)[0][0])

        super().__init__(lifted, state0, source, sink=sink, meter=meter,
                         samples_of=samples_of, depth=depth, device=device)
        self.num_streams = B
        self.mode = mode

    def stream_states(self):
        """The carried state as B per-stream states."""
        if self.mode == "vmap":
            return [_tree.tree_map(lambda a: a[b], self.state)
                    for b in range(self.num_streams)]
        return list(self.state)
