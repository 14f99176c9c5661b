"""DAG graph API: named nodes, fan-out, fan-in, feedback, one block step.

Counterpart of :mod:`comms_tpu.runtime.graph` (the reference's
``Graph`` and ``connect_nodes!`` macros, ``src/node/graph.rs:13-74``,
``src/node/mod.rs:149-219``):

* ``add_node(name, op, inputs=[...])``; fan-out is plain value reuse,
  and multi-input ops receive a tuple of blocks in declared order;
* ``validate()`` is the reference's ``is_connected``;
* feedback edges (``connect_nodes_feedback!``) are block-level carries:
  the consumer reads the producer's previous block output, primed with
  a default value.

The step is ``(state, {input: block}) -> (outputs, state)`` over the
topologically sorted nodes; the state is ``{"ops": {node: op state},
"fb": {slot: previous block}}``, the JAX state's structure.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from comms_tpu_torch.parallel import sharding as _sh
from comms_tpu_torch.runtime.block import BlockOp
from comms_tpu_torch.runtime.metrics import named_scope

__all__ = ["Graph", "GraphNotConnectedError"]


class GraphNotConnectedError(ValueError):
    """A node reads from a producer that does not exist (the reference
    returns false from is_connected)."""


@dataclass
class _NodeSpec:
    name: str
    op: Any                      # BlockOp or callable(*ins)
    inputs: Tuple[str, ...]
    feedback: bool = False       # inputs are read from the previous block
    default: Any = None          # priming value for feedback edges
    elementwise: Optional[bool] = None  # raw callables: shard-safety


def _spec(x, axis):
    return (axis,) + (None,) * (x.ndim - 1)


class Graph:
    """Named-node DAG composed into one block step."""

    def __init__(self):
        self._nodes: Dict[str, _NodeSpec] = {}
        self._order: List[str] = []
        self._outputs: List[str] = []
        self._external: List[str] = []
        self._compiled = None

    # ------------------------------------------------------------ build
    def add_input(self, name: str) -> str:
        """Declare an external input (a block fed by the caller)."""
        if name in self._nodes or name in self._external:
            raise ValueError(f"duplicate node name {name!r}")
        self._external.append(name)
        return name

    def add_node(self, name: str, op, inputs: Sequence[str] = (),
                 feedback_from: Optional[Dict[str, Any]] = None,
                 elementwise: Optional[bool] = None) -> str:
        """Add a named op.  ``inputs`` are producer names (external or
        node).  ``feedback_from`` maps producer name -> priming default
        for cycle edges (read the producer's previous-block output).

        ``elementwise`` declares a raw callable's shard-safety: True means
        output sample i depends only on input sample(s) i, so running it
        per shard equals the one-device result.  ``make_sharded_step``
        refuses undeclared raw callables.  Ignored for BlockOp nodes,
        which carry their own ``shard_apply``."""
        if name in self._nodes or name in self._external:
            raise ValueError(f"duplicate node name {name!r}")
        fb = feedback_from or {}
        for p, d in fb.items():
            self._nodes[f"{name}@fb:{p}"] = _NodeSpec(
                f"{name}@fb:{p}", None, (p,), feedback=True, default=d)
        self._nodes[name] = _NodeSpec(
            name, op,
            tuple(f"{name}@fb:{p}" if p in fb else p for p in inputs),
            elementwise=elementwise)
        self._order.append(name)
        self._compiled = None
        return name

    def set_outputs(self, names: Sequence[str]):
        self._outputs = list(names)
        self._compiled = None

    # --------------------------------------------------------- validate
    def validate(self):
        """is_connected parity: every input must name a producer."""
        known = set(self._external) | set(self._nodes)
        for spec in self._nodes.values():
            for p in spec.inputs:
                if p not in known:
                    raise GraphNotConnectedError(
                        f"node {spec.name!r} reads undefined input {p!r}")
        if not self._outputs:
            raise GraphNotConnectedError("no outputs set")
        for o in self._outputs:
            if o not in known:
                raise GraphNotConnectedError(f"unknown output {o!r}")

    # ---------------------------------------------------------- compile
    def _is_feedback(self, name: str) -> bool:
        spec = self._nodes.get(name)
        return spec is not None and spec.feedback

    def _topo(self) -> List[_NodeSpec]:
        """Topological order ignoring feedback edges (they read the
        previous block, so they are not dependencies)."""
        order: List[_NodeSpec] = []
        done = set(self._external)
        pending = [self._nodes[n] for n in self._order]
        while pending:
            progressed = False
            rest = []
            for spec in pending:
                deps = [p for p in spec.inputs if not self._is_feedback(p)]
                if all(p in done for p in deps):
                    order.append(spec)
                    done.add(spec.name)
                    progressed = True
                else:
                    rest.append(spec)
            pending = rest
            if not progressed:
                raise GraphNotConnectedError(
                    f"cycle without feedback edge among "
                    f"{[s.name for s in pending]}")
        return order

    def init_state(self, dtype=None, device="cuda"):
        """State: per-node op state and feedback slots primed with their
        defaults, on ``device``.  Stream dtypes are propagated through
        the DAG (a node's input dtype is the promotion of its producers'
        dtypes; ``dtype`` seeds the external inputs), so a real stage
        after FmDemod gets real carried state."""
        dtype = dtype or torch.complex64
        stream: Dict[str, Any] = {name: dtype for name in self._external}
        op_state, fb_state = {}, {}
        for spec in self._topo():
            ins = [stream.get(p, dtype) for p in spec.inputs]
            in_dt = functools.reduce(torch.promote_types, ins) if ins \
                else dtype
            if isinstance(spec.op, BlockOp):
                op_state[spec.name] = spec.op.init_state(dtype=in_dt,
                                                         device=device)
                stream[spec.name] = spec.op.out_dtype(in_dt)
            else:
                op_state[spec.name] = ()
                stream[spec.name] = in_dt  # raw callable: same dtype
        for spec in self._nodes.values():
            if spec.feedback:
                d = spec.default
                fb_state[spec.name] = (
                    d.to(device) if isinstance(d, torch.Tensor)
                    else torch.as_tensor(np.asarray(d), device=device))
        return {"ops": op_state, "fb": fb_state}

    def _make_step(self, op_apply, call_raw):
        """The step body over node values (whole blocks, or per-shard
        lists in the sharded step)."""
        self.validate()
        order = self._topo()

        def step(state, inputs):
            values: Dict[str, Any] = dict(inputs)
            values.update(state["fb"])
            new_ops = dict(state["ops"])
            for spec in order:
                ins = tuple(values[p] for p in spec.inputs)
                with named_scope(spec.name):
                    if isinstance(spec.op, BlockOp):
                        x = ins[0] if len(ins) == 1 else (ins or None)
                        y, s = op_apply(spec.op, state["ops"][spec.name], x)
                        new_ops[spec.name] = s
                    else:
                        y = call_raw(spec.op, ins)
                values[spec.name] = y
            new_fb = {name: values[self._nodes[name].inputs[0]]
                      for name in state["fb"]}
            outs = tuple(values[o] for o in self._outputs)
            return outs, {"ops": new_ops, "fb": new_fb}

        return step

    def compile(self):
        """The block step ``(state, {input: block}) -> (outputs,
        new_state)``."""
        if self._compiled is None:
            self._compiled = self._make_step(
                lambda op, st, x: op.apply(st, x),
                lambda fn, ins: fn(*ins))
        return self._compiled

    # ---------------------------------------------------------- sharding
    def make_sharded_step(self, mesh, axis="time"):
        """The DAG time-sharded over ``mesh`` (the counterpart of
        ``Pipeline.make_sharded_step``): every node runs per shard through
        its ``shard_apply`` hook; inputs, outputs and feedback slots are
        split over ``axis`` and joined again, op states stay whole.

        Raw callables run per shard with no collectives, so they must be
        declared ``elementwise=True``; undeclared ones raise here rather
        than silently computing per-shard values (e.g. a reduction over
        a feedback edge).  Across processes, inputs as
        ``Pipeline.make_sharded_step``'s; outputs and feedback slots are
        ``sharding.Sharded`` values of this process's shards."""
        for spec in self._nodes.values():
            if spec.feedback or isinstance(spec.op, BlockOp):
                continue
            if spec.op is not None and spec.elementwise is not True:
                raise ValueError(
                    f"node {spec.name!r} is a raw callable not declared "
                    "elementwise=True; per-shard execution of a "
                    "non-elementwise function (e.g. a reduction over a "
                    "feedback edge) would silently diverge from the "
                    "one-device graph.  Declare add_node(..., "
                    "elementwise=True) if it is sample-wise, or wrap it "
                    "in a BlockOp with a collective-aware shard_apply.")

        def op_apply(op, st, x):
            if isinstance(x, tuple):      # multi-input op: per-shard tuples
                x = [tuple(v[s] for v in x) for s in range(len(mesh.local))]
            return op.shard_apply(st, x, mesh, axis)

        def call_raw(fn, ins):
            return [fn(*(v[s] for v in ins))
                    for s in range(len(mesh.local))]

        local = self._make_step(op_apply, call_raw)

        def split(x):
            return _sh.shard(x, mesh, _spec(x, axis))

        def join(xs):
            return _sh.unshard(xs, mesh, _spec(xs[0], axis))

        def step(state, inputs):
            sharded = {"ops": state["ops"],
                       "fb": {k: split(v) for k, v in state["fb"].items()}}
            outs, new = local(sharded,
                              {k: split(v) for k, v in inputs.items()})
            new["fb"] = {k: join(v) for k, v in new["fb"].items()}
            return tuple(join(o) for o in outs), new

        return step
