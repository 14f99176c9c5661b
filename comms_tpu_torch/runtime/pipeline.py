"""Pipeline composer: a linear chain of BlockOps as one block step.

Counterpart of :mod:`comms_tpu.runtime.pipeline`:

    pipe = Pipeline([PrnSource.make(...), BpskMod(), PulseShape.make(...)])
    state = pipe.init_state()                 # on the card
    y, state = pipe.step(state, x)            # one block
    ys, state = pipe.run(state, x_blocks)     # many blocks, in a loop

The state is a tuple with one entry per op (the JAX state's structure).
``run`` is a loop over blocks that equals repeated ``step`` bit for bit
(the JAX package's ``lax.scan``).  ``make_sharded_step`` runs every op
through its ``shard_apply`` hook over a mesh, in one process or across
processes (:mod:`comms_tpu_torch.parallel.sharding`).
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Sequence

import torch

from comms_tpu_torch.parallel import sharding as _sh
from comms_tpu_torch.runtime.block import BlockOp
from comms_tpu_torch.runtime.metrics import named_scope

__all__ = ["Pipeline"]


def _named(i: int, op):
    return named_scope(f"{i}_{type(op).__name__}")


def _spec(x, axis):
    """Shard a block along its first dimension over ``axis``."""
    return (axis,) + (None,) * (x.ndim - 1)


class Pipeline:
    """A linear chain of :class:`BlockOp` composed into one block step."""

    def __init__(self, ops: Sequence[BlockOp], state_dtype=torch.complex64):
        self.ops = list(ops)
        self.state_dtype = state_dtype

    def init_state(self, device="cuda"):
        """Per-op states on ``device``, with dtypes propagated through the
        chain (``state_dtype`` is the pipeline's input stream dtype; each
        op's ``out_dtype`` gives its successor's)."""
        cur = self.state_dtype
        states = []
        for op in self.ops:
            states.append(op.init_state(dtype=cur, device=device))
            cur = op.out_dtype(cur)
        return tuple(states)

    @property
    def rate(self) -> Fraction:
        r = Fraction(1, 1)
        for op in self.ops:
            r *= op.rate
        return r

    def step(self, state, x=None):
        """Process one block.  For source-headed pipelines pass
        ``x=None``."""
        new_state = []
        y = x
        for i, op in enumerate(self.ops):
            with _named(i, op):
                y, s = op.apply(state[i], y)
            new_state.append(s)
        return y, tuple(new_state)

    def run(self, state, blocks=None, num_blocks: Optional[int] = None):
        """Drive many blocks: ``blocks`` is [num_blocks, block, ...] (or
        None for a source-headed pipeline, with ``num_blocks``).  Returns
        ``(ys[num_blocks, out_len, ...], final_state)``."""
        if blocks is None:
            if num_blocks is None:
                raise ValueError("num_blocks required for source pipelines")
            blocks = [None] * int(num_blocks)
        ys = []
        for xb in blocks:
            y, state = self.step(state, xb)
            ys.append(y)
        return torch.stack(ys), state

    def make_sharded_step(self, mesh, axis="time",
                          block: Optional[int] = None):
        """This pipeline as a time-sharded step over ``mesh``.

        Every op runs per shard through its ``shard_apply`` hook:
        overlap-save ops take their left neighbour's tail from one ring
        exchange (the K12 kernel on the card), the Mixer offsets its
        phase per shard, the NCO adds the earlier shards' error totals,
        and the carried stream state stays whole, so the sharded step
        equals the one-device step on the concatenated block.

        Returns ``(state, x[N, ...]) -> (y, state)`` over global tensors
        (``x=None`` for a source-headed pipeline).  With ``block`` the
        per-shard sizes are checked up front.  Across processes the
        input is ``multihost.host_feed``'s value (or a global tensor every
        process holds) and the output this process's shards
        (``sharding.Sharded``); the state is whole on every process.
        """
        n_dev = mesh.axis_size(axis)
        if block is not None:
            if block % n_dev:
                raise ValueError(
                    f"block {block} must divide over {n_dev} shards")
            local = block // n_dev
            self.check_block_size(local)
            for op in self.ops:
                if 0 < local <= op.halo:
                    raise ValueError(
                        f"per-shard length {local} must exceed the "
                        f"halo {op.halo} of {op}")
                local = op.out_len(local)

        def step(state, x=None):
            ys = None if x is None else _sh.shard(x, mesh, _spec(x, axis))
            new_state = []
            for i, op in enumerate(self.ops):
                with _named(i, op):
                    ys, s = op.shard_apply(state[i], ys, mesh, axis)
                new_state.append(s)
            return _sh.unshard(ys, mesh, _spec(ys[0], axis)), tuple(new_state)

        return step

    def check_block_size(self, n: int) -> int:
        """Validate block length ``n`` through the chain (each op's own
        length rule); returns the output length."""
        cur = int(n)
        for op in self.ops:
            cur = op.out_len(cur)
        return cur

    def __repr__(self):
        inner = ", ".join(type(op).__name__ for op in self.ops)
        return f"Pipeline([{inner}], rate={self.rate})"
