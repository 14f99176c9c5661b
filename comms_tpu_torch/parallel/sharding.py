"""Time-block sharding over an in-process mesh with halo exchange.

Counterpart of :mod:`comms_tpu.parallel.sharding`.  The JAX package runs
its sharded programs under ``shard_map`` on a device mesh (on the CPU, an
8-device virtual mesh).  The port's mesh is an ordered list of shard
slots, each bound to a ``torch.device``; shards may share a card, and on a
machine with one H100 all of them do, which is the counterpart of the
virtual CPU mesh.  Shard order is the row-major flattening of the mesh
shape, the JAX mesh's order, so shard ``s`` holds the same slice in both
packages.

Inside a step a sharded tensor is a Python list of per-shard tensors in
shard order (views made by :func:`shard`, no copy).  The body of each
JAX ``shard_map`` becomes stages: a loop over shards runs the local ops,
and the list-to-list collectives below run between stages:

* :func:`halo_exchange` (and :func:`halo_exchange_rdma`, the same
  function under the JAX name): each shard receives its left neighbour's
  last ``halo`` rows, the first shard of each ring the carried context.
  On CUDA shards every such exchange is one launch of the ring kernel
  (:mod:`comms_tpu_torch.kernels.halo_ring`), all rings and planes of the
  call together; on CPU shards its plain version runs;
* :func:`collect_ctx`: the last shard's tail (exact, a slice);
* :func:`psum` / :func:`psum_estimate`: the per-shard parts summed in
  shard order (deterministic) and given to every shard of the ring;
* :func:`corner_turn` and :func:`all_to_all`: re-slicing of the lists
  (exact).

``axis`` names one mesh axis, or a tuple of names (the flattened ring
over them, as JAX's tuple axes).  The public steps of the sharded layer
take and return global tensors (:func:`shard`, :func:`unshard`).
"""

from __future__ import annotations

import itertools

import numpy as np
import torch

from comms_tpu_torch.kernels import halo_ring as _HR

__all__ = ["Mesh", "time_mesh", "shard", "unshard", "halo_exchange",
           "halo_exchange_rdma", "collect_ctx", "psum", "psum_estimate",
           "corner_turn", "all_to_all"]


def _indexed(d: torch.device) -> torch.device:
    """"cuda" as the current CUDA device, so that "cuda" and "cuda:0" name
    one card (raises where PyTorch has no CUDA)."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """An in-process device mesh: ``devices`` (one ``torch.device`` per
    shard, row-major over ``shape``) and one name per axis.  ``shape``
    reads as JAX's ``mesh.shape``: a dict of axis name to size."""

    def __init__(self, devices, shape, axis_names):
        self.devices = [_indexed(torch.device(d)) for d in devices]
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in shape)
        if len(sizes) != len(self.axis_names):
            raise ValueError("one axis name per mesh dimension")
        if int(np.prod(sizes)) != len(self.devices):
            raise ValueError(f"mesh shape {sizes} needs "
                             f"{int(np.prod(sizes))} devices, got "
                             f"{len(self.devices)}")
        self.shape = dict(zip(self.axis_names, sizes))
        kinds = {d.type for d in self.devices}
        if "cuda" in kinds and len(set(self.devices)) > 1:
            raise ValueError(
                f"the mesh's shards lie on {len(set(self.devices))} devices: "
                "rings over more than one card come with a later slice")
        for d in set(self.devices):
            torch.empty(0, device=d)        # raises where there is no such
                                            # device (no card: no CUDA mesh)

    @property
    def size(self) -> int:
        return len(self.devices)

    def _axes(self, axis):
        names = axis if isinstance(axis, (tuple, list)) else (axis,)
        for a in names:
            if a not in self.shape:
                raise ValueError(f"no mesh axis {a!r} in {self.axis_names}")
        return tuple(names)

    def axis_size(self, axis) -> int:
        return int(np.prod([self.shape[a] for a in self._axes(axis)]))

    def rings(self, axis):
        """The shard indices of each ring along ``axis``: one list per
        combination of the other axes' coordinates, in ring order (over a
        tuple of axes: row-major in the order given)."""
        names = self._axes(axis)
        grid = np.arange(self.size).reshape(tuple(self.shape.values()))
        pos = [self.axis_names.index(a) for a in names]
        rest = [i for i in range(grid.ndim) if i not in pos]
        g = np.transpose(grid, rest + pos).reshape(-1, self.axis_size(axis))
        return [list(map(int, r)) for r in g]

    def axis_index(self, axis):
        """Each shard's position along ``axis`` (JAX's ``axis_index``)."""
        idx = [0] * self.size
        for ring in self.rings(axis):
            for i, s in enumerate(ring):
                idx[s] = i
        return idx

    def coords(self, s: int) -> dict:
        """Shard ``s``'s coordinate along every axis."""
        c = np.unravel_index(s, tuple(self.shape.values()))
        return dict(zip(self.axis_names, map(int, c)))


def time_mesh(n_devices: int, name: str = "time", device="cuda") -> Mesh:
    """1-D mesh of ``n_devices`` shards on ``device`` (shards may share
    it)."""
    n = int(n_devices)
    if n < 1:
        raise ValueError(f"a mesh needs at least one shard, got {n}")
    return Mesh([device] * n, (n,), (name,))


def _spec_axes(mesh: Mesh, spec):
    return [None if a is None else mesh._axes(a) for a in spec]


def shard(x, mesh: Mesh, spec):
    """The per-shard views of global ``x`` under ``spec`` (one mesh axis,
    a tuple of axes, or None per dimension of ``x``, as JAX's
    ``PartitionSpec``); unnamed mesh axes replicate.  No copy is made:
    each view is a ``narrow`` of ``x``."""
    axes = _spec_axes(mesh, spec)
    out = []
    for s in range(mesh.size):
        c = mesh.coords(s)
        v = x
        for dim, names in enumerate(axes):
            if names is None:
                continue
            parts = mesh.axis_size(names)
            if x.shape[dim] % parts:
                raise ValueError(f"dimension {dim} of length {x.shape[dim]} "
                                 f"does not divide over {parts} shards")
            k = 0
            for a in names:
                k = k * mesh.shape[a] + c[a]
            step = x.shape[dim] // parts
            v = v.narrow(dim, k * step, step)
        out.append(v)
    return out


def unshard(xs, mesh: Mesh, spec):
    """The global tensor of per-shard ``xs`` laid out under ``spec`` (the
    inverse of :func:`shard`; a replicated axis reads its first shard)."""
    axes = _spec_axes(mesh, spec)

    def build(dim, fixed):
        if dim == len(axes):
            sel = {a: fixed.get(a, 0) for a in mesh.axis_names}
            s = 0
            for a in mesh.axis_names:
                s = s * mesh.shape[a] + sel[a]
            return xs[s]
        names = axes[dim]
        if names is None:
            return build(dim + 1, fixed)
        parts = [build(dim + 1, {**fixed, **dict(zip(names, co))})
                 for co in itertools.product(*[range(mesh.shape[a])
                                               for a in names])]
        return parts[0] if len(parts) == 1 else torch.cat(parts, dim)

    return build(0, {})


def _cast_like(ctx, x):
    """A carried context in the stream's dtype (complex -> real takes the
    real part), on the stream's device."""
    ctx = torch.as_tensor(ctx)
    if ctx.is_complex() and not x.is_complex():
        ctx = ctx.real
    return ctx.to(device=x.device, dtype=x.dtype)


def _per_shard(v, mesh: Mesh):
    return list(v) if isinstance(v, (list, tuple)) else [v] * mesh.size


def halo_exchange(xs, ctx, halo: int, mesh: Mesh, axis="time"):
    """For each shard, the ``halo`` rows preceding its chunk along dim 0:
    its left neighbour's tail along ``axis``, or the carried context
    ``ctx`` on the first shard of each ring.  ``xs`` may be one list of
    shard tensors or a tuple of such lists (planes), exchanged in the
    same launch; ``ctx`` is one tensor for every ring, a list with one
    per shard (the first shard of each ring reads its own), or a tuple of
    those, one per plane.  Returns a list per shard (or a tuple of them).
    Checks ``halo > len`` and short-circuits at ``halo == 0``; a ring of
    one shard returns the context."""
    planes = isinstance(xs, tuple)
    xss = list(xs) if planes else [xs]
    ctxs = list(ctx) if planes else [ctx]
    if len(ctxs) != len(xss):
        raise ValueError("one ctx per plane")
    halo = int(halo)
    local = xss[0][0].shape[0]
    if halo == 0:
        out = [[x[:0] for x in p] for p in xss]
        return tuple(out) if planes else out[0]
    if halo > local:
        raise ValueError(
            f"halo {halo} exceeds per-shard length {local}; "
            "use larger blocks or fewer shards")
    rings = mesh.rings(axis)
    pctx = [_per_shard(c, mesh) for c in ctxs]
    out = [[None] * mesh.size for _ in xss]
    if len(rings[0]) == 1:
        for p, plane in enumerate(xss):
            for s, x in enumerate(plane):
                out[p][s] = _cast_like(pctx[p][s], x)
        return tuple(out) if planes else out[0]
    tensors, firsts, order = [], [], []
    for p, plane in enumerate(xss):
        for ring in rings:
            tensors.append([_contiguous_tail(plane[s], halo) for s in ring])
            firsts.append(_cast_like(pctx[p][ring[0]], plane[ring[0]])
                          .reshape((halo,) + tuple(plane[0].shape[1:])))
            order.append((p, ring))
    got = _HR.exchange(tensors, halo, firsts)
    for (p, ring), recv in zip(order, got):
        for s, r in zip(ring, recv):
            out[p][s] = r
    return tuple(out) if planes else out[0]


def _contiguous_tail(x, halo: int):
    t = x[-halo:]
    return t if t.is_contiguous() else t.contiguous()


# The JAX package's second route (a Pallas RDMA ring beside the XLA
# ppermute, with one contract and bit-equal results) has one counterpart
# in one process: the ring kernel.
halo_exchange_rdma = halo_exchange


def collect_ctx(xs, halo: int, mesh: Mesh, axis="time"):
    """The next block's stream context: the last shard's ``halo`` rows,
    for every shard of its ring (a slice; exact)."""
    halo = int(halo)
    out = [None] * mesh.size
    for ring in mesh.rings(axis):
        tail = xs[ring[-1]][xs[ring[-1]].shape[0] - halo:].clone()
        for s in ring:
            out[s] = tail
    return out


def psum(parts, mesh: Mesh, axis="time"):
    """Per ring, the sum of the shards' parts in shard order, for every
    shard of the ring.  A part may be a tensor or a tuple of tensors."""
    out = [None] * mesh.size
    for ring in mesh.rings(axis):
        acc = parts[ring[0]]
        for s in ring[1:]:
            acc = (tuple(a + b for a, b in zip(acc, parts[s]))
                   if isinstance(acc, tuple) else acc + parts[s])
        for s in ring:
            out[s] = acc
    return out


def psum_estimate(partial_sums, mesh: Mesh, axis="time"):
    """Cross-shard reduction of estimator sums (frequency, phase, timing):
    each shard reduces its chunk, then one :func:`psum`."""
    return psum(partial_sums, mesh, axis)


def all_to_all(xs, mesh: Mesh, axis="time", split_axis: int = 0,
               concat_axis: int = 0):
    """Tiled all-to-all: shard ``t`` of a ring receives block ``t`` of every
    shard's ``split_axis`` (cut into ring-size blocks), concatenated in
    ring order along ``concat_axis``."""
    out = [None] * mesh.size
    for ring in mesh.rings(axis):
        n = len(ring)
        for x in (xs[s] for s in ring):
            if x.shape[split_axis] % n:
                raise ValueError(f"dimension {split_axis} of length "
                                 f"{x.shape[split_axis]} does not divide "
                                 f"over {n} shards")
        blocks = [torch.tensor_split(xs[s], n, dim=split_axis) for s in ring]
        for t, s in enumerate(ring):
            out[s] = torch.cat([b[t] for b in blocks], dim=concat_axis)
    return out


def corner_turn(ys, mesh: Mesh, axis="time"):
    """Channelizer corner turn: per-shard ``[frames_local, K]`` (time-
    sharded) -> ``[frames_global, K / n]`` (channel-sharded): shard ``t``
    of a ring holds channels ``[t*K/n, (t+1)*K/n)`` of every shard's
    frames, in ring order.  Requires K % n == 0."""
    n = mesh.axis_size(axis)
    K = ys[0].shape[1]
    if K % n:
        raise ValueError(f"channels {K} not divisible by shards {n}")
    return all_to_all(ys, mesh, axis, split_axis=1, concat_axis=0)
