"""Time-block sharding over a mesh of shards with halo exchange.

Counterpart of :mod:`comms_tpu.parallel.sharding`.  The JAX package runs
its sharded programs under ``shard_map`` on a device mesh (on the CPU, an
8-device virtual mesh; on a pod, the chips of every host).  The port's
mesh is an ordered list of shard slots, each bound to a ``torch.device``
and owned by one process: in one process (:func:`time_mesh`) every shard
is this process's, and shards may share a card (on a machine with one
H100 all of them do, the counterpart of the virtual CPU mesh); across
processes (``parallel.multihost.pod_mesh``, one process a rank on
``torch.distributed``) each process owns a contiguous run of shards.  A
one-process mesh is a pod mesh of one process: every step and collective
below is written once for both.  Shard order is the row-major flattening
of the mesh shape, the JAX mesh's order, so shard ``s`` holds the same
slice in both packages.

Inside a step a sharded tensor is a Python list of the calling process's
shard tensors, in shard order (``mesh.local`` names their global
indices; views made by :func:`shard`, no copy).  ``axis_index``,
``rings`` and the first-shard flags keep global shard numbers.  The body
of each JAX ``shard_map`` becomes stages: a loop over the process's
shards runs the local ops, and the list-to-list collectives below run
between stages:

* :func:`halo_exchange` (and :func:`halo_exchange_rdma`, the same
  function under the JAX name): each shard receives its left neighbour's
  last ``halo`` rows, the first shard of each ring the carried context.
  On CUDA shards every such exchange is one launch of the ring kernel
  (:mod:`comms_tpu_torch.kernels.halo_ring`), all rings and planes of the
  call together; across processes the same launch writes the tails whose
  neighbour lies in another process into that process's window (CUDA
  IPC), and a CUDA halo never takes another route.  On CPU shards the
  plain version runs (gloo's send and receive across processes);
* :func:`ring_tails`: the same with the ring wrapped (K12's contract);
* :func:`collect_ctx`: the last shard's tail, for every shard of its ring
  (a slice in one process; across processes the ring's wrap, the same
  route as the halo);
* :func:`psum` / :func:`psum_estimate`: the per-shard parts summed in
  shard order (deterministic) and given to every shard of the ring;
  across processes the parts are copied to the host, gathered over the
  process group and summed there in the same order, so the sum equals
  the one-process sum bit for bit;
* :func:`corner_turn` and :func:`all_to_all`: re-slicing of the lists
  (exact); across processes the blocks whose source and destination lie
  in two processes take the halo's route (one launch of the ring kernel
  into the destinations' windows on CUDA, gloo on the CPU), the blocks
  within a process stay where they are.

``axis`` names one mesh axis, or a tuple of names (the flattened ring
over them, as JAX's tuple axes).  The public steps of the sharded layer
take global tensors or :class:`Sharded` values (``multihost.host_feed``)
and return global tensors on a one-process mesh, :class:`Sharded` values
(this process's shards, JAX's ``addressable_shards``) across processes
(:func:`shard`, :func:`unshard`).
"""

from __future__ import annotations

import collections
import itertools

import numpy as np
import torch
import torch.distributed as dist

from comms_tpu_torch.kernels import halo_ring as _HR

__all__ = ["Mesh", "Sharded", "time_mesh", "shard", "unshard",
           "halo_exchange", "halo_exchange_rdma", "ring_tails",
           "collect_ctx", "all_gather", "psum", "psum_estimate",
           "corner_turn", "all_to_all"]


def _indexed(d: torch.device) -> torch.device:
    """"cuda" as the current CUDA device, so that "cuda" and "cuda:0" name
    one card (raises where PyTorch has no CUDA)."""
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


class Mesh:
    """A device mesh: ``devices`` (one ``torch.device`` per shard,
    row-major over ``shape``), one name per axis, and the process that
    owns each shard (``owners``, ranks; all 0 in one process) seen from
    process ``rank``.  ``shape`` reads as JAX's ``mesh.shape``: a dict of
    axis name to size.  ``local``: the global indices of this process's
    shards, in shard order; ``slot[s]``: shard ``s``'s position in them.
    This process's shards must lie on one card (or on the CPU): a mesh
    over several cards runs as one process per card."""

    def __init__(self, devices, shape, axis_names, owners=None,
                 rank: int = 0):
        self.owners = ([0] * len(devices) if owners is None
                       else [int(o) for o in owners])
        self.rank = int(rank)
        if len(self.owners) != len(devices):
            raise ValueError("one owner per device of the mesh")
        self.local = [s for s, o in enumerate(self.owners) if o == self.rank]
        if not self.local:
            raise ValueError(f"no shard of the mesh lies in process "
                             f"{self.rank}")
        self.slot = {s: k for k, s in enumerate(self.local)}
        self.devices = [_indexed(torch.device(d)) if o == self.rank
                        else torch.device(d)
                        for d, o in zip(devices, self.owners)]
        self.axis_names = tuple(axis_names)
        sizes = tuple(int(s) for s in shape)
        if len(sizes) != len(self.axis_names):
            raise ValueError("one axis name per mesh dimension")
        if int(np.prod(sizes)) != len(self.devices):
            raise ValueError(f"mesh shape {sizes} needs "
                             f"{int(np.prod(sizes))} devices, got "
                             f"{len(self.devices)}")
        self.shape = dict(zip(self.axis_names, sizes))
        mine = {self.devices[s] for s in self.local}
        if "cuda" in {d.type for d in mine} and len(mine) > 1:
            raise ValueError(
                f"the mesh's shards in one process lie on {len(mine)} "
                "devices: a mesh over several cards runs as one process "
                "per card (comms_tpu_torch.parallel.multihost.pod_mesh)")
        for d in mine:
            torch.empty(0, device=d)        # raises where there is no such
                                            # device (no card: no CUDA mesh)

    @property
    def spans_processes(self) -> bool:
        """Whether the shards lie in more than one process."""
        return len(self.local) != len(self.owners)

    def local_axis_index(self, axis):
        """:meth:`axis_index` of this process's shards, in their order."""
        idx = self.axis_index(axis)
        return [idx[s] for s in self.local]

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


def _spec_axes(mesh: Mesh, spec, ndim=None):
    spec = tuple(spec)
    if ndim is not None:
        spec = spec + (None,) * (ndim - len(spec))
    return [None if a is None else mesh._axes(a) for a in spec]


def _block_index(mesh: Mesh, s: int, names) -> int:
    """Shard ``s``'s block along a dimension split over ``names``."""
    c = mesh.coords(s)
    k = 0
    for a in names:
        k = k * mesh.shape[a] + c[a]
    return k


Shard = collections.namedtuple("Shard", "index data")


class Sharded:
    """A global value of a mesh held as this process's shards: the
    counterpart of a JAX global array across processes.  ``shards``: the
    tensors of ``mesh.local``, in order; ``shape``: the global shape;
    ``spec``: the layout (as :func:`shard`'s).  ``addressable_shards``
    gives each shard with its global ``index`` (a tuple of slices, as
    JAX's ``Shard.index``) and its ``data``."""

    def __init__(self, shards, shape, mesh: Mesh, spec):
        self.shards = list(shards)
        self.shape = torch.Size(shape)
        self.mesh = mesh
        self.spec = tuple(spec) + (None,) * (len(self.shape) - len(spec))
        if len(self.shards) != len(mesh.local):
            raise ValueError(f"{len(self.shards)} shards for the "
                             f"{len(mesh.local)} of this process")

    @property
    def ndim(self) -> int:
        return len(self.shape)

    @property
    def addressable_shards(self):
        axes = _spec_axes(self.mesh, self.spec)
        out = []
        for s, x in zip(self.mesh.local, self.shards):
            index = []
            for dim, names in enumerate(axes):
                if names is None:
                    index.append(slice(None))
                    continue
                k, n = _block_index(self.mesh, s, names), x.shape[dim]
                index.append(slice(k * n, (k + 1) * n))
            out.append(Shard(tuple(index), x))
        return out


def shard(x, mesh: Mesh, spec):
    """This process's shards of ``x`` under ``spec`` (one mesh axis, a
    tuple of axes, or None per dimension of ``x``, as JAX's
    ``PartitionSpec``); unnamed mesh axes replicate.  ``x`` is a global
    tensor (each view a ``narrow`` of it, no copy; across processes every
    process holds it whole and takes its own shards) or a
    :class:`Sharded` value laid out under the same spec (its shards)."""
    if isinstance(x, Sharded):
        if x.mesh.owners != mesh.owners or x.mesh.shape != mesh.shape:
            raise ValueError("the sharded value lies on another mesh")
        if (_spec_axes(mesh, x.spec)
                != _spec_axes(mesh, spec, len(x.shape))):
            raise ValueError(f"the sharded value's layout {x.spec} is not "
                             f"{tuple(spec)}")
        return list(x.shards)
    axes = _spec_axes(mesh, spec)
    out = []
    for s in mesh.local:
        v = x
        for dim, names in enumerate(axes):
            if names is None:
                continue
            parts = mesh.axis_size(names)
            if x.shape[dim] % parts:
                raise ValueError(f"dimension {dim} of length {x.shape[dim]} "
                                 f"does not divide over {parts} shards")
            step = x.shape[dim] // parts
            v = v.narrow(dim, _block_index(mesh, s, names) * step, step)
        out.append(v)
    return out


def unshard(xs, mesh: Mesh, spec):
    """The global value of this process's shards ``xs`` laid out under
    ``spec`` (the inverse of :func:`shard`): in one process the global
    tensor (a replicated axis reads its first shard); across processes a
    :class:`Sharded` value, this process's shards with their places."""
    if mesh.spans_processes:
        axes = _spec_axes(mesh, spec, xs[0].ndim)
        shape = [n if names is None else n * mesh.axis_size(names)
                 for n, names in zip(xs[0].shape, axes)]
        return Sharded(xs, shape, mesh, spec)
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
    return list(v) if isinstance(v, (list, tuple)) else [v] * len(mesh.local)


def halo_exchange(xs, ctx, halo: int, mesh: Mesh, axis="time"):
    """For each of this process's shards, the ``halo`` rows preceding its
    chunk along dim 0: its left neighbour's tail along ``axis``, or the
    carried context ``ctx`` on the first shard of each ring.  ``xs`` may
    be one list of shard tensors or a tuple of such lists (planes),
    exchanged in the same launch; ``ctx`` is one tensor for every ring, a
    list with one per shard (the first shard of each ring reads its own),
    or a tuple of those, one per plane.  Returns a list per shard (or a
    tuple of them).  Checks ``halo > len`` and short-circuits at ``halo ==
    0``; a ring of one shard returns the context."""
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
    out = [[None] * len(mesh.local) for _ in xss]
    if len(rings[0]) == 1:
        for p, plane in enumerate(xss):
            for k, x in enumerate(plane):
                out[p][k] = _cast_like(pctx[p][k], x)
        return tuple(out) if planes else out[0]
    slot = mesh.slot
    tensors, firsts, order = [], [], []
    for p, plane in enumerate(xss):
        for ring in rings:
            tensors.append([_contiguous_tail(plane[slot[s]], halo)
                            if s in slot else None for s in ring])
            k = slot.get(ring[0])
            firsts.append(None if k is None else
                          _cast_like(pctx[p][k], plane[k])
                          .reshape((halo,) + tuple(plane[0].shape[1:])))
            order.append((p, ring))
    if mesh.spans_processes:
        got = _HR.exchange_across(
            tensors, [[mesh.owners[s] for s in r] for _, r in order], halo,
            firsts, like=_contiguous_tail(xss[0][0], halo))
    else:
        got = _HR.exchange(tensors, halo, firsts)
    for (p, ring), recv in zip(order, got):
        for s, r in zip(ring, recv):
            if s in slot:
                out[p][slot[s]] = r
    return tuple(out) if planes else out[0]


def _contiguous_tail(x, halo: int):
    t = x[-halo:]
    return t if t.is_contiguous() else t.contiguous()


# The JAX package's second route (a Pallas RDMA ring beside the XLA
# ppermute, with one contract and bit-equal results) has one counterpart:
# the ring kernel.
halo_exchange_rdma = halo_exchange


def ring_tails(xs, halo: int, mesh: Mesh, axis="time"):
    """For each of this process's shards, its left neighbour's last
    ``halo`` rows along ``axis``, the ring wrapped (the first shard gets
    the last shard's): K12's own contract.  ``xs`` one list of shard
    tensors or a tuple of planes, all in one launch; a ring of one shard
    gets None."""
    planes = isinstance(xs, tuple)
    xss = list(xs) if planes else [xs]
    halo = int(halo)
    rings = mesh.rings(axis)
    out = [[None] * len(mesh.local) for _ in xss]
    if len(rings[0]) > 1:
        slot = mesh.slot
        tensors = [[plane[slot[s]] if s in slot else None for s in ring]
                   for plane in xss for ring in rings]
        if mesh.spans_processes:
            got = _HR.exchange_across(
                tensors, [[mesh.owners[s] for s in ring]
                          for _ in xss for ring in rings], halo,
                like=_contiguous_tail(xss[0][0], halo))
        else:
            got = _HR.exchange(tensors, halo)
        k = 0
        for p in range(len(xss)):
            for ring in rings:
                for s, t in zip(ring, got[k]):
                    if s in slot:
                        out[p][slot[s]] = t
                k += 1
    return tuple(out) if planes else out[0]


def collect_ctx(xs, halo: int, mesh: Mesh, axis="time"):
    """The next block's stream context: the last shard's ``halo`` rows,
    for every shard of its ring (this process's shards).  ``xs`` one list
    of shard tensors or a tuple of planes.  In one process a slice
    (exact); across processes the owner of the last shard sends its tail
    to every other process of the ring, on the halo's route (the ring
    kernel into their windows on CUDA; gloo on the CPU)."""
    planes = isinstance(xs, tuple)
    xss = list(xs) if planes else [xs]
    halo = int(halo)
    slot = mesh.slot
    rings = mesh.rings(axis)
    out = [[None] * len(mesh.local) for _ in xss]
    if not mesh.spans_processes:
        for p, plane in enumerate(xss):
            for ring in rings:
                last = plane[ring[-1]]
                tail = last[last.shape[0] - halo:].clone()
                for s in ring:
                    out[p][s] = tail
        return tuple(out) if planes else out[0]
    like = xss[0][0][:halo]
    pairs, order = [], []
    for p, plane in enumerate(xss):
        if (plane[0].dtype is not like.dtype
                or plane[0].shape[1:] != like.shape[1:]):
            raise ValueError("every plane must share the dtype and the "
                             "trailing shape of the first")
        for ring in rings:
            src = mesh.owners[ring[-1]]
            k = slot.get(ring[-1])
            tail = None if k is None else _contiguous_tail(plane[k], halo)
            for r in sorted({mesh.owners[s] for s in ring}):
                pairs.append((src, tail, r))
                order.append((p, ring, r))
    got = _HR.transfer(pairs, like)
    for (p, ring, r), t in zip(order, got):
        if r == mesh.rank:
            for s in ring:
                if s in slot:
                    out[p][slot[s]] = t
    return tuple(out) if planes else out[0]


def _from_bytes(b, dtype, shape):
    """``b`` (uint8, a whole tensor's bytes) viewed as ``dtype`` of
    ``shape``."""
    if dtype.is_complex:
        real = torch.empty(0, dtype=dtype).real.dtype
        return torch.view_as_complex(b.view(real).view(*shape, 2))
    return b.view(dtype).view(shape)


def _gather_parts(parts, mesh: Mesh):
    """Every shard's part, by global shard index, on the host: each
    process stacks its parts per leaf, copies them to the host and
    all-gathers their bytes over the process group."""
    counts = collections.Counter(mesh.owners)
    if len(set(counts.values())) != 1:
        raise ValueError("a psum across processes needs the same number "
                         "of shards in every process")
    tup = isinstance(parts[0], tuple)
    leaves = [tuple(p) if tup else (p,) for p in parts]
    world = len(counts)
    ranks = sorted(counts)
    cols = []
    for j in range(len(leaves[0])):
        stacked = torch.stack([torch.as_tensor(lv[j]) for lv in leaves]
                              ).cpu().contiguous()
        b = _HR._as_bytes(stacked)
        bufs = [torch.empty_like(b) for _ in range(world)]
        dist.all_gather(bufs, b)
        cols.append([_from_bytes(x, stacked.dtype, stacked.shape)
                     for x in bufs])
    full = [None] * mesh.size
    seen = collections.Counter()
    for s, o in enumerate(mesh.owners):
        k = seen[o]
        seen[o] += 1
        vals = tuple(col[ranks.index(o)][k] for col in cols)
        full[s] = vals if tup else vals[0]
    return full


def all_gather(parts, mesh: Mesh):
    """Every shard's part (a tensor each), by global shard index, on the
    parts' device: across processes copied to the host, gathered over
    the process group and copied back (the bytes unchanged)."""
    if not mesh.spans_processes:
        return list(parts)
    dev = parts[0].device
    return [p.to(dev) for p in _gather_parts(parts, mesh)]


def psum(parts, mesh: Mesh, axis="time"):
    """Per ring, the sum of the shards' parts in shard order, for every
    shard of the ring (this process's shards).  A part may be a tensor or
    a tuple of tensors.  Across processes the parts are copied to the
    host, gathered over the process group (no ``all_reduce``, whose order
    is the backend's) and summed there in shard order; float additions
    round alike on the host and the card, so the sum is the one-process
    sum bit for bit; it then returns to this process's device."""
    slot = mesh.slot
    across = mesh.spans_processes
    full = _gather_parts(parts, mesh) if across else parts
    dev = None
    if across:
        p0 = parts[0][0] if isinstance(parts[0], tuple) else parts[0]
        dev = torch.as_tensor(p0).device
    out = [None] * len(mesh.local)
    for ring in mesh.rings(axis):
        if not any(s in slot for s in ring):
            continue
        acc = full[ring[0]]
        for s in ring[1:]:
            acc = (tuple(a + b for a, b in zip(acc, full[s]))
                   if isinstance(acc, tuple) else acc + full[s])
        if across:
            acc = (tuple(a.to(dev) for a in acc) if isinstance(acc, tuple)
                   else acc.to(dev))
        for s in ring:
            if s in slot:
                out[slot[s]] = acc
    return out


def psum_estimate(partial_sums, mesh: Mesh, axis="time"):
    """Cross-shard reduction of estimator sums (frequency, phase, timing):
    each shard reduces its chunk, then one :func:`psum`."""
    return psum(partial_sums, mesh, axis)


def all_to_all(xs, mesh: Mesh, axis="time", split_axis: int = 0,
               concat_axis: int = 0):
    """Tiled all-to-all: shard ``t`` of a ring receives block ``t`` of every
    shard's ``split_axis`` (cut into ring-size blocks), concatenated in
    ring order along ``concat_axis``.  ``xs`` may be one list of shard
    tensors or a tuple of such lists (planes of one dtype and shape),
    exchanged in one call.  Across processes every block whose source and
    destination lie in two processes goes in one :func:`halo_ring.transfer
    <comms_tpu_torch.kernels.halo_ring.transfer>` for the whole call: on
    CUDA one launch of the ring kernel into the destinations' windows
    (strided blocks made contiguous on the card first), a barrier and the
    copy-out, no block through the host; on the CPU gloo's send and
    receive.  Every process calls it with the same rings and shapes."""
    planes = isinstance(xs, tuple)
    xss = list(xs) if planes else [xs]
    slot, owners = mesh.slot, mesh.owners
    rings = mesh.rings(axis)
    n = len(rings[0])
    x0 = xss[0][0]
    for plane in xss:
        for x in plane:
            if x.shape[split_axis] % n:
                raise ValueError(f"dimension {split_axis} of length "
                                 f"{x.shape[split_axis]} does not divide "
                                 f"over {n} shards")
            if x.dtype is not x0.dtype or x.shape != x0.shape:
                raise ValueError("every plane must share the dtype and the "
                                 "shape of the first")
    blocks = [[torch.tensor_split(x, n, dim=split_axis) for x in plane]
              for plane in xss]
    pairs, order = [], []
    for p in range(len(xss)):
        for ring in rings:
            for t, b in enumerate(ring):
                for a in ring:
                    if owners[a] == owners[b]:
                        continue
                    k = slot.get(a)
                    pairs.append((owners[a], None if k is None else
                                  blocks[p][k][t].contiguous(), owners[b]))
                    order.append((p, a, b))
    recv = (dict(zip(order, _HR.transfer(pairs, blocks[0][0][0])))
            if pairs else {})
    out = [[None] * len(mesh.local) for _ in xss]
    for p in range(len(xss)):
        for ring in rings:
            for t, b in enumerate(ring):
                if b in slot:
                    out[p][slot[b]] = torch.cat(
                        [blocks[p][slot[a]][t] if a in slot
                         else recv[(p, a, b)] for a in ring], dim=concat_axis)
    return tuple(out) if planes else out[0]


def corner_turn(ys, mesh: Mesh, axis="time"):
    """Channelizer corner turn: per-shard ``[frames_local, K]`` (time-
    sharded) -> ``[frames_global, K / n]`` (channel-sharded): shard ``t``
    of a ring holds channels ``[t*K/n, (t+1)*K/n)`` of every shard's
    frames, in ring order.  Requires K % n == 0.  ``ys`` one list of shard
    tensors or a tuple of planes, turned in one call (:func:`all_to_all`)."""
    n = mesh.axis_size(axis)
    K = (ys[0] if isinstance(ys, tuple) else ys)[0].shape[1]
    if K % n:
        raise ValueError(f"channels {K} not divisible by shards {n}")
    return all_to_all(ys, mesh, axis, split_axis=1, concat_axis=0)
