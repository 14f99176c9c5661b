"""The ring halo exchange of the sharded layer: one CUDA kernel, and its
plain version.

    out[r][i] = rings[r][i - 1][-halo:]        for i >= 1
    out[r][0] = ctxs[r]  or  rings[r][n - 1][-halo:]   (the ring wraps)

over R rings of n shard tensors each (the same dtype and trailing shape,
rows along dim 0).  ``csrc/halo_ring.cu`` replaces the TPU kernel
``comms_tpu/kernels/halo_rdma.py::ring_halo_exchange``, whose ranks RDMA
their tails into their right neighbours' halo buffers behind a barrier
semaphore.  Within one process the port's shards share one card
(``parallel.sharding.Mesh``), so the exchange is one launch that copies
every shard's tail into a fresh buffer of its right neighbour's; the
barrier becomes the stream order.
One launch serves the three forms the sharded layer needs:

* the wrapped ring, K12's own contract (:func:`ring_halo_exchange`);
* the ring whose first shard receives the carried context (``ctx``),
  ``sharding.halo_exchange``'s contract;
* several rings at once (:func:`exchange`): one ring per group along an
  axis of a 2-D mesh, and one per plane (re and im, or the u8 planes of
  the fused chain).  A complex tensor goes as one copy of its bytes, not
  as two planes.

The pointers travel by value in the kernel's parameter block, up to
:data:`MAX_PAIRS` (src, dst) pairs per launch; more pairs take more
launches.  Every pair moves the same number of bytes.  The received
tensors of a call are the rows of one fresh buffer, each row contiguous
and starting 16-byte aligned (the row stride is rounded up to 16 bytes),
so the kernel stores whole 16-byte words; a source may start at any
byte.  The wrapper launches the kernel for CUDA tensors and runs
:func:`exchange_plain` for CPU tensors; any other device raises, and so
do tensors on more than one card (a ring over several cards runs as one
process per card).  Tails must be contiguous (the sharding layer makes a
strided tail contiguous first).  ``launches`` counts the kernel launches;
:func:`launch_floor` launches an empty kernel (not counted) whose time is
the launch floor on the card.

**Across processes** (:func:`exchange_across`, :func:`transfer`; the
sharding layer's rings, tails and all-to-alls over meshes that span
processes, ``parallel.multihost``), the ranks
are separate processes with their own CUDA contexts, as the TPU kernel's
ranks are separate programs.  The TPU kernel's remote copy becomes the
same kernel writing into a window of the neighbour's memory mapped
through CUDA IPC (two contexts on one card, or a peer card), and its
barrier semaphore becomes interprocess events, a host barrier on the
process group and two windows a link used in turn
(:func:`_transfer_ipc`).  Windows and events are made once per shape of
call (collectively, their handles exchanged over gloo) and released by
:func:`release_windows` (``multihost.shutdown``, a new process group, or
exit).  ``cross_launches`` counts the launches that wrote into another
process's window.  On CPU tensors the plain version is gloo's send and
receive.
"""

from __future__ import annotations

import atexit
import contextlib
import ctypes
import math
import struct

import torch
import torch.distributed as dist

from comms_tpu_torch.kernels import _build
from comms_tpu_torch.runtime.metrics import named_scope, scoped

__all__ = ["exchange", "exchange_plain", "ring_halo_exchange",
           "ring_halo_exchange_plain", "source_offset", "launch_floor",
           "exchange_across", "transfer", "transfer_plain",
           "release_windows", "MAX_PAIRS"]

MAX_PAIRS = 128          # pairs in one launch's parameter block
_ALIGN = 16              # bytes: a destination row's start and stride

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


def source_offset(ptr: int) -> int:
    """The byte offset of a source in its 16-byte word: 0 takes the
    kernel's plain word copy, any other the realigned one."""
    return int(ptr) % _ALIGN


def _check(rings, halo: int, ctxs):
    if halo < 1:
        raise ValueError(f"halo must be >= 1, got {halo}")
    if not rings or not all(len(r) == len(rings[0]) and r for r in rings):
        raise ValueError("rings must be non-empty lists of one length")
    x0 = rings[0][0]
    if not isinstance(x0, torch.Tensor):
        raise TypeError(f"shards must be tensors, got {type(x0)}")
    # dtypes are singletons: `is` is a fifth of `!=`'s host time, and the
    # trailing shapes are compared only where there are any
    dtype, trailing, dev = x0.dtype, x0.shape[1:], x0.device
    nd = x0.ndim
    devs = {dev}
    for ring in rings:
        for x in ring:
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"shards must be tensors, got {type(x)}")
            if (x.dtype is not dtype or x.ndim != nd
                    or (nd > 1 and x.shape[1:] != trailing)):
                raise ValueError("every shard must share the dtype and the "
                                 "trailing shape of the first")
            if nd < 1 or x.shape[0] < halo:
                raise ValueError(f"halo {halo} exceeds a shard of shape "
                                 f"{tuple(x.shape)}")
            if x.device != dev:
                devs.add(x.device)
    if ctxs is not None:
        if len(ctxs) != len(rings):
            raise ValueError("one ctx per ring")
        for c in ctxs:
            if c.dtype is not dtype or c.shape != (halo,) + trailing:
                raise ValueError(f"ctx must be {dtype} of shape "
                                 f"{(halo,) + tuple(trailing)}, got "
                                 f"{c.dtype} {tuple(c.shape)}")
            if c.device != dev:
                devs.add(c.device)
    if len(devs) > 1:
        raise ValueError(
            f"the ring's shards lie on {sorted(map(str, devs))}: a ring "
            "over several cards runs as one process per card "
            "(comms_tpu_torch.parallel.multihost)")
    return dev


def _destinations(n: int, halo: int, like: torch.Tensor):
    """``n`` received tensors ``[halo, *trailing]``: the rows of one fresh
    buffer at a row stride rounded up to 16 bytes, so every row is
    contiguous, starts 16-byte aligned and overlaps no other.  Returns
    (rows, row stride in bytes)."""
    trailing = tuple(like.shape[1:])
    es = like.element_size()
    row_bytes = halo * math.prod(trailing) * es
    stride = -(-row_bytes // _ALIGN) * _ALIGN
    inner = [1]
    for d in reversed(trailing):
        inner.insert(0, inner[0] * d)
    buf = torch.empty_strided((n, halo) + trailing,
                              (stride // es,) + tuple(inner),
                              dtype=like.dtype, device=like.device)
    return buf.unbind(0), stride


def _launch(lib, stream, rings, halo: int, ctxs):
    """The kernel path of :func:`exchange` after its checks: one buffer of
    destinations, the source pointers (each shard's tail found by pointer
    arithmetic, without a slice), the sources' and destinations' pointers
    packed into one array per launch."""
    x0 = rings[0][0]
    row = math.prod(x0.shape[1:]) * x0.element_size()
    nbytes = halo * row
    n = len(rings) * len(rings[0])
    rows, stride = _destinations(n, halo, x0)
    outs = [list(rows[i:i + len(rings[0])])
            for i in range(0, n, len(rings[0]))]
    if nbytes == 0:
        return outs
    if nbytes >= 1 << 31:
        raise ValueError(f"the halo kernel copies less than 2 GiB a shard, "
                         f"got {nbytes} bytes")
    srcs, keep = [], []
    for r, ring in enumerate(rings):
        ptrs = []
        for x in ring:
            if x.is_contiguous():
                ptrs.append(x.data_ptr() + (x.shape[0] - halo) * row)
            else:
                t = x[-halo:]
                if not t.is_contiguous():
                    raise ValueError("the halo kernel copies contiguous "
                                     "tails; make the tail contiguous first")
                ptrs.append(t.data_ptr())
        if ctxs is None:
            srcs.append(ptrs[-1])
        else:
            c = ctxs[r].contiguous()
            keep.append(c)
            srcs.append(c.data_ptr())
        srcs += ptrs[:-1]
    base = rows[0].data_ptr()
    _launch_pairs(lib, stream, srcs,
                  range(base, base + n * stride, stride), nbytes)
    return outs


def _launch_pairs(lib, stream, srcs, dsts, nbytes: int) -> int:
    """Launch the kernel over the (src, dst) pointer pairs, up to
    :data:`MAX_PAIRS` a launch; returns the number of launches."""
    global launches
    n = len(srcs)
    for a in range(0, n, MAX_PAIRS):
        k = min(MAX_PAIRS, n - a)
        packed = struct.pack(f"{2 * k}Q", *srcs[a:a + k], *dsts[a:a + k])
        rc = lib.halo_ring_launch(packed, k, nbytes, stream)
        if rc != 0:
            raise RuntimeError(f"halo ring kernel launch failed: CUDA "
                               f"error {rc}")
        launches += 1
    return -(-n // MAX_PAIRS)


@scoped("kernel.halo_ring")
def exchange(rings, halo: int, ctxs=None):
    """One ring shift of every ring (module docstring).  ``rings``: list of
    rings, each a list of shard tensors in ring order; ``ctxs``: None (the
    ring wraps) or one ``[halo, ...]`` tensor per ring for its first shard.
    Returns, per ring, the list of received ``[halo, ...]`` tensors (rows
    of one fresh buffer).  On a CUDA device the kernel is launched on the
    current stream and not waited for."""
    halo = int(halo)
    dev = _check(rings, halo, ctxs)
    if dev.type == "cpu":
        return exchange_plain(rings, halo, ctxs)
    if dev.type != "cuda":
        raise ValueError(f"the halo exchange runs on CUDA or CPU tensors, "
                         f"got {dev}")
    lib = _build.load()
    # The launch goes to the current device: switch only where the shards
    # lie on another, and read the current stream's raw handle (a device
    # switch and a Stream object each cost about as much host time as the
    # launch itself).
    idx = dev.index
    with (contextlib.nullcontext() if idx == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        return _launch(lib, torch._C._cuda_getCurrentRawStream(idx),
                       rings, halo, ctxs)


def exchange_plain(rings, halo: int, ctxs=None):
    """:func:`exchange`'s function in plain PyTorch, on any device: the
    stacked tails rolled one shard along the ring."""
    halo = int(halo)
    _check(rings, halo, ctxs)
    outs = []
    for r, ring in enumerate(rings):
        rolled = torch.roll(torch.stack([x[-halo:] for x in ring]), 1, 0)
        if ctxs is not None:
            rolled[0] = ctxs[r]
        outs.append(list(rolled.unbind(0)))
    return outs


def ring_halo_exchange(xs, halo: int, ctx=None):
    """One ring: shard i receives shard i-1's last ``halo`` rows; shard 0
    receives shard n-1's (K12's contract) or ``ctx`` when given."""
    return exchange([list(xs)], halo, None if ctx is None else [ctx])[0]


def ring_halo_exchange_plain(xs, halo: int, ctx=None):
    """:func:`ring_halo_exchange`'s function in plain PyTorch."""
    return exchange_plain([list(xs)], halo,
                          None if ctx is None else [ctx])[0]


def launch_floor(big: bool, blocks: int = 1, device="cuda") -> None:
    """Launch the empty kernel of ``csrc/halo_ring.cu`` on ``device``'s
    current stream: ``blocks`` blocks of 256 threads and a parameter block
    of K12's 128-pair size (``big``, 2,056 bytes) or of 16 bytes.  Its
    device time is the launch floor beside K12's; ``launches`` does not
    count it."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"the launch floor is a CUDA kernel, got {dev}")
    lib = _build.load()
    with torch.cuda.device(dev):
        rc = lib.halo_ring_floor_launch(
            int(bool(big)), int(blocks),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"launch floor kernel failed: CUDA error {rc}")


# ---------------------------------------------------------------------------
# The cross-process form: ranks in separate processes (parallel.multihost).

# Launches that carried a pair into another process's window (a part of
# ``launches``, which counts every launch).
cross_launches = 0


def _as_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous tensor's bytes as a uint8 view of its storage."""
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.reshape(-1).view(torch.uint8)


def _pairs_of_rings(rings, owners, halo: int, ctxs, rank: int):
    """The (src rank, src tail or None, dst rank) pairs of one ring shift,
    in one global order that every process computes alike: ring by ring,
    shard by shard; a ring's first shard takes its ``ctx`` (a pair within
    its owner) or, without contexts, the ring's last tail."""
    pairs, like = [], None
    for r, (ring, own) in enumerate(zip(rings, owners)):
        if len(ring) != len(own) or not ring:
            raise ValueError("one owner per shard of every ring")
        n = len(ring)
        for i in range(n):
            if ctxs is not None and i == 0:
                c = ctxs[r] if own[0] == rank else None
                if c is not None:
                    c = c.contiguous()
                pairs.append((own[0], c, own[0]))
                continue
            j = (i - 1) % n
            x = ring[j] if own[j] == rank else None
            if x is not None:
                if x.ndim < 1 or x.shape[0] < halo:
                    raise ValueError(f"halo {halo} exceeds a shard of shape "
                                     f"{tuple(x.shape)}")
                x = x[x.shape[0] - halo:]
                if not x.is_contiguous():
                    raise ValueError("the halo kernel copies contiguous "
                                     "tails; make the tail contiguous first")
            pairs.append((own[j], x, own[i]))
    for _, x, _ in pairs:
        if x is not None:
            like = like if like is not None else x
            if (x.dtype is not like.dtype or x.shape != like.shape
                    or x.device != like.device):
                raise ValueError(
                    f"every shard must share the dtype, the trailing shape "
                    f"and the device of the first; a ctx must be "
                    f"{like.dtype} of shape {tuple(like.shape)}, got "
                    f"{x.dtype} {tuple(x.shape)} on {x.device}")
    return pairs, like


def exchange_across(rings, owners, halo: int, ctxs=None, like=None):
    """:func:`exchange` over rings whose shards lie in several processes.

    ``rings``: list of rings, each a list in ring order holding this
    process's shard tensors and None for the shards of other processes;
    ``owners``: the same lists of the shards' process ranks; ``ctxs``:
    None (the ring wraps) or, per ring, the ``[halo, ...]`` context of its
    first shard (None where another process owns that shard).  ``like``:
    a ``[halo, ...]`` tensor of the rings' dtype and device, for a process
    that only receives.  Every process of the group calls this with the
    same rings (its own tensors in them), as an SPMD program does.
    Returns, per ring, the received ``[halo, ...]`` tensors of this
    process's shards (None for the others).

    CUDA shards go through the kernel: one launch carries this process's
    pairs, those within it and those into its neighbours' windows
    (:func:`transfer`); CPU shards through the plain version, gloo's
    send and receive."""
    halo = int(halo)
    if halo < 1:
        raise ValueError(f"halo must be >= 1, got {halo}")
    if not dist.is_initialized():
        raise ValueError("a ring across processes needs the process group "
                         "(parallel.multihost.init)")
    rank = dist.get_rank()
    if len(owners) != len(rings) or (ctxs is not None
                                     and len(ctxs) != len(rings)):
        raise ValueError("one owner list and one ctx per ring")
    pairs, mine = _pairs_of_rings(rings, owners, halo, ctxs, rank)
    like = mine if mine is not None else like
    if like is None:
        raise ValueError("this process holds no shard of the rings: pass "
                         "like=")
    got = transfer(pairs, like)
    out, k = [], 0
    for ring, own in zip(rings, owners):
        out.append([got[k + i] if own[i] == rank else None
                    for i in range(len(ring))])
        k += len(ring)
    return out


def transfer(pairs, like):
    """The byte copies of ``pairs`` between processes: each pair is (src
    rank, src, dst rank), ``src`` a contiguous tensor of ``like``'s dtype
    and shape (a halo's tail, a ring's last tail, an all-to-all's block)
    where this process is the source, else None.  Every process of the
    group passes the same pairs in the same order, also one that sends and
    receives none of them.  Returns, per pair, the received tensor where
    this process is the destination, else None.

    On CUDA every pair this process sends, within it or into a window of
    its destination, goes in one launch of the kernel; then a host
    barrier; then each window that received is copied out
    (:func:`_transfer_ipc` sets out the order).  On the CPU: gloo's
    isend and irecv, a clone within a process.  Any other device raises."""
    if like.device.type == "cpu":
        return transfer_plain(pairs, like)
    if like.device.type != "cuda":
        raise ValueError(f"the halo exchange runs on CUDA or CPU tensors, "
                         f"got {like.device}")
    return _transfer_ipc(pairs, like)


def transfer_plain(pairs, like):
    """:func:`transfer`'s function on CPU tensors: gloo's isend and irecv
    (one tag a pair), a clone where a pair stays in this process."""
    rank = dist.get_rank()
    out, reqs = [None] * len(pairs), []
    for tag, (s, x, d) in enumerate(pairs):
        if s == rank and d == rank:
            out[tag] = x.clone()
        elif s == rank:
            reqs.append(dist.isend(_as_bytes(x), d, tag=tag))
        elif d == rank:
            y = torch.empty_like(like, memory_format=torch.contiguous_format)
            reqs.append(dist.irecv(_as_bytes(y), s, tag=tag))
            out[tag] = y
    for q in reqs:
        q.wait()
    return out


class _Link:
    """One direction (src rank -> dst rank) of one plan: the destination's
    two windows (its own memory there, mapped at the source) and, per
    window, the source's ``written`` event and the destination's ``freed``
    event, each open in the other process."""

    __slots__ = ("windows", "written", "freed")

    def __init__(self):
        self.windows = [None, None]
        self.written = [None, None]
        self.freed = [None, None]


class _Plan:
    """The windows and events of one shape of call: the directed links
    with their pair counts, the row stride, the device.  ``uses`` picks
    the window: calls alternate between the two."""

    def __init__(self):
        self.links = {}
        self.uses = 0


_plans = {}
_owned = []              # (kind, handle): "window", "mapped", "event"
_plans_group = None
_at_exit = False


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} failed: CUDA error {rc}")


def _new_window(lib, nbytes: int):
    p, h = ctypes.c_void_p(), ctypes.create_string_buffer(
        lib.halo_ipc_handle_bytes())
    _check_rc(lib.halo_ipc_window_alloc(nbytes, ctypes.byref(p), h),
              "cudaMalloc of a halo window")
    _owned.append(("window", p.value))
    return p.value, h.raw


def _new_event(lib):
    e, h = ctypes.c_void_p(), ctypes.create_string_buffer(
        lib.halo_ipc_handle_bytes())
    _check_rc(lib.halo_ipc_event_create(ctypes.byref(e), h),
              "an interprocess event")
    _owned.append(("event", e.value))
    return e.value, h.raw


def _open_window(lib, handle: bytes):
    p = ctypes.c_void_p()
    _check_rc(lib.halo_ipc_window_open(handle, ctypes.byref(p)),
              "cudaIpcOpenMemHandle of a neighbour's halo window")
    _owned.append(("mapped", p.value))
    return p.value


def _open_event(lib, handle: bytes):
    e = ctypes.c_void_p()
    _check_rc(lib.halo_ipc_event_open(handle, ctypes.byref(e)),
              "cudaIpcOpenEventHandle of a neighbour's event")
    _owned.append(("event", e.value))
    return e.value


def _room_for(links, stride: int, rank: int) -> None:
    """Raise, in every process of the group alike, where a destination
    has no room on its card for the two windows a link of a new plan
    (collective; checked before any window is allocated)."""
    need = sum(2 * count * stride for (_, d), count in links.items()
               if d == rank)
    free = torch.cuda.mem_get_info()[0]
    if need > free:
        torch.cuda.empty_cache()
        free = torch.cuda.mem_get_info()[0]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, (need, free))
    short = [(r, n, f) for r, (n, f) in enumerate(every) if n > f]
    if short:
        raise ValueError(
            "the halo windows of this call do not fit on the card: " +
            "; ".join(f"process {r} needs {n} bytes for two windows a link, "
                      f"{f} are free" for r, n, f in short) +
            " (every window plan stays until release_windows)")


def _setup(lib, links, stride: int, rank: int):
    """A new plan (collective: every process of the group calls it for
    the same call): each destination allocates its two windows and
    ``freed`` events per link, each source its ``written`` events; the
    64-byte handles go round once through ``all_gather_object``; each
    process opens its peers' windows and events that it uses.  Raises
    before allocating where a destination's card has no room for its
    windows (:func:`_room_for`)."""
    global _plans_group, _at_exit
    if _plans_group is not dist.group.WORLD:
        release_windows()
        _plans_group = dist.group.WORLD
    _room_for(links, stride, rank)
    if not _at_exit:
        atexit.register(release_windows)
        _at_exit = True
    plan, mine = _Plan(), {}
    for (s, d), count in links.items():
        link = plan.links[(s, d)] = _Link()
        if d == rank:
            wins = [_new_window(lib, count * stride) for _ in range(2)]
            freed = [_new_event(lib) for _ in range(2)]
            link.windows = [p for p, _ in wins]
            link.freed = [e for e, _ in freed]
            mine.setdefault((s, d), {}).update(
                windows=[h for _, h in wins], freed=[h for _, h in freed])
        if s == rank:
            written = [_new_event(lib) for _ in range(2)]
            link.written = [e for e, _ in written]
            mine.setdefault((s, d), {})["written"] = [h for _, h in written]
    every = [None] * dist.get_world_size()
    dist.all_gather_object(every, mine)
    for (s, d), link in plan.links.items():
        if s == rank:
            peer = every[d][(s, d)]
            link.windows = [_open_window(lib, h) for h in peer["windows"]]
            link.freed = [_open_event(lib, h) for h in peer["freed"]]
        if d == rank:
            link.written = [_open_event(lib, h)
                            for h in every[s][(s, d)]["written"]]
    return plan


def _transfer_ipc(pairs, like):
    """:func:`transfer` on CUDA.  Order, per call, with window w = the
    plan's uses mod 2: a source's stream waits for the destination's
    ``freed[w]`` (recorded after that window's copy-out two calls ago),
    launches the kernel over its pairs (those into the destination's
    window w among them) and records ``written[w]``; a host barrier on
    the process group puts every record before every wait on it; each
    destination's stream waits for ``written[w]``, copies window w out
    into a fresh buffer and records ``freed[w]``.  So no write lands in a
    window whose last halo is not yet copied out, and no copy-out starts
    before the write: the barrier semaphore's two guarantees, with no
    kernel spinning on a flag."""
    global cross_launches
    rank = dist.get_rank()
    dev = like.device
    es = like.element_size()
    nbytes = like.numel() * es
    stride = -(-nbytes // _ALIGN) * _ALIGN
    out = [None] * len(pairs)
    links = {}
    for i, (s, _, d) in enumerate(pairs):
        if s != d:
            links.setdefault((s, d), []).append(i)
    if nbytes == 0:
        for i, (s, _, d) in enumerate(pairs):
            if d == rank:
                out[i] = like.new_empty(like.shape)
        return out
    if nbytes >= 1 << 31:
        raise ValueError(f"the halo kernel copies less than 2 GiB a shard, "
                         f"got {nbytes} bytes")
    lib = _build.load()
    idx = dev.index
    with (contextlib.nullcontext() if idx == torch.cuda.current_device()
          else torch.cuda.device(dev)):
        stream = torch._C._cuda_getCurrentRawStream(idx)
        plan = None
        if links:
            key = (tuple((s, d, len(v)) for (s, d), v in links.items()),
                   stride, idx)
            plan = _plans.get(key)
            if plan is None or _plans_group is not dist.group.WORLD:
                plan = _plans[key] = _setup(
                    lib, {k: len(v) for k, v in links.items()}, stride, rank)
        w = plan.uses % 2 if plan else 0
        local = [i for i, (s, _, d) in enumerate(pairs) if s == d == rank]
        srcs, dsts = [], []
        if local:
            rows, _ = _destinations(len(local), like.shape[0], like)
            for i, r in zip(local, rows):
                srcs.append(pairs[i][1].data_ptr())
                dsts.append(r.data_ptr())
                out[i] = r
        sends = [(k, v) for k, v in links.items() if k[0] == rank]
        if sends:
            freed = [plan.links[k].freed[w] for k, _ in sends]
            _check_rc(lib.halo_ipc_wait_record(
                (ctypes.c_void_p * len(freed))(*freed), len(freed), None,
                stream), "a wait on a neighbour's window")
            for k, v in sends:
                base = plan.links[k].windows[w]
                for j, i in enumerate(v):
                    srcs.append(pairs[i][1].data_ptr())
                    dsts.append(base + j * stride)
        if srcs:
            with named_scope("kernel.halo_ring"):
                n = _launch_pairs(lib, stream, srcs, dsts, nbytes)
            if sends:
                cross_launches += n
        for k, _ in sends:
            _check_rc(lib.halo_ipc_wait_record(
                None, 0, plan.links[k].written[w], stream),
                "the record of a written window")
        if not links:
            return out
        plan.uses += 1
        dist.barrier()
        for k, v in links.items():
            if k[1] != rank:
                continue
            link = plan.links[k]
            buf = torch.empty(len(v) * stride, dtype=torch.uint8, device=dev)
            _check_rc(lib.halo_ipc_copy_out(
                link.written[w], link.windows[w], buf.data_ptr(),
                len(v) * stride, link.freed[w], stream),
                "the copy-out of a halo window")
            for j, i in enumerate(v):
                out[i] = (buf[j * stride:j * stride + nbytes]
                          .view(like.dtype).view(like.shape))
    return out


def release_windows(barrier: bool = False) -> None:
    """Close the neighbours' windows and events that this process opened
    and free its own, after the card has finished with them.  With
    ``barrier`` every process of the group has closed its mappings
    before any frees (the orderly end of ``multihost.shutdown``); at exit,
    or when the process group was replaced, each process frees alone.
    Runs at exit once a plan was made."""
    global _plans_group
    if not _owned:
        _plans.clear()
        return
    lib = _build.load()
    torch.cuda.synchronize()
    for kind, h in _owned:
        if kind == "mapped":
            lib.halo_ipc_window_close(h)
    if barrier:
        dist.barrier()
    for kind, h in _owned:
        if kind == "event":
            lib.halo_ipc_event_destroy(h)
        elif kind == "window":
            lib.halo_ipc_window_free(h)
    _owned.clear()
    _plans.clear()
    _plans_group = None
