"""The ring halo exchange of the sharded layer: one CUDA kernel, and its
plain version.

    out[r][i] = rings[r][i - 1][-halo:]        for i >= 1
    out[r][0] = ctxs[r]  or  rings[r][n - 1][-halo:]   (the ring wraps)

over R rings of n shard tensors each (the same dtype and trailing shape,
rows along dim 0).  ``csrc/halo_ring.cu`` replaces the TPU kernel
``comms_tpu/kernels/halo_rdma.py::ring_halo_exchange``, whose ranks RDMA
their tails into their right neighbours' halo buffers behind a barrier
semaphore.  The port's shards share one card (``parallel.sharding.Mesh``),
so the exchange is one launch that copies every shard's tail into a fresh
buffer of its right neighbour's; the barrier becomes the stream order.
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
do tensors on more than one card (multi-card rings come with a later
slice).  Tails must be contiguous (the sharding layer makes a strided
tail contiguous first).  ``launches`` counts the kernel launches;
:func:`launch_floor` launches an empty kernel (not counted) whose time is
the launch floor on the card.
"""

from __future__ import annotations

import contextlib
import math
import struct

import torch

from comms_tpu_torch.kernels import _build

__all__ = ["exchange", "exchange_plain", "ring_halo_exchange",
           "ring_halo_exchange_plain", "source_offset", "launch_floor",
           "MAX_PAIRS"]

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
            f"the ring's shards lie on {sorted(map(str, devs))}: rings over "
            "more than one card come with a later slice")
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
    global launches
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
    for a in range(0, n, MAX_PAIRS):
        k = min(MAX_PAIRS, n - a)
        packed = struct.pack(f"{2 * k}Q", *srcs[a:a + k],
                             *range(base + a * stride,
                                    base + (a + k) * stride, stride))
        rc = lib.halo_ring_launch(packed, k, nbytes, stream)
        if rc != 0:
            raise RuntimeError(f"halo ring kernel launch failed: CUDA "
                               f"error {rc}")
        launches += 1
    return outs


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
