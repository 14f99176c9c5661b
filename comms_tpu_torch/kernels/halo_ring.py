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
launches.  Every pair moves the same number of bytes.  The wrapper
launches the kernel for CUDA tensors and runs :func:`exchange_plain` for
CPU tensors; any other device raises, and so do tensors on more than one
card (multi-card rings come with a later slice).  Tails must be
contiguous (the sharding layer makes a strided tail contiguous first).
``launches`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from comms_tpu_torch.kernels import _build

__all__ = ["exchange", "exchange_plain", "ring_halo_exchange",
           "ring_halo_exchange_plain", "copy_width", "MAX_PAIRS"]

MAX_PAIRS = 128          # pairs in one launch's parameter block

# Kernel launches since import (or since a caller reset it to 0).
launches = 0


def copy_width(ptrs, nbytes: int) -> int:
    """Bytes per copy of the kernel for these pointers and length: 16 when
    all are 16-byte aligned, 4 when all are 4-byte aligned, else 1."""
    bits = int(nbytes)
    for p in ptrs:
        bits |= int(p)
    return 16 if bits % 16 == 0 else (4 if bits % 4 == 0 else 1)


def _check(rings, halo: int, ctxs):
    if halo < 1:
        raise ValueError(f"halo must be >= 1, got {halo}")
    if not rings or not all(len(r) == len(rings[0]) and r for r in rings):
        raise ValueError("rings must be non-empty lists of one length")
    x0 = rings[0][0]
    devs = set()
    for ring in rings:
        for x in ring:
            if not isinstance(x, torch.Tensor):
                raise TypeError(f"shards must be tensors, got {type(x)}")
            if x.dtype != x0.dtype or x.shape[1:] != x0.shape[1:]:
                raise ValueError("every shard must share the dtype and the "
                                 "trailing shape of the first")
            if x.ndim < 1 or x.shape[0] < halo:
                raise ValueError(f"halo {halo} exceeds a shard of shape "
                                 f"{tuple(x.shape)}")
            devs.add(x.device)
    if ctxs is not None:
        if len(ctxs) != len(rings):
            raise ValueError("one ctx per ring")
        for c in ctxs:
            if (c.dtype != x0.dtype or c.shape != (halo,) + x0.shape[1:]):
                raise ValueError(f"ctx must be {x0.dtype} of shape "
                                 f"{(halo,) + tuple(x0.shape[1:])}, got "
                                 f"{c.dtype} {tuple(c.shape)}")
            devs.add(c.device)
    if len(devs) > 1:
        raise ValueError(
            f"the ring's shards lie on {sorted(map(str, devs))}: rings over "
            "more than one card come with a later slice")
    return devs.pop()


def exchange(rings, halo: int, ctxs=None):
    """One ring shift of every ring (module docstring).  ``rings``: list of
    rings, each a list of shard tensors in ring order; ``ctxs``: None (the
    ring wraps) or one ``[halo, ...]`` tensor per ring for its first shard.
    Returns, per ring, the list of received ``[halo, ...]`` tensors (fresh
    buffers).  On a CUDA device the kernel is launched on the current
    stream and not waited for."""
    global launches
    halo = int(halo)
    dev = _check(rings, halo, ctxs)
    if dev.type == "cpu":
        return exchange_plain(rings, halo, ctxs)
    if dev.type != "cuda":
        raise ValueError(f"the halo exchange runs on CUDA or CPU tensors, "
                         f"got {dev}")
    srcs, outs = [], []
    for r, ring in enumerate(rings):
        tails = [x[-halo:] for x in ring]
        for t in tails:
            if not t.is_contiguous():
                raise ValueError("the halo kernel copies contiguous tails; "
                                 "make the tail contiguous first")
        first = ctxs[r].contiguous() if ctxs is not None else tails[-1]
        srcs += [first] + tails[:-1]
        outs.append([torch.empty_like(t, memory_format=torch.contiguous_format)
                     for t in tails])
    dsts = [d for ring in outs for d in ring]
    nbytes = dsts[0].numel() * dsts[0].element_size()
    if nbytes == 0:
        return outs
    lib = _build.load()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for a in range(0, len(srcs), MAX_PAIRS):
            s = srcs[a:a + MAX_PAIRS]
            d = dsts[a:a + MAX_PAIRS]
            sp = (ctypes.c_void_p * len(s))(*[t.data_ptr() for t in s])
            dp = (ctypes.c_void_p * len(d))(*[t.data_ptr() for t in d])
            rc = lib.halo_ring_launch(sp, dp, len(s), nbytes, stream)
            if rc != 0:
                raise RuntimeError(f"halo ring kernel launch failed: CUDA "
                                   f"error {rc}")
            launches += 1
    return outs


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
