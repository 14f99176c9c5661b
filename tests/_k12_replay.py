"""A replay of K12's copy (``comms_tpu_torch/csrc/halo_ring.cu``) in
numpy, for the CPU tests: the grid, each thread's words, the aligned
16-byte loads from the source rounded down to 16 bytes, the funnel
shifts over the source's byte offset and the narrow stores of the last
word, with the constants read from the source.  No jax."""

from __future__ import annotations

import re
from pathlib import Path

import numpy as np

SOURCE = (Path(__file__).resolve().parents[1] / "comms_tpu_torch" / "csrc"
          / "halo_ring.cu")


def constants() -> dict:
    """kThreads, kWords, kSmallPairs and kMaxPairs of the source."""
    text = SOURCE.read_text()
    return {k: int(re.search(rf"constexpr int {k} = (\d+);", text).group(1))
            for k in ("kThreads", "kWords", "kSmallPairs", "kMaxPairs")}


def grid_x(nbytes: int, npairs: int, resident: int) -> int:
    """Blocks along x a pair: as many as its words need at kWords words a
    thread, at most the resident blocks shared among the pairs."""
    c = constants()
    nwords = -(-nbytes // 16)
    bx = -(-nwords // (c["kThreads"] * c["kWords"]))
    return min(bx, max(resident // npairs, 1))


def thread_words(nbytes: int, bx: int):
    """For every thread of a pair's blocks, the output words it handles,
    in the kernel's order: w0 = block * kThreads + thread, then j * stride
    within an iteration of kWords words, then kWords * stride on."""
    c = constants()
    nwords = -(-nbytes // 16)
    stride = bx * c["kThreads"]
    out = []
    for w0 in range(stride):
        ws = []
        w = w0
        while w < nwords:
            ws += [w + j * stride for j in range(c["kWords"])
                   if w + j * stride < nwords]
            w += c["kWords"] * stride
        out.append(ws)
    return out


def _funnel_r(lo, hi, sh: int):
    """``__funnelshift_r(lo, hi, sh)`` on uint32 arrays, 0 <= sh < 32."""
    v = (hi.astype(np.uint64) << np.uint64(32)) | lo.astype(np.uint64)
    return ((v >> np.uint64(sh)) & np.uint64(0xFFFFFFFF)).astype(np.uint32)


def copy(memory: np.ndarray, src: int, nbytes: int, bx: int | None = None,
         resident: int = 1056, npairs: int = 16):
    """The bytes K12 writes for a pair whose source starts at byte ``src``
    of the 16-byte aligned ``memory`` (uint8, its length a multiple of 16),
    and the input words it reads (indices from the source rounded down to
    16 bytes).  Every output word is written by exactly one thread."""
    if bx is None:
        bx = grid_x(nbytes, npairs, resident)
    off = src % 16
    base = (src - off) // 16
    words = memory.view(np.uint32).reshape(-1, 4)
    last = (off + nbytes - 1) >> 4
    q, sh = off >> 2, 8 * (off & 3)
    dst = np.zeros(-(-nbytes // 16) * 16, np.uint8)
    written = np.zeros(len(dst) // 16, np.int64)
    read = set()
    for ws in thread_words(nbytes, bx):
        for w in ws:
            a = words[base + w]
            read.add(w)
            if off == 0:
                o = a
            else:
                if w + 1 <= last:
                    b = words[base + w + 1]
                    read.add(w + 1)
                else:
                    b = np.zeros(4, np.uint32)
                v = np.concatenate([a, b])
                o = _funnel_r(v[q:q + 4], v[q + 1:q + 5], sh)
            rem = nbytes - 16 * w
            ob = o.view(np.uint8)
            n = 16 if rem >= 16 else rem
            dst[16 * w:16 * w + n] = ob[:n]
            written[w] += 1
    return dst[:nbytes], read, written, last
