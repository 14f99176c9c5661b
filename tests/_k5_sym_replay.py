"""A host copy of the QPSK symbol kernel's plan (qpsk_sym_kernel in
comms_tpu_torch/csrc/qpsk_sym.cu), in numpy, for the tests: its partition
of the symbols into tiles and blocks, each tile's window of sample quads
and where each of them comes from, the polyphase reads of a thread's
register ring, the shared-memory layout and its bank patterns, and the
products summed in the kernel's order.  It imports no jax.  A change to
the kernel's plan is made here as well; the constants are read from the
source."""

import re
from pathlib import Path

import numpy as np

from comms_tpu_torch.kernels import qpsk_sym as QS

SRC = (Path(QS.__file__).resolve().parents[1] / "csrc"
       / "qpsk_sym.cu").read_text()
SMEM_LIMIT = 227 * 1024          # a block's shared memory on the H100
SMEM_SM = 228 * 1024             # an SM's, 1 KB of it reserved per block
THREADS_SM = 2048
REGS_SM = 65536


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])


R = _const("kSymR")
RING = R + 1
THREADS_MAX = _const("kSymThreadsMax")
THREADS_MIN = _const("kSymThreadsMin")
STAGES = _const("kStages")
MD_MAX = _const("kMdMax")
STEP_SYMS = _const("kStepSyms")
MIN_BLOCKS_SM = int(re.search(r"__launch_bounds__\(kSymThreadsMax, (\d+)\)",
                              SRC)[1])
TAPS_SMEM = 2 * (MD_MAX // 4) * 16          # s_taps: fr, fi as quads


def partition(n):
    """Per block the first symbols of the tiles it walks, and the tile
    size: block b walks tiles b, b + blocks, ... (``QS.partition``)."""
    threads, tiles, blocks = QS.partition(n)
    S = R * threads
    return [[t * S for t in range(b, tiles, blocks)]
            for b in range(blocks)], S


def window_quads(S, M):
    """Quads of one plane of one window buffer (window_quads)."""
    return -(-(S + M) // R) * R


def smem_bytes(threads, md):
    """The launch's dynamic shared memory: STAGES buffers of two planes."""
    return 16 * 2 * STAGES * window_quads(R * threads, md // 4)


def blocks_per_sm(threads, md, regs):
    """Blocks an SM holds at ``regs`` registers a thread."""
    smem = smem_bytes(threads, md) + TAPS_SMEM
    return min(SMEM_SM // (smem + 1024), THREADS_SM // threads,
               REGS_SM // (regs * threads))


def swz(j):
    """Shared quad of window quad j."""
    j = np.asarray(j)
    return j ^ ((j >> 3) & (R - 1))


def window_sources(s0, S, M, n):
    """Global sample index of each element of the tile's window [S + M, 4]
    and where it comes from: 0 the planes, 1 the context (index < 0), 2 a
    zero past the block (load_window's j_lo and j_hi)."""
    k0 = s0 - M + 1
    j = np.arange(S + M)
    idx = 4 * (k0 + j)[:, None] + np.arange(4)
    j_lo = -k0 if k0 < 0 else 0
    j_hi = n // 4 - k0 if k0 + S + M > n // 4 else S + M
    src = np.where(j < j_lo, 1, np.where(j >= j_hi, 2, 0))
    return idx, np.broadcast_to(src[:, None], idx.shape)


def thread_reads(M):
    """For symbol r of a thread (first symbol f) and tap t: the window
    quad (relative to f) and element the ring supplies, as the kernel's
    sym_step reads them: [R, 4M] quads and elements."""
    quad = np.zeros((R, 4 * M), np.int64)
    elem = np.zeros((R, 4 * M), np.int64)
    for q in range(M):
        for r in range(R):
            # slot u holds window quad f + M - 1 - q + u
            for p, (u, e) in enumerate(((r + 1, 0), (r, 3), (r, 2),
                                        (r, 1))):
                quad[r, 4 * q + p] = M - 1 - q + u
                elem[r, 4 * q + p] = e
    return quad, elem


def ring_slots(M):
    """The register slot of ring quad u at each step q: (u - q) mod RING,
    and the slot each step loads (u = 0): [M, RING], [M]."""
    q = np.arange(M)[:, None]
    return (np.arange(RING)[None, :] - q) % RING, (-np.arange(M)) % RING


def gather(xr, xi, ctx, md, n):
    """The samples each symbol's t-th product reads, [n/4, md] a plane,
    through the kernel's plan: each tile's window (context below 0, zeros
    at or past n) and each thread's ring reads; and the global index of
    each read sample."""
    M = md // 4
    blocks, S = partition(n)
    quad, elem = thread_reads(M)
    gr = np.zeros((n // 4, md), np.float32)
    gi = np.zeros((n // 4, md), np.float32)
    gidx = np.zeros((n // 4, md), np.int64)
    cr, ci = ctx if ctx is not None else (None, None)
    f = np.arange(0, S, R)                             # threads' symbols
    for s0 in sorted(s for b in blocks for s in b):
        idx, src = window_sources(s0, S, M, n)
        wr = np.zeros(idx.shape, np.float32)
        wi = np.zeros(idx.shape, np.float32)
        m = src == 0
        wr[m], wi[m] = xr[idx[m]], xi[idx[m]]
        m = src == 1
        if cr is not None:
            wr[m], wi[m] = cr[md - 1 + idx[m]], ci[md - 1 + idx[m]]
        for r in range(R):
            jj, ee = f[:, None] + quad[r][None, :], elem[r][None, :]
            gr[s0 + f + r] = wr[jj, ee]
            gi[s0 + f + r] = wi[jj, ee]
            gidx[s0 + f + r] = idx[jj, ee]
    return gr, gi, gidx


def k5_sym_replay(xr, xi, fr, fi, ws, phase0, ctx, n=None):
    """The symbols through the kernel's plan, summed in float32 in its
    order (four chains over t ascending; numpy rounds each product, the
    kernel fuses it) and de-rotated by its angle decomposition."""
    n = xr.shape[0] if n is None else n
    md = fr.shape[0]
    gr, gi, _ = gather(xr, xi, ctx, md, n)
    f32 = np.float32
    prr = np.zeros(n // 4, f32)
    pii, pri, pir = prr.copy(), prr.copy(), prr.copy()
    for t in range(md):
        prr = prr + gr[:, t] * f32(fr[t])
        pii = pii + gi[:, t] * f32(fi[t])
        pri = pri + gr[:, t] * f32(fi[t])
        pir = pir + gi[:, t] * f32(fr[t])
    y_r, y_i = prr - pii, pri + pir
    two_pi = f32(2 * np.pi)
    wsm = np.mod(f32(ws), two_pi)
    w128 = np.mod(f32(wsm * f32(128)), two_pi)
    s = np.arange(n // 4)
    g = (s // STEP_SYMS).astype(f32)
    rem = s % STEP_SYMS
    base = np.mod((f32(phase0) + wsm) + (w128 * f32(512)) * g, two_pi)
    ang = ((base + w128 * (rem >> 7).astype(f32))
           + wsm * (rem & 127).astype(f32)).astype(f32)
    c, sn = np.cos(ang).astype(f32), np.sin(ang).astype(f32)
    return y_r * c + y_i * sn, y_i * c - y_r * sn


def load_wavefronts(threads, md):
    """Shared-memory wavefronts of every 16-byte window load of every warp
    at every step (sym_step's new quad and the q = 0 preload), and the
    most any one takes: a warp's LDS.128 is conflict-free when each
    quarter warp's 8 lanes hit 8 distinct 16-byte groups of the 128 banks
    (4 wavefronts)."""
    M = md // 4
    worst, total, count = 0, 0, 0
    for w in range(threads // 32):
        f = R * (32 * w + np.arange(32))
        j0 = f + M - 1
        rows = [j0 + u for u in range(1, RING)] + [j0 - q for q in range(M)]
        for j in rows:
            a = swz(j) % 8
            wf = sum(max(np.bincount(a[8 * h:8 * h + 8], minlength=8))
                     for h in range(4))
            worst, total, count = max(worst, wf), total + wf, count + 1
    return worst, total / count


def copy_wavefronts(threads, md):
    """The same for the window copies (cp.async, quad j = j_lo + tid + kT
    at shared quad swz(j)): most and mean wavefronts a warp's copy."""
    M = md // 4
    S = R * threads
    worst, total, count = 0, 0, 0
    for base in range(0, S + M, threads):
        for w in range(threads // 32):
            j = base + 32 * w + np.arange(32)
            j = j[j < S + M]
            if not j.size:
                continue
            a = swz(j) % 8
            wf = sum(max(np.bincount(a[8 * h:8 * h + 8], minlength=8))
                     for h in range(4) if a[8 * h:8 * h + 8].size)
            worst, total, count = max(worst, wf), total + wf, count + 1
    return worst, total / count
