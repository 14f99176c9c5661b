"""A host copy of the decimating-FIR kernel's plan (decim_fir_kernel in
comms_tpu_torch/csrc/decim_fir.cu), in numpy, for the tests: its partition
of each row's outputs into tiles and blocks, each tile's window of sample
quads and where each sample comes from, the polyphase reads of a
thread's register ring, the shared-memory layout and its bank patterns,
and the products summed in the kernel's order.  It imports no jax.  A
change to the kernel's plan is made here as well; the constants are read
from the source."""

import re
from pathlib import Path

import numpy as np

from comms_tpu_torch.kernels import decim_fir as DF

SRC = (Path(DF.__file__).resolve().parents[1] / "csrc"
       / "decim_fir.cu").read_text()
SMEM_LIMIT = 227 * 1024          # a block's shared memory on the H100
SMEM_SM = 228 * 1024             # an SM's, 1 KB of it reserved per block
THREADS_SM = 2048
REGS_SM = 65536


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])


THREADS_MAX = _const("kThreadsMax")
STAGES = _const("kStages")
D_MAX = _const("kDMax")
R_OF_D = tuple(int(v) for v in re.search(
    r"constexpr int kROfD\[kDMax \+ 1\] = \{([\d, ]+)\};", SRC)[1].split(","))
MIN_BLOCKS_SM = int(re.search(r"__launch_bounds__\(kThreadsMax, (\d+)\)",
                              SRC)[1])


def outputs_per_thread(D):
    """R: the consecutive outputs a thread sums (kROfD; entry 0 above
    kDMax, the run-time-D path)."""
    return R_OF_D[D] if D <= D_MAX else R_OF_D[0]


def tap_stride(D):
    """Floats of one step's taps in shared memory (tap_stride; D itself on
    the run-time-D path)."""
    if D > D_MAX:
        return D
    return D if D <= 2 else -(-D // 4) * 4


def vector_floats(D):
    """Floats a group load reads at once (load_group): 4, 2 or 1."""
    return 1 if D > D_MAX else 4 if D % 4 == 0 else 2 if D % 2 == 0 else 1


def swizzled(D):
    return D <= D_MAX and D % 8 == 0


def swz(k, D):
    """Shared quad of window quad k."""
    k = np.asarray(k)
    return k ^ ((k >> 3) & 1) if swizzled(D) else k


class Shape:
    """The launch's FirShape (shape_of)."""

    def __init__(self, MD, D, threads, n_in=0, rows=1, ctx_len=0):
        self.MD, self.D, self.M = MD, D, MD // D
        self.threads, self.R = threads, outputs_per_thread(D)
        self.S = self.R * threads
        self.n_in, self.n_out, self.rows = n_in, n_in // D, rows
        self.ctx_len = ctx_len
        self.tpr = -(-self.n_out // self.S)
        self.tiles = rows * self.tpr
        self.a0 = (4 - MD % 4) % 4
        self.nq = (self.a0 + (self.S + self.M) * D + 3) // 4
        self.wq = -(-self.nq // 2) * 2
        self.dp = tap_stride(D)

    def w0(self, tile):
        """First plane sample of the tile's window (a multiple of 4)."""
        f0 = (tile % self.tpr) * self.S
        return (f0 - self.M) * self.D - self.a0


def smem_bytes(MD, D, threads, cplx):
    """decim_fir_smem_bytes: STAGES window buffers of two planes, the
    warps' output rows and the taps."""
    s = Shape(MD, D, threads)
    return 4 * (STAGES * 2 * 4 * s.wq + 2 * s.S
                + s.M * s.dp * (2 if cplx else 1))


def blocks_per_sm(threads, smem, regs):
    """Blocks an SM holds at ``regs`` registers a thread."""
    return min(SMEM_SM // (smem + 1024), THREADS_SM // threads,
               REGS_SM // (regs * threads))


def partition(n_out, rows, D):
    """Per block the tiles it walks (block b: b, b + blocks, ...), and the
    Shape's threads (``DF.partition``)."""
    threads, tiles, blocks = DF.partition(n_out, rows, D)
    return [list(range(b, tiles, blocks)) for b in range(blocks)], threads


def window_sources(s, tile):
    """Plane sample index of each element of the tile's window [nq, 4]
    and where it comes from: 0 the planes, 1 the context (index < 0 and
    >= -ctx_len), 2 a zero (past the row, or below the context)."""
    idx = s.w0(tile) + 4 * np.arange(s.nq)[:, None] + np.arange(4)
    src = np.where((idx >= 0) & (idx < s.n_in), 0,
                   np.where((idx < 0) & (idx >= -s.ctx_len), 1, 2))
    return idx, src


def copied_quads(s, tile):
    """The quads load_window copies with cp.async (k_lo <= k < k_hi);
    the others it builds sample by sample."""
    w0 = s.w0(tile)
    k_lo = min(-w0 // 4, s.nq) if w0 < 0 else 0
    k_hi = max(min((s.n_in - w0) // 4, s.nq), k_lo)
    return k_lo, k_hi


def thread_reads(s):
    """For output r of a thread (first output a of the tile) and tap t:
    the window's logical shared float it reads, minus a0 + a*D, as the
    kernel's ring supplies it: [R, MD].  Ring slot u at step q holds
    window group a + M - 1 - q + u; t = qD reads element 0 of u = r + 1,
    t = qD + p (p > 0) element D - p of u = r.  The run-time-D path reads
    (a + M)*D - t."""
    R, D, M = s.R, s.D, s.M
    t = np.arange(s.MD)
    if D > D_MAX:
        return np.broadcast_to(M * D - t, (R, s.MD)).copy()
    q, p = t // D, t % D
    out = np.zeros((R, s.MD), np.int64)
    for r in range(R):
        u = np.where(p == 0, r + 1, r)
        elem = np.where(p == 0, 0, D - p)
        out[r] = (M - 1 - q + u) * D + elem
    return out


def ring_slots(M, R):
    """The register slot of ring group u at each step q: (u - q) mod
    (R + 1), and the slot each step loads (u = 0): [M, R + 1], [M]."""
    q = np.arange(M)[:, None]
    return (np.arange(R + 1)[None, :] - q) % (R + 1), (-np.arange(M)) % (R + 1)


def shared_window(s, tile, xr, xi, cr, ci):
    """The tile's window as it lies in shared memory: two planes of wq
    quads (swizzled), [2, 4 * wq] float32, from row planes xr, xi and
    context rows cr, ci (or None: zeros)."""
    idx, src = window_sources(s, tile)
    row = tile // s.tpr
    out = np.zeros((2, s.wq, 4), np.float32)
    for p, (x, c) in enumerate(((xr, cr), (xi, ci))):
        v = np.zeros(idx.shape, np.float32)
        m = src == 0
        v[m] = x[row][idx[m]]
        m = src == 1
        if c is not None:
            v[m] = c[row][s.ctx_len + idx[m]]
        out[p, swz(np.arange(s.nq), s.D)] = v
    return out.reshape(2, -1)


def physical(s, logical):
    """Shared float of a logical window float (the swizzle moves quads)."""
    logical = np.asarray(logical)
    return swz(logical >> 2, s.D) * 4 + (logical & 3)


def gather(xr, xi, ctx, MD, D, threads=None):
    """The samples each output's t-th product reads, [rows, n_out, MD] a
    plane, through the kernel's plan (each tile's shared window, each
    thread's ring reads), and the plane index of each read sample.
    ``xr``/``xi`` [rows, n_in]; ``ctx`` None or (cr, ci) [rows, L]."""
    rows, n_in = xr.shape
    cr, ci = ctx if ctx is not None else (None, None)
    blocks, th = partition(n_in // D, rows, D)
    s = Shape(MD, D, threads or th, n_in, rows,
              0 if cr is None else cr.shape[1])
    reads = thread_reads(s)                          # [R, MD]
    a = s.R * np.arange(s.threads)
    gr = np.zeros((rows, s.n_out, MD), np.float32)
    gi = np.zeros_like(gr)
    gidx = np.zeros((rows, s.n_out, MD), np.int64)
    for tile in sorted(t for b in blocks for t in b):
        win = shared_window(s, tile, xr, xi, cr, ci)
        row, f0 = tile // s.tpr, (tile % s.tpr) * s.S
        for r in range(s.R):
            f = f0 + a + r
            keep = f < s.n_out
            lg = s.a0 + a[:, None] * D + reads[r][None, :]
            ph = physical(s, lg)
            gr[row, f[keep]] = win[0][ph[keep]]
            gi[row, f[keep]] = win[1][ph[keep]]
            gidx[row, f[keep]] = (s.w0(tile) + lg)[keep]
    return gr, gi, gidx


def k2_replay(xr, xi, taps, D, ctx=None):
    """The outputs through the kernel's plan, each summed in float32 in
    its order (t ascending; with complex taps ar += hr*xr, ar += -hi*xi,
    ai += hr*xi, ai += hi*xr; numpy rounds each product, the kernel fuses
    it): ``(yr, yi)`` [rows, n_out]."""
    hr, hi = DF._padded_taps(taps, D)
    MD = hr.shape[0]
    gr, gi, _ = gather(xr, xi, ctx, MD, D)
    f32 = np.float32
    ar = np.zeros(gr.shape[:2], f32)
    ai = np.zeros_like(ar)
    for t in range(MD):
        x_r, x_i = gr[..., t], gi[..., t]
        ar = ar + x_r * f32(hr[t])
        if hi is not None:
            ar = ar + x_i * f32(-hi[t])
            ai = ai + x_i * f32(hr[t])
            ai = ai + x_r * f32(hi[t])
        else:
            ai = ai + x_i * f32(hr[t])
    return ar, ai


def _wavefronts(units, lanes, slots):
    """Wavefronts of one warp access: lanes in groups of ``lanes``, each
    group's units over ``slots`` slots, the most on one slot."""
    return sum(int(np.bincount(units[g:g + lanes] % slots,
                               minlength=slots).max())
               for g in range(0, units.size, lanes))


def load_wavefronts(MD, D, threads):
    """Shared-memory wavefronts of every group load of every warp (the
    ring's prologue and every step of q; the run-time-D path's reads of
    one tap): the most any one takes and the least it could, (worst,
    floor).  A warp's LDS.128 is conflict-free when each quarter warp's 8
    lanes hit 8 distinct 16-byte groups of the 32 banks, LDS.64 when each
    half warp's 16 lanes hit 16 distinct 8-byte pairs, LDS.32 when the 32
    lanes hit 32 banks."""
    s = Shape(MD, D, threads)
    vw = vector_floats(D)
    lanes, slots, floor = {4: (8, 8, 4), 2: (16, 16, 2), 1: (32, 32, 1)}[vw]
    worst = 0
    for w in range(threads // 32):
        a = s.R * (32 * w + np.arange(32))
        if D > D_MAX:
            groups = [(a + s.M) * D - t for t in range(min(s.MD, 2 * D))]
            parts = [0]
        else:
            j0 = a + s.M - 1
            groups = [s.a0 + (j0 + u) * D for u in range(1, s.R + 1)]
            groups += [s.a0 + (j0 - q) * D for q in range(s.M)]
            parts = range(0, D, vw)
        for g in groups:
            for k in parts:
                lg = g + k
                if vw == 4:
                    units = swz(lg >> 2, D)
                elif vw == 2:
                    units = lg >> 1
                else:
                    units = lg
                worst = max(worst, _wavefronts(units, lanes, slots))
    return worst, floor


def copy_wavefronts(MD, D, threads):
    """The same for an interior tile's cp.async copies (quad k = tid + iT
    at shared quad swz(k)): (worst, floor 4) over every warp's copy."""
    s = Shape(MD, D, threads)
    worst = 0
    for base in range(0, s.nq, threads):
        for w in range(threads // 32):
            k = base + 32 * w + np.arange(32)
            k = k[k < s.nq]
            if k.size:
                worst = max(worst, _wavefronts(swz(k, D), 8, 8))
    return worst, 4


def store_wavefronts(D):
    """The warps' output rows: lane l writes its R outputs at l*R + r
    (LDS.32 pattern: worst over r), then reads quad l, l + 32, ...
    (conflict-free by construction): (worst, floor 1)."""
    R = outputs_per_thread(D)
    lane = np.arange(32)
    return max(_wavefronts(lane * R + r, 32, 32) for r in range(R)), 1


# K4, the dense streaming FIR (comms_tpu_torch/kernels/fir.py), is this
# kernel at D = 1 (MD = T up to 1025) with its [8, 128] context planes
# read as one row of 1024 samples.
K4_CTX = 1024


def k4_replay(xr, xi, taps, ctx_r, ctx_i):
    """K4's outputs through the kernel's plan: planes [N], context
    [8, 128] (flat, one row of ``K4_CTX``); ``(yr, yi)`` [N]."""
    yr, yi = k2_replay(xr[None], xi[None], taps, 1,
                       (ctx_r.reshape(1, K4_CTX), ctx_i.reshape(1, K4_CTX)))
    return yr[0], yi[0]


def next_context(x, rows, ctx_len):
    """The next context the launch writes, element e of rows * ctx_len
    read from plane sample row * n_in + n_in - ctx_len + (e mod ctx_len)
    of ``x`` [rows * n_in] (the kernel's index arithmetic), flat."""
    n_in = x.size // rows
    e = np.arange(rows * ctx_len)
    row = e // ctx_len
    return x[row * n_in + n_in - ctx_len + (e - row * ctx_len)]
