"""A host copy of the channelizer kernel's plan (comms_tpu_torch/csrc/
channelizer.cu), in numpy float32, for the tests: its partition, window
layout, branch-sum order, branch relabelling, radix split, twiddle
indices and pass order, and its shared-memory layout and bank patterns.
It imports no jax, so the tests on the card can use it too.  A change to
the kernel's plan is made here as well; the constants are read from the
source."""

import re
from pathlib import Path

import numpy as np

from comms_tpu_torch.kernels import channelizer as CK

SRC = (Path(CK.__file__).resolve().parents[1] / "csrc"
       / "channelizer.cu").read_text()
SMEM_LIMIT = 227 * 1024          # a block's shared memory on the H100
SMEM_SM = 228 * 1024             # an SM's, 1 KB of it reserved per block


def _const(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SRC)[1])


TILE = _const("kTileSamples")
RUN = _const("kRun")
THREADS = _const("kThreads")
MAX_TAPS = _const("kMaxTaps")
POINTS = 16                      # fft_reg.cuh's kPoints


def geometry(k):
    """(F, P, FPT, skew): frames a tile, DFT lanes a frame, frames a DFT
    thread, window rows skewed (channelizer.cu's Geo<K>)."""
    return (TILE // k, max(1, k // 16), 16 // k if k < 16 else 1, k < 32)


def u_words(k):
    F, P, _, _ = geometry(k)
    return 20 * 256 if k <= 16 else 4 * (4 * P + 4) * F


def buffer_words(k, M):
    """buffer_words<K>(M): one plane of one buffer, in words."""
    F, _, _, skew = geometry(k)
    rows = F + M
    win = (rows + (rows + 15) // 16) * k if skew else rows * k
    return -(-max(win, u_words(k)) // 4) * 4


def smem_bytes(k, M):
    """The launch's dynamic shared memory: two buffers of two planes, the
    twiddle table and the taps."""
    _, P, _, _ = geometry(k)
    return 4 * (4 * buffer_words(k, M) + 2 * POINTS * P + M * k)


def row_word(k, q):
    return (q + (q >> 4)) * k if geometry(k)[3] else q * k


def swz(k, m, t):
    if k == 32:
        return m & 3
    if k == 64:
        return (((t >> 1) & 1) << 1) | (m & 1)
    return (((t >> 1) & 1) << 1) | ((t >> 2) & 1)


def unit_word(k, m, t, u):
    """Word of unit u (of 4) of frame m's chunk t, K >= 32."""
    P = geometry(k)[1]
    return 4 * ((4 * P + 4) * m + 4 * t + (u ^ swz(k, m, t)))


def u_word(k, m, n):
    """Word of U[m, n] of a tile in the buffer (put_u)."""
    F, P, FPT, _ = geometry(k)
    if k <= 16:
        return 20 * (m // FPT) + (m % FPT) * k + n
    q = n // P
    return unit_word(k, m, n % P, q >> 2) + (q & 3)


def partition(tiles, blocks):
    """Per block the tiles it walks: b, b + blocks, ..."""
    return [list(range(b, tiles, blocks)) for b in range(blocks)]


# ---- fft_reg.cuh's register DFTs, float32, vectorised over axis 0

_C16 = [np.float32(v) for v in (1.0, 0.92387953251128674,
                                0.70710678118654752, 0.38268343236508978,
                                0.0)]


def _w16r(k):
    k &= 15
    if k <= 4:
        return _C16[k]
    if k <= 8:
        return -_C16[8 - k]
    if k <= 12:
        return -_C16[k - 8]
    return _C16[16 - k]


def _w16i(k):
    return -_w16r(k + 12)


def _cmul(vr, vi, i, wr, wi):
    ar, ai = vr[:, i].copy(), vi[:, i].copy()
    vr[:, i] = ar * wr - ai * wi
    vi[:, i] = ar * wi + ai * wr


def dft4(vr, vi, B, S):
    a, b, c, d = B, B + S, B + 2 * S, B + 3 * S
    t0r, t0i = vr[:, a] + vr[:, c], vi[:, a] + vi[:, c]
    t1r, t1i = vr[:, a] - vr[:, c], vi[:, a] - vi[:, c]
    t2r, t2i = vr[:, b] + vr[:, d], vi[:, b] + vi[:, d]
    t3r, t3i = vr[:, b] - vr[:, d], vi[:, b] - vi[:, d]
    vr[:, a], vi[:, a] = t0r + t2r, t0i + t2i
    vr[:, b], vi[:, b] = t1r + t3i, t1i - t3r
    vr[:, c], vi[:, c] = t0r - t2r, t0i - t2i
    vr[:, d], vi[:, d] = t1r - t3i, t1i + t3r


def dft8(vr, vi, B, S):
    for n in range(4):
        p, q = B + S * n, B + S * (n + 4)
        dr, di = vr[:, p] - vr[:, q], vi[:, p] - vi[:, q]
        vr[:, p] += vr[:, q]
        vi[:, p] += vi[:, q]
        vr[:, q], vi[:, q] = dr, di
        if n:
            _cmul(vr, vi, q, _w16r(2 * n), _w16i(2 * n))
    dft4(vr, vi, B, S)
    dft4(vr, vi, B + 4 * S, S)


def dft16(vr, vi):
    for b in range(4):
        dft4(vr, vi, b, 4)
    for k1 in range(1, 4):
        for i2 in range(1, 4):
            _cmul(vr, vi, i2 + 4 * k1, _w16r(i2 * k1), _w16i(i2 * k1))
    for b in range(0, 16, 4):
        dft4(vr, vi, b, 1)


def out_pos(R, r):
    if R == 16:
        return 4 * (r & 3) + (r >> 2)
    return 4 * (r & 1) + (r >> 1) if R == 8 else r


def _tile_dft(Ur, Ui, k):
    """Y of one tile's U [F, K] (float32), as the DFT threads compute it."""
    F, P, FPT, _ = geometry(k)
    if k <= 16:
        vr, vi = Ur.reshape(-1, 16).copy(), Ui.reshape(-1, 16).copy()
        if k == 16:
            dft16(vr, vi)
        elif k == 8:
            dft8(vr, vi, 0, 1)
            dft8(vr, vi, 8, 1)
        elif k == 4:
            for b in range(0, 16, 4):
                dft4(vr, vi, b, 1)
        else:
            for f in range(8):
                a, b = vr[:, 2 * f].copy(), vi[:, 2 * f].copy()
                vr[:, 2 * f], vi[:, 2 * f] = a + vr[:, 2 * f + 1], \
                    b + vi[:, 2 * f + 1]
                vr[:, 2 * f + 1], vi[:, 2 * f + 1] = a - vr[:, 2 * f + 1], \
                    b - vi[:, 2 * f + 1]
        perm = [(i // k) * k + out_pos(k, i % k) for i in range(16)]
        return vr[:, perm].reshape(F, k), vi[:, perm].reshape(F, k)
    # lane t of frame m: U[m, t + P q] at q; dft16 over q
    vr = Ur.reshape(F, 16, P).transpose(0, 2, 1).reshape(F * P, 16).copy()
    vi = Ui.reshape(F, 16, P).transpose(0, 2, 1).reshape(F * P, 16).copy()
    dft16(vr, vi)
    roots = CK.root_table(k)
    t = np.tile(np.arange(P), F)
    Br = np.empty_like(vr)
    Bi = np.empty_like(vi)
    for p in range(16):
        xr, xi = vr[:, out_pos(16, p)], vi[:, out_pos(16, p)]
        if p:
            w = roots[t * p]
            xr, xi = xr * w[:, 0] - xi * w[:, 1], xr * w[:, 1] + xi * w[:, 0]
        Br[:, p], Bi[:, p] = xr, xi
    Br, Bi = Br.reshape(F, P, 16), Bi.reshape(F, P, 16)
    J = 16 // P
    yr = np.empty((F, k), np.float32)
    yi = np.empty((F, k), np.float32)
    for lane in range(P):                   # t' of the kernel
        if P == 2:
            ps = [4 * (lane + 2 * (j >> 2)) + (j & 3) for j in range(J)]
        else:
            ps = [J * lane + j for j in range(J)]
        vr = np.stack([Br[:, tt, ps[j]] for tt in range(P) for j in range(J)],
                      1)
        vi = np.stack([Bi[:, tt, ps[j]] for tt in range(P) for j in range(J)],
                      1)
        if P == 2:
            for j in range(8):
                a, b = vr[:, j].copy(), vi[:, j].copy()
                vr[:, j], vi[:, j] = a + vr[:, j + 8], b + vi[:, j + 8]
                vr[:, j + 8], vi[:, j + 8] = a - vr[:, j + 8], b - vi[:, j + 8]
            pos = lambda s, j: j + 8 * s                    # noqa: E731
        elif P == 4:
            for j in range(4):
                dft4(vr, vi, j, 4)
            pos = lambda s, j: j + 4 * s                    # noqa: E731
        else:
            dft8(vr, vi, 0, 2)
            dft8(vr, vi, 1, 2)
            pos = lambda s, j: j + 2 * out_pos(8, s)        # noqa: E731
        for s in range(P):
            for j in range(J):
                yr[:, 16 * s + ps[j]] = vr[:, pos(s, j)]
                yi[:, 16 * s + ps[j]] = vi[:, pos(s, j)]
    return yr, yi


def _x_at(x, ctx, n):
    L = ctx.shape[0]
    return np.where(n >= 0, x[np.clip(n, 0, x.shape[0] - 1)],
                    np.where(n >= -L, ctx[np.clip(L + n, 0, L - 1)],
                             np.float32(0)))


def k8_replay(re_, im_, prototype, ctx_re, ctx_im, k, blocks=None):
    """The kernel's function, walked as channelizer.cu walks it (``blocks``
    blocks, :func:`CK.partition`'s by default).  float32 numpy planes [N]
    and contexts [CTX_SAMPLES]; returns (yr, yi) [N/k, k] and the count of
    times each tile was made."""
    C = CK.branch_matrix(np.asarray(prototype, np.float64), k)
    M = C.shape[0]
    F = geometry(k)[0]
    frames = re_.shape[0] // k
    tiles = frames // F
    if blocks is None:
        blocks = CK.partition(frames, k)[2]
    n = np.arange(k)
    # d[i, n]: the tap of term k = M - i of branch (n - 1) mod K
    d = C[M - 1 - np.arange(M)][:, (n - 1) % k]
    dl = (n == 0).astype(int)                 # branch K-1 reads the next row
    yr = np.zeros((frames, k), np.float32)
    yi = np.zeros((frames, k), np.float32)
    made = np.zeros(tiles, int)
    for walk in partition(tiles, blocks):
        for tile in walk:
            made[tile] += 1
            q = np.arange(F + M - 1)[:, None] + dl[None, :]
            idx = (tile * F - M + q) * k + n[None, :]
            Xr, Xi = _x_at(re_, ctx_re, idx), _x_at(im_, ctx_im, idx)
            Ur = np.zeros((F, k), np.float32)
            Ui = np.zeros((F, k), np.float32)
            for i in range(M):                # terms k = M .. 1
                Ur = Ur + d[i] * Xr[i:i + F]
                Ui = Ui + d[i] * Xi[i:i + F]
            out = _tile_dft(Ur, Ui, k)
            yr[tile * F:(tile + 1) * F] = out[0]
            yi[tile * F:(tile + 1) * F] = out[1]
    return yr, yi, made


def f64_channelize(re_, im_, prototype, ctx_re, ctx_im, k):
    """The channelizer in float64 of the same float32 planes, context and
    taps (the kernel's float32 branch matrix); numpy, [N/k, k] complex."""
    C = CK.branch_matrix(np.asarray(prototype, np.float64), k).astype(
        np.float64)
    M = C.shape[0]
    t = M * k - 1
    x = (np.concatenate([ctx_re[-t:], re_]).astype(np.float64)
         + 1j * np.concatenate([ctx_im[-t:], im_]).astype(np.float64))
    frames = re_.shape[0] // k
    R = x[:(frames + M - 1) * k].reshape(frames + M - 1, k)
    V = sum(C[kk - 1] * R[M - kk:M - kk + frames] for kk in range(1, M + 1))
    return np.fft.fft(np.roll(V, 1, axis=1), axis=1)


def wavefronts(word_addrs, width):
    """Shared-memory wavefronts of one warp's accesses of ``width`` words
    (1, 2 or 4) at ``word_addrs`` (32 lanes): 32/width lanes a phase,
    lanes on one address share it."""
    words = np.asarray(word_addrs)
    per = 32 // width
    total = 0
    for ph in range(width):
        banks = {}
        for a in np.unique(words[ph * per:(ph + 1) * per]):
            for x in range(width):
                banks[(a + x) % 32] = banks.get((a + x) % 32, 0) + 1
        total += max(banks.values())
    return total
