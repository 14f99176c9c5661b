"""The fused band-monitor kernel's wrapper and plain version against the
JAX package's Pallas kernel (interpret mode, as its own tests run it on
the CPU).  Here the wrapper runs the plain PyTorch version, because the
tensors lie on the CPU; the kernel itself is compared with it on the
card by tests/test_torch_band_monitor_cuda.py and chip_smoke.py.
``k9_replay`` replays the kernel's partition (csrc/band_monitor.cu: runs
of tiles a block, the frames before a run computed or read from the
carried spectrum tail, phase differences carried from tile to tile) and
its summation orders in numpy, so that its index algebra is held to the
JAX kernel here, before any card runs it."""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import jax.numpy as jnp
import torch

from comms_tpu.kernels import band_monitor_pallas as JBM
from comms_tpu.models import fm_band_monitor as jmodel
from comms_tpu_torch.kernels import band_monitor as TBM
from comms_tpu_torch.kernels import channelizer as TCK
from comms_tpu_torch.ops import demodulation

# The JAX kernel's own parity bound against the staged chain
# (tests/test_band_monitor_pallas.py): bf16x3 DFT and audio products
# there, float32 here.
TOL = 2e-4


def _jax_blocks(cfg, blocks):
    ctx_r = ctx_i = jnp.zeros((JBM.CTX_SAMPLES,), jnp.float32)
    yh_r, yh_i = JBM.zero_spec_halo(cfg.num_channels,
                                    cfg.audio_taps.shape[0])
    outs, states = [], []
    for re, im in blocks:
        audio, ctx_r, ctx_i, yh_r, yh_i = JBM.band_monitor_pallas_planar(
            jnp.asarray(re), jnp.asarray(im), cfg.prototype,
            cfg.audio_taps, cfg.audio_dec, ctx_r, ctx_i, yh_r, yh_i,
            num_channels=cfg.num_channels, interpret=True)
        outs.append(np.asarray(audio))
        states.append([np.asarray(s) for s in (ctx_r, ctx_i, yh_r, yh_i)])
    return outs, states


def _port_blocks(cfg, blocks, fn=TBM.band_monitor_planar):
    ctx_r = ctx_i = torch.zeros(TBM.CTX_SAMPLES)
    yh_r, yh_i = TBM.zero_spec_halo(cfg.num_channels,
                                    cfg.audio_taps.shape[0], device="cpu")
    outs, states = [], []
    for re, im in blocks:
        audio, ctx_r, ctx_i, yh_r, yh_i = fn(
            torch.from_numpy(re), torch.from_numpy(im), cfg.prototype,
            cfg.audio_taps, cfg.audio_dec, ctx_r, ctx_i, yh_r, yh_i,
            num_channels=cfg.num_channels)
        outs.append(audio.numpy())
        states.append([s.numpy() for s in (ctx_r, ctx_i, yh_r, yh_i)])
    return outs, states


@functools.lru_cache(maxsize=None)
def _case(k, m, dec):
    """Three white-noise blocks of step_samples() and the JAX kernel's
    audio and carried state after each, made once per file."""
    rng = np.random.default_rng(11 + k)
    cfg = jmodel.BandMonitorConfig(num_channels=k, taps_per_branch=m,
                                   block=TBM.step_samples(), audio_dec=dec)
    blocks = [(rng.normal(size=cfg.block).astype(np.float32),
               rng.normal(size=cfg.block).astype(np.float32))
              for _ in range(3)]
    want, wst = _jax_blocks(cfg, blocks)
    return cfg, blocks, want, wst


@pytest.mark.parametrize("k,m,dec", [(64, 8, 4), (16, 8, 4)])
def test_plain_matches_jax_kernel_streaming(k, m, dec):
    cfg, blocks, want, wst = _case(k, m, dec)
    launches = TBM.launches
    got, gst = _port_blocks(cfg, blocks)
    assert TBM.launches == launches          # CPU tensors: no kernel
    want, got = np.concatenate(want), np.concatenate(got)
    assert got.shape == want.shape == (3 * cfg.block // k // dec, k)
    scale = np.abs(want).max()
    assert np.max(np.abs(got - want)) < TOL * scale
    for g, w in zip(gst[-1], wst[-1]):
        assert g.shape == w.shape
        assert np.max(np.abs(g - w)) < 1e-5 * max(np.abs(w).max(), 1.0)


def test_stream_start_signed_zero_first_frame():
    # Only x[0] reaches spectrum frame 0 (through C[0, K-1] = h[0]), so
    # Y[0, ch] = h[0] * x[0] for every channel.  x[0] puts it in the
    # third quadrant; against the zero carried spectrum dotp = -0 and
    # cross = +0, so d[0] = atan2(+0, -0) = pi in every channel, and
    # audio[0, ch] = h_audio[0] * pi.
    rng = np.random.default_rng(5)
    cfg = jmodel.BandMonitorConfig(num_channels=16,
                                   block=TBM.step_samples())
    re = rng.normal(size=cfg.block).astype(np.float32)
    im = rng.normal(size=cfg.block).astype(np.float32)
    s = -np.sign(cfg.prototype[0])
    re[0] = im[0] = s
    want = _jax_blocks(cfg, [(re, im)])[0][0]
    got = _port_blocks(cfg, [(re, im)])[0][0]
    # The first audio sample of every channel: d[0] alone.
    assert np.max(np.abs(got[0] - want[0])) < 1e-5
    scale = np.abs(want).max()
    assert np.max(np.abs(got - want)) < TOL * scale
    pi_h0 = np.float32(cfg.audio_taps[0]) * np.pi
    assert np.max(np.abs(got[0] - pi_h0)) < 1e-6
    assert np.max(np.abs(want[0] - pi_h0)) < 1e-6


def test_plain_and_wrapper_agree():
    rng = np.random.default_rng(2)
    cfg = jmodel.BandMonitorConfig(num_channels=32,
                                   block=TBM.step_samples())
    blocks = [(rng.normal(size=cfg.block).astype(np.float32),
               rng.normal(size=cfg.block).astype(np.float32))
              for _ in range(2)]
    a, sa = _port_blocks(cfg, blocks)
    b, sb = _port_blocks(cfg, blocks, fn=TBM.band_monitor_plain)
    for x, y in zip(a + sa[-1], b + sb[-1]):
        np.testing.assert_array_equal(x, y)


def test_halo_rows_match_jax():
    for k in (2, 4, 8, 16, 32, 64, 128):
        for t in (1, 9, 32, 33, 63, 31 * (128 // k) + 1):
            assert TBM.halo_rows(k, t) == JBM.halo_rows(k, t), (k, t)


def test_validation_errors():
    cfg = jmodel.BandMonitorConfig(block=TBM.step_samples())
    re = torch.zeros(TBM.step_samples())
    ctx = torch.zeros(TBM.CTX_SAMPLES)
    yh_r, yh_i = TBM.zero_spec_halo(cfg.num_channels,
                                    cfg.audio_taps.shape[0], device="cpu")
    args = (cfg.prototype, cfg.audio_taps)
    with pytest.raises(ValueError, match="audio_dec"):
        TBM.band_monitor_planar(re, re, *args, 3, ctx, ctx, yh_r, yh_i,
                                num_channels=16)
    with pytest.raises(ValueError, match="spec halo"):
        TBM.band_monitor_planar(re, re, *args, 4, ctx, ctx, yh_r[:-1],
                                yh_i[:-1], num_channels=16)
    with pytest.raises(ValueError, match="audio taps"):
        TBM.band_monitor_planar(re, re, cfg.prototype, np.ones(250), 4,
                                ctx, ctx, yh_r, yh_i, num_channels=16)
    with pytest.raises(ValueError, match="multiple"):
        TBM.band_monitor_planar(re[:8192], re[:8192], *args, 4, ctx, ctx,
                                yh_r, yh_i, num_channels=16)
    with pytest.raises(ValueError, match="ctx must be"):
        TBM.band_monitor_planar(re, re, *args, 4, ctx[:10], ctx[:10],
                                yh_r, yh_i, num_channels=16)


# ---- k9_replay: the kernel's partition and summation orders in numpy

_SRC = (Path(TBM.__file__).resolve().parents[1] / "csrc"
        / "band_monitor.cu").read_text()
_PADDED = "return k < 4 ? 4 : ((k / 4) % 2 == 0 ? k + 4 : k + 8);"
_ROWPAD = "return k < 4 ? k : ((k / 4) % 2 == 0 ? k + 4 : k);"
_SMEM_LIMIT = 227 * 1024


def _tile_samples():
    return int(re.search(r"kTileSamples = (\d+);", _SRC)[1])


def _padded(k):
    """The source's row stride of the window (``padded``)."""
    assert _PADDED in _SRC
    return 4 if k < 4 else (k + 4 if (k // 4) % 2 == 0 else k + 8)


def _rowpad(k):
    """The source's row stride of d and Y (``rowpad``)."""
    assert _ROWPAD in _SRC
    return k if k < 4 else (k + 4 if (k // 4) % 2 == 0 else k)


def k9_geometry(k):
    """(T, G, P, Kp): frames a tile, channels a thread, threads a frame,
    row stride, as band_monitor.cu's Geo<K>."""
    G = min(k, 16)
    return _tile_samples() // k, G, k // G, _padded(k)


def k9_smem_bytes(k, M, Ta):
    """band_monitor.cu's layout<K>(s).total, in bytes."""
    T, G, P, Kp = k9_geometry(k)
    Kd = _rowpad(k)
    r4 = lambda n: -(-n // 4) * 4                       # noqa: E731
    floats = (2 * (T + M - 1) * Kp + r4((Ta - 1 + T) * Kd) + 4 * k
              + r4(Ta))
    if P == 1:
        floats += 2 * T * Kd                            # Y rows
    else:
        floats += r4(M * k) + 2 * k * k                 # C, root table
    return 4 * floats


def k9_schedule(tiles, T, Ta, run):
    """Per block: (first tile, end tile, frames whose Y the block makes
    before its run, the source of that Y ('halo' or 'input'), frames
    whose d it makes before its run)."""
    out = []
    for tb in range(0, tiles, run):
        f0 = tb * T
        out.append((tb, min(tb + run, tiles), range(f0 - Ta, f0),
                    "halo" if tb == 0 else "input",
                    range(f0 - Ta + 1, f0)))
    return out


def _x_at(x, ctx, n):
    """x[n] for an index array n: the planes, the context for n < 0."""
    L = ctx.shape[0]
    return np.where(n >= 0, x[np.clip(n, 0, x.shape[0] - 1)],
                    np.where(n >= -L, ctx[np.clip(L + n, 0, L - 1)],
                             np.float32(0)))


def _window(x, ctx, tile, T, M, k, Kp):
    """The kernel's window of one tile: rows q < T + M - 1 of x[(tile*T -
    M + q)*k + e], e < Kp (the pad holds the next row's first samples)."""
    q = np.arange(T + M - 1)[:, None]
    e = np.arange(Kp)[None, :]
    return _x_at(x, ctx, (tile * T - M + q) * k + e).astype(np.float32)


def _spectrum(Wr, Wi, C, roots, frames):
    """Y of tile frames ``frames`` from the window (branch sums over k =
    1..M, then the DFT over c = 0..K-1, in the kernel's order; a product
    then a sum in float32 for each fmaf)."""
    M, k = C.shape
    vr = np.zeros((len(frames), k), np.float32)
    vi = np.zeros((len(frames), k), np.float32)
    for kk in range(M):
        rows = np.asarray(frames) + M - 1 - kk
        vr = vr + C[kk] * Wr[rows, 1:k + 1]
        vi = vi + C[kk] * Wi[rows, 1:k + 1]
    ch = np.arange(k)
    yr = np.zeros_like(vr)
    yi = np.zeros_like(vi)
    for c in range(k):
        w = roots[((c + 1) * ch) % k]
        a, b = vr[:, c:c + 1], vi[:, c:c + 1]
        yr = yr + a * w[:, 0]
        yr = yr + (-b) * w[:, 1]
        yi = yi + a * w[:, 1]
        yi = yi + b * w[:, 0]
    return yr, yi


def _demod(yr, yi, pr, pi):
    """d of frames (yr, yi) against the frames before them (pr, pi), the
    kernel's products and sums; the plain version's atan2."""
    dotp = yr * pr + yi * pi
    cross = yi * pr - yr * pi
    return demodulation.fast_atan2(torch.from_numpy(cross),
                                   torch.from_numpy(dotp)).numpy()


def k9_replay(re_, im_, prototype, audio_taps, dec, k, ctx_re, ctx_im,
              yh_r, yh_i, run=None):
    """The kernel's function, partitioned as band_monitor.cu partitions
    it (``run`` tiles a block; ``TBM.partition``'s by default).  Returns
    ``(audio [N/k/dec, k], ctx_re, ctx_im, halo_re, halo_im)``."""
    T, _, _, Kp = k9_geometry(k)
    C = TCK.branch_matrix(np.asarray(prototype, np.float64), k)
    M = C.shape[0]
    roots = TCK.root_table(k)
    h = np.asarray(audio_taps, np.float32)
    Ta = h.shape[0]
    hframes = yh_r.size // k
    halo = (yh_r.reshape(hframes, k), yh_i.reshape(hframes, k))
    F = re_.shape[0] // k
    tiles, A = F // T, T // dec
    if run is None:
        _, run, _ = TBM.partition(F, k)
    audio = np.zeros((F // dec, k), np.float32)
    out_r = out_i = None

    def window(tile):
        return (_window(re_, ctx_re, tile, T, M, k, Kp),
                _window(im_, ctx_im, tile, T, M, k, Kp))

    for tb, te, yf, src, _ in k9_schedule(tiles, T, Ta, run):
        lo = np.arange(T - Ta, T)
        if src == "halo":
            pr, pi = (halo[0][hframes - T + lo], halo[1][hframes - T + lo])
        else:
            pr, pi = _spectrum(*window(tb - 1), C, roots, lo)
        d = np.zeros((Ta - 1 + T, k), np.float32)
        d[:Ta - 1] = _demod(pr[1:], pi[1:], pr[:-1], pi[:-1])
        pr, pi = pr[-1:], pi[-1:]
        for tile in range(tb, te):
            if tile > tb:
                d[:Ta - 1] = d[T:T + Ta - 1]
            yr, yi = _spectrum(*window(tile), C, roots, np.arange(T))
            d[Ta - 1:] = _demod(yr, yi, np.concatenate([pr, yr[:-1]]),
                                np.concatenate([pi, yi[:-1]]))
            pr, pi = yr[-1:], yi[-1:]
            if tile == tiles - 1:
                out_r, out_i = yr[T - hframes:], yi[T - hframes:]
            t = np.arange(A)[:, None]
            acc = np.zeros((A, k), np.float32)
            for m in range(Ta):
                acc = acc + h[m] * d[Ta - 1 + t[:, 0] * dec - m]
            audio[tile * A:(tile + 1) * A] = acc
    L = TBM.CTX_SAMPLES
    return (audio, re_[-L:].copy(), im_[-L:].copy(),
            out_r.reshape(yh_r.shape), out_i.reshape(yh_i.shape))


@pytest.mark.parametrize("k", [16, 64])
@pytest.mark.parametrize("start", ["zero", "mid_stream"])
def test_k9_replay_matches_jax_kernel_and_plain(k, start):
    # 3 blocks from the stream start, or blocks 1-2 from the JAX kernel's
    # state after block 0; the kernel's partition (one tile a block at
    # these sizes) and runs of 5 tiles (the last part-filled) give the
    # same bits.
    cfg, blocks, want, wst = _case(k, 8, 4)
    if start == "zero":
        first = 0
        L = TBM.CTX_SAMPLES
        hr = TBM.halo_rows(k, cfg.audio_taps.shape[0])
        state = [np.zeros(L, np.float32), np.zeros(L, np.float32),
                 np.zeros((hr, 128), np.float32),
                 np.zeros((hr, 128), np.float32)]
    else:
        first, state = 1, wst[0]
    re_ = np.concatenate([b[0] for b in blocks[first:]])
    im_ = np.concatenate([b[1] for b in blocks[first:]])
    args = (cfg.prototype, cfg.audio_taps, cfg.audio_dec, k, *state)
    got = k9_replay(re_, im_, *args)
    runs5 = k9_replay(re_, im_, *args, run=5)
    for a, b in zip(got, runs5):
        np.testing.assert_array_equal(a, b)
    jw = np.concatenate(want[first:])
    assert got[0].shape == jw.shape
    assert np.max(np.abs(got[0] - jw)) < TOL * np.abs(jw).max()
    t = [torch.from_numpy(np.array(s, np.float32)) for s in state]
    plain = TBM.band_monitor_plain(
        torch.from_numpy(re_), torch.from_numpy(im_), cfg.prototype,
        cfg.audio_taps, cfg.audio_dec, *t, num_channels=k)
    scale = float(plain[0].abs().max())
    assert np.max(np.abs(got[0] - plain[0].numpy())) < 1e-4 * scale
    for g, w in zip(got[1:], plain[1:]):
        assert np.max(np.abs(g - w.numpy())) < 1e-5 * max(
            float(w.abs().max()), 1.0)
    for g, w in zip(got[1:], wst[-1]):
        assert np.max(np.abs(g - w)) < 1e-5 * max(np.abs(w).max(), 1.0)


@pytest.mark.parametrize("k", [2, 16, 64, 128])
@pytest.mark.parametrize("steps", [1, 4, 17, 1024])
def test_k9_partition_makes_every_frame_once(k, steps):
    # Each tile's own frames belong to one block; a block makes the d of
    # every frame its audio FIR reads once (before its run or in one of
    # its tiles); the spectrum tail comes from the call's last tile; the
    # first block's frames before its run come from the carried tail.
    T, _, _, _ = k9_geometry(k)
    F = steps * TBM.step_samples() // k
    tiles = F // T
    Ta = 32
    hframes = TBM.halo_rows(k, Ta) * 128 // k
    assert Ta <= hframes <= T and tiles * T == F
    for run in (TBM.partition(F, k)[1], 1, 3, 7, tiles):
        own = np.zeros(F, int)
        tail = np.zeros(F, int)
        sched = k9_schedule(tiles, T, Ta, run)
        assert len(sched) == -(-tiles // run)
        if run == TBM.partition(F, k)[1]:
            assert len(sched) == TBM.partition(F, k)[2]
        for tb, te, yf, src, df in sched:
            assert (src == "halo") == (tb == 0)
            assert list(yf) == list(range(tb * T - Ta, tb * T))
            base = tb * T - Ta                    # frames base .. te*T-1
            made = np.zeros((te - tb) * T + Ta, int)
            made[np.asarray(df, int) - base] += 1
            for tile in range(tb, te):
                own[tile * T:(tile + 1) * T] += 1
                made[tile * T - base:(tile + 1) * T - base] += 1
                if tile == tiles - 1:
                    tail[F - hframes:] += 1
            reads = (np.arange(tb * T, te * T, 4)[:, None]
                     - np.arange(Ta)[None, :])
            assert np.all(made[reads - base] == 1) and made.max() == 1
        assert np.all(own == 1)
        assert np.all(tail[F - hframes:] == 1) and tail.sum() == hframes


def _wavefronts(word_addrs):
    """Shared-memory wavefronts of one warp's 128-bit loads or stores at
    ``word_addrs`` (32 lanes, in 4-byte words): 8 lanes a phase, 8 groups
    of 4 banks; lanes on one 16-byte unit share it."""
    units = np.asarray(word_addrs) // 4
    total = 0
    for ph in range(4):
        u = np.unique(units[8 * ph:8 * ph + 8])
        total += np.bincount(u % 8, minlength=8).max()
    return total


@pytest.mark.parametrize("k", [16, 64])
def test_k9_shared_memory_is_bank_conflict_free(k):
    # 128-bit accesses of a warp take 4 wavefronts when free of conflicts.
    # The window rows (and above K = 16 the Y rows there), the Y rows and
    # the demod's d stores: lanes on consecutive frames, Kp (Kd) words
    # apart, each row in chunks of 4 from its group's first channel.  (V
    # above K = 16 is branch-major: lanes on consecutive words.)  The audio
    # FIR at dec 4, 32 taps: a thread 4 channels of one output, channels
    # fastest.
    T, G, P, Kp = k9_geometry(k)
    Kd = _rowpad(k)
    assert (Kp // 4) % 2 == 1 and Kp >= k + 4
    assert (Kd // 4) % 2 == 1 and Kd >= k
    lanes = np.arange(32)
    for warp in range(256 // 32):
        tid = 32 * warp + lanes
        i, g = (tid, 0) if P == 1 else (tid % T, tid[0] // T)
        assert P == 1 or np.all(tid // T == g)
        for stride, extra in ((Kp, 4), (Kd, 0)):
            for row in (0, 1, 7):
                for j in range(0, G + extra, 4):
                    assert _wavefronts((i + row) * stride + g * G + j) == 4
    dec, Ta = 4, 32
    cpt = k // 4
    for warp in range(256 // 32):
        it = 32 * warp + lanes
        t, cg = it // cpt, it % cpt
        for m in range(4):
            assert _wavefronts((Ta - 1 + t * dec - m) * Kd + 4 * cg) == 4


@pytest.mark.parametrize("k", [2, 4, 8, 16, 32, 64, 128])
def test_k9_tile_shapes_fit(k):
    # Every K's tile at its largest taps per branch and audio taps fits a
    # block's shared memory; 256 threads cover a tile's frames; runs of
    # tiles hold whole audio outputs at every decimation.
    T, G, P, Kp = k9_geometry(k)
    assert T * P % 256 == 0 and T % 32 == 0 and T % 16 == 0
    M = min(16, (TBM.CTX_SAMPLES + 1) // k)
    Ta = 31 * (128 // k) + 1
    assert Ta <= TBM.halo_rows(k, Ta) * 128 // k <= T
    assert k9_smem_bytes(k, M, Ta) <= _SMEM_LIMIT
    assert TBM.step_samples() // k % T == 0
