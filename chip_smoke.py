#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: the FM broadcast
receiver, the wideband FM band monitor, the QPSK receiver, FFT and Welch
spectrum monitoring, and the sharded layer on an 8-shard mesh of the
card.

    python3 chip_smoke.py        # from the repository root

Phases (each raises on failure, so any failure exits non-zero):

1. card name and power limit (nvidia-smi), torch and CUDA versions;
2. build the kernels from ``comms_tpu_torch/csrc`` (one nvcc per source,
   in parallel) and print ptxas's register and spill report;
3. FM: the fused FM kernel against its plain PyTorch version on the
   card, at the 26,214,400-sample block (from the stream-start context
   and from a mid-stream one) and on white noise;
4. FM main path: ``run_file`` over a capture of three full blocks and a
   ragged tail, fused and unfused, plus a small capture against the CPU
   run of the same code; ``StreamRunner`` over the fused block step, 8
   blocks after 3 warm-up blocks, state chained, depth 4, from
   device-resident and from pinned host blocks; the dense
   262,144-sample block of the reference's entry config, on the card
   against the CPU;
5. band monitor kernels against their plain versions at the main path's
   shapes: the channelizer (K=64 and K=16, 16,777,216 samples, zero and
   mid-stream context), the decimating FIR (the staged audio stage's
   batch of 8 channel pairs) and its poly-FIR entry (dec 5, 63 and 641
   taps), the fused band monitor (K=16 and K=64, 16,777,216 samples,
   zero and mid-stream state) on a capture with one FM station at the
   centre of every channel, and on white noise at 3 x 16,384 samples;
6. band monitor main path: ``StreamRunner`` over the fused block step
   at K=16, 8 blocks of 16,777,216 after 3 warm-up blocks, depth 4,
   state chained, from device-resident and from pinned host blocks; the
   staged block step (channelizer + decimating-FIR kernels) and the
   64-channel channelizer model on the same blocks; fused against
   staged, each channel's tone against its spectrum, and exact launch
   counts per kernel;
7. kernel and plain-version times at the main paths' shapes (CUDA
   events around calls queued behind a spin kernel, so they time the
   device and not the wrapper's host code), each beside the card's name
   and power limit;
8. QPSK: a synthetic capture of 33,554,432 samples (2^25, bench.py's
   capture), the FIR kernel (the matched filter's 32 real taps, and 257
   complex taps from a mid-stream context), the symbol kernel's three
   entries with panels at halfwidth 51 (zero and carried context) and
   the panel reductions against their plain versions; panels repeat bit
   for bit; the kernel route against the tensor route at one
   IN_PER_STEP block;
9. QPSK main paths: the one-shot receiver (fused core: the symbol
   kernel's panel and ``_scalars`` entries) and the staged core (the FIR
   kernel) on the capture, zero bit errors over the whole capture, the
   capture's timing estimate rebuilt from the panel reductions;
   ``StreamRunner`` over the fused stream step, 8 gap-free blocks of
   33,554,432 after 3 warm-up blocks, depth 4, state chained, from
   device-resident and from pinned host blocks, zero bit errors after the
   warm-up block with one lag across the seams; the fast step on the
   same blocks; two blocks under ``torch.cuda.set_sync_debug_mode
   ("error")``; exact launch counts;
10. QPSK kernel and plain-version times, and a ``torch.profiler`` split
   of one served block;
11. spectrum kernels against their plain versions at full width, on a
   white-noise capture: the FFT kernel at 16,777,216 samples as rows of
   1024, 4096, 8192 and 16384 (scale 1/sqrt(n), against a float64 oracle
   on a subset of rows, the plane-swap step twice an exact bin reversal)
   and the 256-point spectrogram; the PSD kernel's stream entry (n =
   1024) and its row entry through ``welch_psd``, each bin against that
   bin; then three tones standing out of the noise of a tone capture;
   the four-step kernel: ``welch_numerator`` at 2^20 x 32 in its three
   ingest layouts, with means and with sparse demean, stage A, and
   ``fft_large`` at 2^20 x 32 and 2^22 x 8;
12. spectrum main path: ``welch_psd_planar`` served through
   ``StreamRunner`` (8 blocks of 16,777,216 after 3 warm-up blocks, depth
   4, device-resident and pinned host blocks), ``welch_psd``,
   ``spectrogram``, the 2^20 x 32 wideband ``welch_psd`` and both
   ``fft_large`` shapes; exact launch counts per kernel entry; a
   ``torch.profiler`` split of one served block;
13. spectrum kernel, plain-version and library (``torch.fft.fft``) times;
14. every kernel table row carries its bound (bytes over 3.35 TB/s or
   float32 operations over 67 TFLOP/s, from this run's shapes) and, where
   one PyTorch call computes the same function (``F.conv1d`` for the FIR
   entries, ``torch.fft.fft`` for the FFT entries), that call's time;
15. the ring halo exchange kernel (K12) against its plain version bit for
   bit, at the sharded paths' halos (complex64, float32 and u8 tails, the
   wrapped and the carried-context forms, the 2-D column rings, both
   planes in one launch) and on a 1 MiB-per-shard ring;
16. the sharded layer on an 8-shard mesh of the card (the counts of every
   kernel start at 0 before each path and are read after it): the sharded
   wideband chain at 26,214,400 samples against the same chain on one
   shard and its ``rdma_halo`` build bit for bit, two blocks streamed; the
   sharded fused FM step bit for bit against a sequential run of the
   fused block step over the 8 per-shard blocks, served through
   ``StreamRunner`` beside the unsharded fused step; the band monitor at
   16,777,216, K=16, fused per shard (K9) and on the 2 x 4 mesh (K8 + K2
   per shard) against the one-device paths; the sharded QPSK receiver on
   the 2^25-sample capture with zero bit errors; the frequency-sharded
   (dfft) and segment-sharded (K10 per shard) PSDs at 2^20 x 32 per bin
   against ``welch_psd``; K12's launches per path and each path's
   per-shard kernel launches;
17. ``dryrun_multichip(8)`` on the card, and K12's kernel, plain-version,
   bound and library (``torch._foreach_copy_``) times.

The inputs are synthetic captures made from fixed seeds (numpy for the
FM receiver, torch on the card for the band monitor, numpy bits and
torch on the card for the QPSK capture, torch on the card for the
spectrum captures).  The line before the last is the kernel table as
JSON; the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

BLOCK = 26_214_400      # one wideband-capture block (bench.py's size)
RAGGED = 3_777          # ragged tail of the run_file capture
SERVE_BLOCKS = 8
SERVE_DEPTH = 4
SERVE_WARMUP = 3
ENTRY_BLOCK = 262_144   # rtl-sdr read size, the dense path
NOISE_N = 204_800
# Kernel vs plain: both float32 with different summation orders; on a
# clean FM capture the phase step is far from +-pi, so errors stay
# ~1e-6.  White noise can sit near the atan2 branch cut, where a last-
# bit difference in z moves one d by up to 2*pi*|h|, hence its wider
# bound (the JAX package's own 1e-3 parity bound for this chain).
TOL_KERNEL = 1e-4
TOL_NOISE = 1e-3
TOL_PATHS = 1e-3        # fused vs unfused run_file (the JAX bound)
TOL_DENSE = 1e-4        # dense block on the card vs the CPU
REPO = Path(__file__).resolve().parent

# Band monitor (bench.py:488-625): the wideband block, the fused K=16
# configuration served, and the K=64 BASELINE channelizer.
BM_BLOCK = 16_777_216
BM_K = 16
BM_K64 = 64
BM_NOISE = 16_384       # white noise runs at 3 x this
POLY_DEC = 5
POLY_N = 409 * 64 * POLY_DEC * 128   # 16,752,640: the poly entry's quantum
# Kernel vs plain, relative to the plain output's largest magnitude: the
# JAX package's parity bounds for the same kernels (float32 on both
# sides here, in other summation orders).  On the station capture every
# phase step stays within about +-pi/2, far from the atan2 branch cut.
TOL_CHAN = 1e-5
TOL_FIR = 5e-5
TOL_BM = 2e-4


# QPSK receiver (bench.py:414-485): one 2^25-sample capture of the
# qpsk_tx waveform (RRC sps 4, 32 taps, beta 0.25) with the impairments
# of tests/test_qpsk_rx.py:52-62.  The capture repeats a 2^22-sample
# period (circular pulse shaping and delay), so any run of blocks of a
# multiple of the period is one gap-free stream.
QPSK_N = 33_554_432
QPSK_PERIOD = 4_194_304
QPSK_CFO, QPSK_PHASE, QPSK_DELAY, QPSK_NOISE = 0.01, 0.6, 2.3, 0.02
QPSK_MARGIN = 16        # symbols skipped at a one-shot block's edges
# Kernel vs plain: float32 on both sides in other summation orders, the
# same de-rotation angle decomposition (symbols, relative to the largest
# symbol); panels relative to the largest panel entry; the kernel route
# vs the tensor route (another angle decomposition) at the JAX test's
# 1e-3 (tests/test_qpsk_rx.py:170-178).
TOL_SYM = 1e-4
TOL_PANEL = 1e-5
TOL_ROUTE = 1e-3
TOL_REDUCE = 1e-4
TOL_STREAM_SYM = 2e-3   # fast vs fused stream step (the JAX test's)
TOL_STREAM_STATE = 1e-3

# FFT and spectrum monitoring: the Welch serving block and FFT rows of
# bench.py:796-940 (16,777,216 samples, 1024 bins), a capture with three
# tones at known bins of a 1024-point FFT (amplitudes 1, 0.5, 0.25) plus
# noise of sigma 0.01, and the wideband PSD of bench.py:628-670 (2^20
# bins x 32 segments) with the 2^22 x 8 edge of the four-step stages.
SP_N = 16_777_216
SP_NFFT = 1024
SP_TONES = (101, 300, 777)
SP_NOISE = 0.01
BIG = ((1 << 20, 32), (1 << 22, 8))
# The JAX tests' bounds (FFT outputs 1e-5 against a float64 oracle, PSDs
# 2e-5), the three K10 layouts 1e-5, the kernel and tensor Welch routes
# and the spectrogram 1e-4, the involution 1e-4: relative to the largest
# magnitude, except K7's PSDs and the Welch routes, which are held bin by
# bin (each bin's error relative to that bin).
TOL_FFT = 1e-5
TOL_PSD = 2e-5
TOL_LAYOUT = 1e-5
TOL_WELCH = 1e-4
TOL_INVOLUTION = 1e-4

# The sharded layer: an in-process mesh of 8 shards on the one card (the
# counterpart of the JAX package's 8-device virtual CPU mesh), the FM and
# wideband blocks at BLOCK (3,276,800 samples a shard), the band monitor
# at BM_BLOCK, the QPSK capture, the PSDs at BIG[0]; K12 is also timed on
# a ring of 1 MiB per shard.  The sharded chain against the same chain on
# one shard and the 2-D band monitor against the one-device staged path:
# the same float32 operations on the same windows (the JAX tests' bounds,
# 1e-4 and 1e-5 absolute); the sharded fused band monitor against the
# one-device fused path at TOL_BM (its boundary state is recomputed from
# the raw tail); the PSDs per bin at TOL_PSD.
SH_SHARDS = 8
SH_RING_MIB = 1 << 20
TOL_SH_CHAIN = 1e-4
TOL_SH_2D = 1e-5

# The card's published rates (NVIDIA H100 SXM data sheet, at its 700 W
# limit): a kernel's bound is the larger of its bytes over the memory
# rate and its operations over the float32 rate of the CUDA cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOP_PER_S = 67e12


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def bound(nbytes: float, flops: float):
    """``(bound_ms, bound_by)``: the least time the card could take to move
    ``nbytes`` (each input read once, each output written once) and to do
    ``flops`` float32 operations."""
    t_b = nbytes / HBM_BYTES_PER_S * 1e3
    t_o = flops / F32_FLOP_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def kernel_row(name, source, replaces, launches, err, ms, plain_ms,
               nbytes, flops, library_ms=None) -> dict:
    """One entry of the kernel table: the bound is computed from this run's
    shapes (``nbytes``, ``flops``); every time was measured in this run."""
    b_ms, by = bound(nbytes, flops)
    print(f"bound of {name}: {nbytes / 1e6:.1f} MB, {flops / 1e9:.3f} "
          f"GFLOP -> {b_ms:.4f} ms ({by}); kernel {ms:.4f} ms")
    return {"name": name, "route": "cuda",
            "source": "comms_tpu_torch/csrc/" + source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": by, "library_ms": library_ms}


def conv1d_ms(rows, taps, stride: int, want=None):
    """The library yardstick of a FIR with real taps: the time of one
    ``F.conv1d`` call (cuDNN, TF32 off) over ``rows`` [C, L] (each row its
    T-1 context samples, then the block) with the flipped taps, which
    computes y[f] = sum_t taps[t] x[f*stride - t].  With ``want`` [C, M]
    (the kernel's output) it also prints their difference."""
    import torch
    import torch.nn.functional as F

    x = rows[:, None, :].contiguous()
    w = torch.from_numpy(np.ascontiguousarray(
        np.asarray(taps, np.float32)[::-1])).to(x.device).view(1, 1, -1)
    if want is not None:
        y = F.conv1d(x, w, stride=stride)[:, 0]
        print(f"conv1d (stride {stride}, {w.shape[-1]} taps) vs kernel: "
              f"{rel_err(y, want):.3g} relative")
    return cuda_ms(lambda: F.conv1d(x, w, stride=stride))


def fm_tones(t, sin=np.sin):
    """The FM captures' instantaneous frequency (rad/sample) at sample
    indices ``t``: a carrier offset and two modulating tones."""
    return (0.05 + 0.12 * sin(2 * np.pi * 1.3e-4 * t)
            + 0.08 * sin(2 * np.pi * 3.1e-5 * t + 1.0))


def synth_capture(n: int, seed: int):
    """u8 IQ [n, 2] of a carrier frequency-modulated by two tones, at
    amplitude 100 around 127.5 plus Gaussian noise (sigma 2), and its
    instantaneous frequency w [n] in rad/sample.  |w| <= 0.25, so the
    phase step per mid-rate sample (5w) stays far from +-pi."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    w = fm_tones(t)
    ph = np.cumsum(w)
    iq = np.empty((n, 2), np.uint8)
    iq[:, 0] = np.clip(np.round(100 * np.cos(ph) + 127.5
                                + rng.normal(scale=2.0, size=n)), 0, 255)
    iq[:, 1] = np.clip(np.round(100 * np.sin(ph) + 127.5
                                + rng.normal(scale=2.0, size=n)), 0, 255)
    return iq, w


def demod_matches_tones(audio: np.ndarray, w: np.ndarray) -> float:
    """Correlation of the audio with the modulating frequency, aligned
    by the two filters' group delay (31 input + 31 mid samples)."""
    f = np.arange(16, audio.shape[0])
    idx = 25 * f - (31 + 5 * 31)
    return float(np.corrcoef(audio[f], w[idx])[0, 1])


def max_err(a, b) -> float:
    return float((a - b).abs().max().item())


_SPIN_CYCLES_PER_MS = []


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    """Device time of ``fn()`` in ms: CUDA events, median of ``reps``.
    Each timed call is queued behind a spin kernel that lasts three times
    the host's enqueue of ``fn`` plus 0.5 ms, so the events see the
    device's work back to back and not the wrapper's host code."""
    import torch

    if not _SPIN_CYCLES_PER_MS:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(10_000_000)
        end.record()
        end.synchronize()
        _SPIN_CYCLES_PER_MS.append(1e7 / start.elapsed_time(end))
    host_ms = 0.0
    for _ in range(warmup):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        host_ms = (time.perf_counter() - t0) * 1e3
    spin = int(_SPIN_CYCLES_PER_MS[0] * (3 * host_ms + 0.5))
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(spin)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def fm_receiver_phases(dev, card: str) -> dict:
    """Phases 3, 4 and the FM part of 7; returns K1's kernel-table row."""
    import torch

    from comms_tpu_torch.kernels import fm_chain as K
    from comms_tpu_torch.models import fm_receiver as fm
    from comms_tpu_torch.runtime import StreamRunner

    taps = fm.FM_LPF_TAPS
    n_total = 3 * BLOCK + RAGGED
    t0 = time.perf_counter()
    iq, w = synth_capture(n_total, seed=0)
    print(f"capture: {n_total} samples in {time.perf_counter() - t0:.1f} s")

    def planes(a, b):
        x = torch.from_numpy(iq[a:b]).to(dev)
        return x[:, 0].contiguous(), x[:, 1].contiguous()

    # ---- 3. FM kernel vs plain
    L0 = K.launches
    re0, im0 = planes(0, BLOCK)
    re1, im1 = planes(BLOCK, 2 * BLOCK)
    ctx_mid = fm.fused_ctx_from_raw_tail(re0, im0)
    errs = {}
    for name, (re, im, ctx) in {
            "zero_ctx": (re0, im0, K.zero_ctx(dev)),
            "mid_stream_ctx": (re1, im1, ctx_mid)}.items():
        got = K.fm_chain_fused(re, im, ctx, taps, taps)
        want = K.fm_chain_plain(re, im, ctx, taps, taps)
        torch.cuda.synchronize()
        if got.shape != (BLOCK // 25,) or not torch.isfinite(got).all():
            fail(f"kernel output {name}: shape {tuple(got.shape)} or "
                 f"non-finite values")
        errs[name] = max_err(got, want)
    rng = np.random.default_rng(1)
    noise = torch.from_numpy(
        rng.integers(0, 256, size=(2, NOISE_N), dtype=np.uint8)).to(dev)
    for ctx in (K.zero_ctx(dev), ctx_mid):
        got = K.fm_chain_fused(noise[0], noise[1], ctx, taps, taps)
        want = K.fm_chain_plain(noise[0], noise[1], ctx, taps, taps)
        torch.cuda.synchronize()
        errs.setdefault("white_noise", 0.0)
        errs["white_noise"] = max(errs["white_noise"], max_err(got, want))
    print("kernel vs plain max abs err:", json.dumps(errs))
    if max(errs["zero_ctx"], errs["mid_stream_ctx"]) > TOL_KERNEL:
        fail(f"kernel disagrees with plain beyond {TOL_KERNEL}: {errs}")
    if errs["white_noise"] > TOL_NOISE:
        fail(f"kernel disagrees with plain on noise beyond {TOL_NOISE}")
    if K.launches - L0 != 4:
        fail(f"expected 4 launches in phase 3, counted {K.launches - L0}")
    max_abs_err = max(errs["zero_ctx"], errs["mid_stream_ctx"])

    # ---- 4. the FM main path: counts start at 0 here
    K.launches = 0
    cfg = fm.FmReceiverConfig(block=BLOCK)
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "capture.iq"
        iq.tofile(path)
        t0 = time.perf_counter()
        fused = fm.run_file(path, cfg, device="cuda")
        fused_s = time.perf_counter() - t0
        if K.launches != 3:
            fail(f"run_file fused: {K.launches} kernel launches, expected 3")
        unfused = fm.run_file(path, cfg, fused=False, device="cuda")
        small = Path(tmp) / "small.iq"
        iq[:2 * fm.FUSED_BLOCK_QUANTUM + RAGGED].tofile(small)
        small_cfg = fm.FmReceiverConfig(block=fm.FUSED_BLOCK_QUANTUM)
        small_gpu = fm.run_file(small, small_cfg, device="cuda")
        small_cpu = fm.run_file(small, small_cfg, device="cpu")
    want_len = fm._tail_valid_out(cfg, n_total)
    for name, a in (("fused", fused), ("unfused", unfused)):
        if a.shape != (want_len,) or not np.isfinite(a).all():
            fail(f"run_file {name}: shape {a.shape}, want ({want_len},), "
                 f"or non-finite values")
    paths_err = float(np.abs(fused - unfused).max())
    small_err = float(np.abs(small_gpu - small_cpu).max())
    corr = demod_matches_tones(fused, w)
    print(f"run_file: {want_len} audio samples, fused {fused_s:.2f} s, "
          f"fused vs unfused {paths_err:.3g}, small capture card vs CPU "
          f"{small_err:.3g}, correlation with the modulating tones "
          f"{corr:.5f}")
    if paths_err > TOL_PATHS or small_err > TOL_PATHS:
        fail("run_file paths disagree")
    if corr < 0.99:
        fail(f"demodulated audio does not follow the tones: {corr}")
    if K.launches != 5:
        fail(f"run_file: {K.launches} launches, expected 5")

    fblock = fm.make_fused_block_fn(cfg)
    dev_blocks = [planes(b * BLOCK, (b + 1) * BLOCK) for b in range(3)]
    host_blocks = [(r.cpu().pin_memory(), i.cpu().pin_memory())
                   for r, i in dev_blocks]

    def serve(blocks, n):
        outs = []
        torch.cuda.synchronize()
        runner = StreamRunner(
            lambda s, x: fblock(s, *x), fm.fused_init_state(dev),
            (blocks[i % 3] for i in range(n)), sink=outs.append,
            samples_of=lambda x: x[0].shape[0], depth=SERVE_DEPTH,
            device=dev)
        return runner.run().msps, np.concatenate(outs)

    rates, served = {}, {}
    for name, blocks in (("device", dev_blocks), ("pinned_host",
                                                  host_blocks)):
        serve(blocks, SERVE_WARMUP)   # fills the pinned-memory cache
        rates[name], served[name] = serve(blocks, SERVE_BLOCKS)
    print(f"serving Msps ({SERVE_BLOCKS} blocks of {BLOCK}, depth "
          f"{SERVE_DEPTH}, after {SERVE_WARMUP} warm-up blocks):",
          json.dumps(rates))
    if not np.array_equal(served["device"], served["pinned_host"]):
        fail("serving from device and from pinned host blocks differ")
    head = served["device"][:3 * (BLOCK // 25)]
    if float(np.abs(head - fused[:head.shape[0]]).max()) > 1e-6:
        fail("served blocks differ from run_file's blocks")

    entry = fm.FmReceiverConfig(block=ENTRY_BLOCK)
    if entry.polyphase:
        fail("the entry config must take the dense path")
    outs = {}
    for d in ("cuda", "cpu"):
        blk = fm.make_block_fn(entry)
        st = fm.init_state(entry, d)
        res = []
        for b in range(2):
            xb = torch.from_numpy(iq[b * ENTRY_BLOCK:(b + 1) * ENTRY_BLOCK])
            a, st = blk(st, xb.to(d))
            res.append(a.cpu().numpy())
        outs[d] = np.concatenate(res)
    dense_err = float(np.abs(outs["cuda"] - outs["cpu"]).max())
    print(f"entry config (dense, 2 x {ENTRY_BLOCK}): card vs CPU "
          f"{dense_err:.3g}")
    if dense_err > TOL_DENSE or outs["cuda"].shape != (
            2 * entry.audio_per_block,):
        fail("dense entry path disagrees between the card and the CPU")
    main_launches = K.launches
    expected = 5 + 2 * (SERVE_WARMUP + SERVE_BLOCKS)
    if main_launches != expected:
        fail(f"main path launched the kernel {main_launches} times, "
             f"expected {expected}")

    # ---- 7. times at the full block
    ms = cuda_ms(lambda: K.fm_chain_fused(re1, im1, ctx_mid, taps, taps))
    plain_ms = cuda_ms(lambda: K.fm_chain_plain(re1, im1, ctx_mid, taps,
                                                taps))
    print(f"fm_chain at N={BLOCK} on {card}: kernel {ms:.4f} ms "
          f"({BLOCK / ms / 1e6:.2f} Gsps), plain {plain_ms:.4f} ms")

    # Bytes: the u8 planes in, the audio out.  Operations: stage 1 (63
    # real taps on complex samples at the N/5 outputs it keeps), the demod
    # (conjugate product and degree-15 atan2, ~46 flops) and stage 2.
    nbytes = 2 * BLOCK + 4 * (BLOCK // 25)
    flops = (BLOCK // 5) * (4 * 63 + 46) + (BLOCK // 25) * 2 * 63
    return kernel_row("fm_chain_fused", "fm_chain.cu",
                      "comms_tpu/kernels/fm_chain_pallas.py:385",
                      main_launches, max_abs_err, ms, plain_ms, nbytes,
                      flops)


def print_ptxas_report(build) -> None:
    """Registers and spills over the built kernel functions."""
    import re

    log = Path(f"{build.library_path()}.log")
    if not log.exists():
        print("ptxas: no report (the library was built before this run)")
        return
    text = log.read_text()
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", text)]
    spill = sum(int(b) for b in re.findall(r"(\d+) bytes spill stores",
                                           text))
    print(f"ptxas: {len(regs)} kernel functions, {min(regs)}-{max(regs)} "
          f"registers per thread, {spill} bytes of spill stores")


def print_ptxas_kernels(build, names) -> None:
    """ptxas's registers, shared memory and spills of the kernels named
    in ``names`` (matched as the mangled name's length-prefixed part, so
    ``fir_kernel`` does not match ``decim_fir_kernel``)."""
    import re

    log = Path(f"{build.library_path()}.log")
    if not log.exists():
        return
    mangled = {f"{len(n)}{n}": n for n in names}
    current = None
    for line in log.read_text().splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            current = m.group(1)
        elif current and "Used" in line and any(k in current
                                                for k in mangled):
            short = next(n for k, n in mangled.items() if k in current)
            ti = re.search(r"ILi(\d+)E", current)
            tmpl = "<true>" if "ILb1E" in current else (
                "<false>" if "ILb0E" in current else (
                    f"<{ti.group(1)}>" if ti else ""))
            print(f"ptxas {short}{tmpl}: {line.split(':', 1)[1].strip()}")
            current = None


def station_capture(n: int, k: int, seed: int, dev):
    """f32 planes [n] on the card: one FM station at the centre of each
    of the k channels, station c carrying a tone at 0.01 + 0.04*c/(k-1)
    of the channel rate with a deviation of 0.25 of the channel spacing
    (the JAX package's tests/test_band_monitor_pallas.py:126-141), the
    sum scaled by 1/k, plus Gaussian noise of sigma 0.01.  Every phase
    step per channel frame stays within about +-pi/2.  Returns (re, im,
    tones in cycles per channel frame)."""
    import torch

    f64 = dict(dtype=torch.float64, device=dev)
    t = torch.arange(n, **f64)
    re = torch.zeros(n, **f64)
    im = torch.zeros(n, **f64)
    tones = []
    for c in range(k):
        fa = 0.01 + 0.04 * c / (k - 1)
        tones.append(fa)
        ph = (2 * np.pi * c / k) * t + (2 * np.pi * 0.25 / k) * torch.cumsum(
            torch.sin((2 * np.pi * fa / k) * t), 0)
        re += torch.cos(ph)
        im += torch.sin(ph)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    re = re / k + 0.01 * torch.randn(n, generator=g, **f64)
    im = im / k + 0.01 * torch.randn(n, generator=g, **f64)
    return re.float(), im.float(), tones


def rel_err(got, want) -> float:
    return max_err(got, want) / float(want.abs().max().item())


def bin_err(got, want) -> float:
    """The largest error of any element relative to that element of
    ``want`` (a PSD's bins are all positive)."""
    return float(((got - want).abs() / want.abs()).max().item())


def tone_ratios(audio, tones, dec: int):
    """Per channel: the spectrum's value at the channel's tone over its
    median (audio [K, n] on the card, first 64 samples skipped)."""
    import torch

    a = audio[:, 64:].double()
    a = a - a.mean(dim=1, keepdim=True)
    w = torch.hann_window(a.shape[1], periodic=False, dtype=a.dtype,
                          device=a.device)
    X = torch.fft.rfft(a * w, dim=1).abs()
    f = torch.fft.rfftfreq(a.shape[1], 1.0, device=a.device)
    out = []
    for c, fa in enumerate(tones):
        b = int((f - fa * dec).abs().argmin())
        out.append(float(X[c, b] / X[c].median()))
    return out


def band_monitor_phases(dev, card: str) -> list:
    """Phases 5, 6 and the band-monitor part of 7; returns the kernel
    table rows of K8, K2, the K3 entry and K9."""
    import torch

    from comms_tpu_torch.kernels import band_monitor as BM
    from comms_tpu_torch.kernels import channelizer as CK
    from comms_tpu_torch.kernels import decim_fir as DF
    from comms_tpu_torch.kernels import fm_chain as FK
    from comms_tpu_torch.models import channelizer as chm
    from comms_tpu_torch.models import fm_band_monitor as bm
    from comms_tpu_torch.runtime import StreamRunner

    # Plain-version calls, counted so that the main path can show none.
    plain_calls = [0]

    def counting(fn):
        def wrapped(*a, **kw):
            plain_calls[0] += 1
            return fn(*a, **kw)
        return wrapped

    for mod in (CK, DF, BM):
        mod._plain = counting(mod._plain)

    t0 = time.perf_counter()
    re16, im16, tones16 = station_capture(3 * BM_BLOCK, BM_K, 1, dev)
    re64, im64, _ = station_capture(2 * BM_BLOCK, BM_K64, 2, dev)
    torch.cuda.synchronize()
    print(f"station captures: 3 x {BM_BLOCK} (K={BM_K}) and 2 x "
          f"{BM_BLOCK} (K={BM_K64}) in {time.perf_counter() - t0:.1f} s")

    def blk(x, b):
        return x[b * BM_BLOCK:(b + 1) * BM_BLOCK]

    cfg = bm.BandMonitorConfig(num_channels=BM_K, block=BM_BLOCK)
    cfg64 = bm.BandMonitorConfig(num_channels=BM_K64, block=BM_BLOCK)
    errs = {}

    # ---- 5a. channelizer kernel vs plain (K=64 BASELINE and K=16)
    for k, re, im in ((BM_K64, re64, im64), (BM_K, re16, im16)):
        h = (cfg64 if k == BM_K64 else cfg).prototype
        zc = torch.zeros(CK.CTX_SAMPLES, device=dev)
        for name, b, cr, ci in (
                ("zero_ctx", 0, zc, zc),
                ("mid_stream_ctx", 1, blk(re, 0)[-CK.CTX_SAMPLES:],
                 blk(im, 0)[-CK.CTX_SAMPLES:])):
            got = CK.channelize_planar(blk(re, b), blk(im, b), h, cr, ci, k)
            want = CK.channelize_plain(blk(re, b), blk(im, b), h, cr, ci, k)
            torch.cuda.synchronize()
            for g, w in zip(got[:2], want[:2]):
                if g.shape != (BM_BLOCK // k, k) or not torch.isfinite(
                        g).all():
                    fail(f"channelizer K={k} {name}: shape "
                         f"{tuple(g.shape)} or non-finite values")
                e = rel_err(g, w)
                if e > TOL_CHAN:
                    fail(f"channelizer K={k} {name}: {e} > {TOL_CHAN}")
                errs[f"channelize_K{k}_{name}"] = (max_err(g, w), e)

    # ---- 5b. decimating FIR at the staged audio stage's shapes, and
    # the poly-FIR entry at dec 5 with 63 and 641 taps
    rng = np.random.default_rng(3)
    rows, n_ch = BM_K // 2, BM_BLOCK // BM_K
    W = cfg.audio_dec * 128
    tile = bm._audio_tile_rows(cfg)

    def dev_normal(*shape):
        return torch.from_numpy(
            rng.normal(size=shape).astype(np.float32)).to(dev)

    dr, di = dev_normal(rows, n_ch), dev_normal(rows, n_ch)
    fcr, fci = dev_normal(rows, W), dev_normal(rows, W)
    got = DF.fir_decimate_planar(dr, di, cfg.audio_taps, cfg.audio_dec,
                                 fcr, fci, tile_rows=tile)
    want = DF.fir_decimate_plain(dr, di, cfg.audio_taps, cfg.audio_dec,
                                 fcr, fci)
    torch.cuda.synchronize()
    g, w = torch.complex(got[0], got[1]), torch.complex(*want)
    errs["fir_decimate_staged"] = (max_err(g, w), rel_err(g, w))
    pr, pi = dev_normal(POLY_N), dev_normal(POLY_N)
    pcr = dev_normal(DF.CTX_ROWS * POLY_DEC * 128)
    pci = dev_normal(DF.CTX_ROWS * POLY_DEC * 128)
    poly_taps = {n: rng.normal(size=n) for n in (63, 641)}
    for n, h in poly_taps.items():
        got = DF.poly_fir_planar(pr, pi, h, pcr, pci, POLY_DEC)
        want = DF.fir_decimate_plain(pr, pi, h, POLY_DEC, pcr, pci)
        torch.cuda.synchronize()
        g, w = torch.complex(got[0], got[1]), torch.complex(*want)
        errs[f"poly_fir_{n}_taps"] = (max_err(g, w), rel_err(g, w))
    for name in ("fir_decimate_staged", "poly_fir_63_taps",
                 "poly_fir_641_taps"):
        if not errs[name][1] <= TOL_FIR:
            fail(f"{name}: {errs[name]} beyond {TOL_FIR}")

    # ---- 5c. fused band monitor vs plain on the station captures, from
    # zero and mid-stream state, then on white noise
    for c, re, im in ((cfg, re16, im16), (cfg64, re64, im64)):
        args = (c.prototype, c.audio_taps, c.audio_dec)
        st = bm.init_state_fused(c, dev)
        for name, b in (("zero_state", 0), ("mid_stream_state", 1)):
            got = BM.band_monitor_planar(blk(re, b), blk(im, b), *args, *st,
                                         num_channels=c.num_channels)
            want = BM.band_monitor_plain(blk(re, b), blk(im, b), *args,
                                         *st, num_channels=c.num_channels)
            torch.cuda.synchronize()
            if not torch.isfinite(got[0]).all():
                fail(f"band monitor K={c.num_channels} {name}: non-finite")
            e = rel_err(got[0], want[0])
            es = max(rel_err(got[3], want[3]), rel_err(got[4], want[4]))
            if e > TOL_BM or es > TOL_CHAN or not (
                    torch.equal(got[1], want[1])
                    and torch.equal(got[2], want[2])):
                fail(f"band monitor K={c.num_channels} {name}: audio "
                     f"{e}, spectrum tail {es}")
            errs[f"band_monitor_K{c.num_channels}_{name}"] = (
                max_err(got[0], want[0]), e)
            st = got[1:]
    g = torch.Generator(device=dev)
    g.manual_seed(4)
    for c in (cfg, cfg64):
        args = (c.prototype, c.audio_taps, c.audio_dec)
        sk = sp = bm.init_state_fused(c, dev)
        for _ in range(3):
            x = torch.randn(2, BM_NOISE, generator=g, device=dev)
            got = BM.band_monitor_planar(x[0], x[1], *args, *sk,
                                         num_channels=c.num_channels)
            want = BM.band_monitor_plain(x[0], x[1], *args, *sp,
                                         num_channels=c.num_channels)
            torch.cuda.synchronize()
            e = rel_err(got[0], want[0])
            if e > TOL_BM:
                fail(f"band monitor K={c.num_channels} white noise: {e}")
            key = f"band_monitor_K{c.num_channels}_white_noise"
            errs[key] = max(errs.get(key, (0.0, 0.0)),
                            (max_err(got[0], want[0]), e))
            sk, sp = got[1:], want[1:]
    print("band monitor kernels vs plain (max abs err, relative):",
          json.dumps(errs))

    # ---- 6. the band monitor main path: every count starts at 0 here
    CK.launches = DF.launches = BM.launches = FK.launches = 0
    plain_calls[0] = 0
    fblock = bm.make_fused_block_fn(cfg)
    dev_blocks = [(blk(re16, b), blk(im16, b)) for b in range(3)]
    host_blocks = [(r.cpu().pin_memory(), i.cpu().pin_memory())
                   for r, i in dev_blocks]

    def serve(blocks, n):
        outs = []
        torch.cuda.synchronize()
        runner = StreamRunner(
            lambda s, x: fblock(s, *x), bm.init_state_fused(cfg, dev),
            (blocks[i % 3] for i in range(n)), sink=outs.append,
            samples_of=lambda x: x[0].shape[0], depth=SERVE_DEPTH,
            device=dev)
        return runner.run().msps, outs

    rates, served = {}, {}
    for name, blocks in (("device", dev_blocks),
                         ("pinned_host", host_blocks)):
        serve(blocks, SERVE_WARMUP)
        rates[name], served[name] = serve(blocks, SERVE_BLOCKS)
    print(f"band monitor serving Msps (K={BM_K}, {SERVE_BLOCKS} blocks of "
          f"{BM_BLOCK}, depth {SERVE_DEPTH}, after {SERVE_WARMUP} warm-up "
          f"blocks) on {card}:", json.dumps(rates))
    fused_counts = (BM.launches, CK.launches, DF.launches, plain_calls[0])
    if fused_counts != (2 * (SERVE_WARMUP + SERVE_BLOCKS), 0, 0, 0):
        fail(f"fused serving: (K9, K8, K2, plain) launches {fused_counts}")
    for a, b in zip(served["device"], served["pinned_host"]):
        if not np.array_equal(a, b):
            fail("serving from device and from pinned host blocks differ")
    if served["device"][0].shape != (BM_K, cfg.audio_per_channel):
        fail(f"served audio shape {served['device'][0].shape}")

    staged = bm.make_planar_block_fn(cfg)
    st = bm.init_state(cfg, dev)
    staged_out = []
    for r, i in dev_blocks:
        a, st = staged(st, r, i)
        staged_out.append(a)
    fused3 = torch.from_numpy(np.concatenate(served["device"][:3], 1)).to(
        dev)
    staged3 = torch.cat(staged_out, 1)
    e_paths = rel_err(fused3, staged3)
    ratios = tone_ratios(fused3, tones16, cfg.audio_dec)
    print(f"fused vs staged (3 blocks): {e_paths:.3g} relative; tone peak "
          f"over spectrum median per channel: "
          f"{json.dumps([round(r, 1) for r in ratios])}")
    if not e_paths <= TOL_BM:
        fail(f"fused and staged band monitor disagree: {e_paths}")
    if min(ratios) <= 10:
        fail(f"a channel's tone does not stand out: {ratios}")

    chcfg = chm.ChannelizerConfig(num_channels=BM_K64, block=BM_BLOCK)
    ch_k, ch_t = (chm.make_planar_block_fn(chcfg),
                  chm.make_planar_block_fn(chcfg, use_kernel=False))
    sk = st_ = chm.init_state(chcfg, dev)
    e_ch = 0.0
    for r, i in dev_blocks:
        (yr, yi), sk = ch_k(sk, r, i)
        (tr, ti), st_ = ch_t(st_, r, i)
        e_ch = max(e_ch, rel_err(yr, tr), rel_err(yi, ti))
        if not torch.equal(sk, st_) or not torch.isfinite(yr).all():
            fail("channelizer model: state or output wrong")
    print(f"channelizer model (K={BM_K64}, 3 blocks): kernel vs tensor "
          f"route {e_ch:.3g} relative")
    if not e_ch <= TOL_CHAN:
        fail(f"channelizer model routes disagree: {e_ch}")
    torch.cuda.synchronize()
    main_counts = {"band_monitor": BM.launches, "channelize": CK.launches,
                   "fir_decimate": DF.launches, "fm_chain": FK.launches,
                   "plain": plain_calls[0]}
    print("band monitor main path launches:", json.dumps(main_counts))
    want_counts = {"band_monitor": 2 * (SERVE_WARMUP + SERVE_BLOCKS),
                   "channelize": 6, "fir_decimate": 3, "fm_chain": 0,
                   "plain": 0}
    if main_counts != want_counts:
        fail(f"main path launches {main_counts}, expected {want_counts}")

    # ---- 7. times at the main paths' shapes
    mid64 = (blk(re64, 0)[-CK.CTX_SAMPLES:].clone(),
             blk(im64, 0)[-CK.CTX_SAMPLES:].clone())
    bm_state = BM.band_monitor_planar(
        blk(re16, 0), blk(im16, 0), cfg.prototype, cfg.audio_taps,
        cfg.audio_dec, *bm.init_state_fused(cfg, dev), num_channels=BM_K)[1:]
    bm_args = (blk(re16, 1), blk(im16, 1), cfg.prototype, cfg.audio_taps,
               cfg.audio_dec, *bm_state)
    timed = {
        "channelize": (
            lambda: CK.channelize_planar(blk(re64, 1), blk(im64, 1),
                                         cfg64.prototype, *mid64, BM_K64),
            lambda: CK.channelize_plain(blk(re64, 1), blk(im64, 1),
                                        cfg64.prototype, *mid64, BM_K64),
            f"K={BM_K64}, N={BM_BLOCK}", BM_BLOCK),
        "fir_decimate": (
            lambda: DF.fir_decimate_planar(dr, di, cfg.audio_taps,
                                           cfg.audio_dec, fcr, fci,
                                           tile_rows=tile),
            lambda: DF.fir_decimate_plain(dr, di, cfg.audio_taps,
                                          cfg.audio_dec, fcr, fci),
            f"{rows} rows x {n_ch}, dec {cfg.audio_dec}, "
            f"{cfg.audio_taps.shape[0]} taps", 2 * rows * n_ch),
        "poly_fir": (
            lambda: DF.poly_fir_planar(pr, pi, poly_taps[63], pcr, pci,
                                       POLY_DEC),
            lambda: DF.fir_decimate_plain(pr, pi, poly_taps[63], POLY_DEC,
                                          pcr, pci),
            f"N={POLY_N}, dec {POLY_DEC}, 63 taps", POLY_N),
        "band_monitor": (
            lambda: BM.band_monitor_planar(*bm_args, num_channels=BM_K),
            lambda: BM.band_monitor_plain(*bm_args, num_channels=BM_K),
            f"K={BM_K}, N={BM_BLOCK}", BM_BLOCK),
    }
    times = {}
    for name, (kern, plain, shape, n) in timed.items():
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
        times[name] = (ms, plain_ms)
        print(f"{name} at {shape} on {card}: kernel {ms:.4f} ms "
              f"({n / ms / 1e6:.2f} Gsps), plain {plain_ms:.4f} ms")

    # The library yardstick of the two FIR entries: F.conv1d with the
    # stride of the decimation, on the same planes and contexts.
    T = cfg.audio_taps.shape[0]
    lib_dec = conv1d_ms(
        torch.cat([torch.cat([fcr[:, -(T - 1):], dr], 1),
                   torch.cat([fci[:, -(T - 1):], di], 1)]),
        cfg.audio_taps, cfg.audio_dec,
        want=torch.cat(DF.fir_decimate_planar(
            dr, di, cfg.audio_taps, cfg.audio_dec, fcr, fci,
            tile_rows=tile)[:2]))
    h63 = poly_taps[63]
    lib_poly = conv1d_ms(
        torch.stack([torch.cat([pcr[-62:], pr]), torch.cat([pci[-62:], pi])]),
        h63, POLY_DEC,
        want=torch.stack(DF.poly_fir_planar(pr, pi, h63, pcr, pci,
                                            POLY_DEC)[:2]))
    print(f"library (F.conv1d) on {card}: fir_decimate {lib_dec:.4f} ms, "
          f"poly_fir {lib_poly:.4f} ms")

    def worst(prefix):
        return max(v[0] for k, v in errs.items() if k.startswith(prefix))

    # Bytes and operations from the shapes (complex samples 8 bytes; real
    # taps on complex samples 4 flops a tap; the filterbank's K-point DFT
    # as an FFT, 5 K log2(K) flops per K samples; the demod ~46 flops a
    # channel sample).
    N, M16, M64 = BM_BLOCK, cfg.taps_per_branch, cfg64.taps_per_branch
    dec = cfg.audio_dec
    n_in = rows * n_ch
    table = [
        ("channelize", "channelizer.cu",
         "comms_tpu/kernels/channelizer_pallas.py:305",
         main_counts["channelize"], worst("channelize_"),
         16 * N, N * (4 * M64 + 5 * np.log2(BM_K64)), None),
        ("fir_decimate", "decim_fir.cu",
         "comms_tpu/kernels/decim_fir_pallas.py:262",
         main_counts["fir_decimate"], worst("fir_decimate_"),
         8 * n_in + 8 * n_in // dec, 4 * T * n_in // dec, lib_dec),
        # The poly-FIR entry launches the same kernel as fir_decimate;
        # its count is that kernel's.
        ("poly_fir", "decim_fir.cu",
         "comms_tpu/kernels/poly_fir_pallas.py:173",
         main_counts["fir_decimate"], worst("poly_fir_"),
         8 * POLY_N + 8 * POLY_N // POLY_DEC, 4 * 63 * POLY_N // POLY_DEC,
         lib_poly),
        ("band_monitor", "band_monitor.cu",
         "comms_tpu/kernels/band_monitor_pallas.py:349",
         main_counts["band_monitor"], worst("band_monitor_"),
         8 * N + 4 * N // dec,
         N * (4 * M16 + 5 * np.log2(BM_K) + 46) + 2 * T * N // dec, None),
    ]
    return [kernel_row(name, f, rep, n, err, times[name][0],
                       times[name][1], nbytes, flops, lib)
            for name, f, rep, n, err, nbytes, flops, lib in table]


def qpsk_capture(dev, seed: int):
    """The QPSK capture: float32 planes [QPSK_N] on the card and the bits
    of one period (numpy uint8 [QPSK_PERIOD / 2]).  Random bits (numpy),
    the consecutive-bit-pair map, qpsk_tx's RRC pulse (sps 4, 32 taps,
    beta 0.25, not normalised: 1.41 rms, the level the JAX tests add
    their noise to) and a delay of QPSK_DELAY samples applied to one
    period circularly (float64 FFTs, no cuDNN), the period repeated, the
    carrier offset with its global phase, complex Gaussian noise."""
    import torch

    from comms_tpu_torch.ops import taps as ttaps

    f64 = dict(dtype=torch.float64, device=dev)
    L = QPSK_PERIOD
    bits = np.random.default_rng(seed).integers(0, 2, size=L // 2,
                                                dtype=np.uint8)
    b = torch.from_numpy(bits.astype(np.float64)).to(dev)
    up = torch.zeros(L, dtype=torch.complex128, device=dev)
    up[::4] = torch.complex(2.0 * b[0::2] - 1.0, 2.0 * b[1::2] - 1.0)
    h = np.real(ttaps.rrc_taps(32, 4.0, 0.25))
    hp = torch.zeros(L, **f64)
    hp[:32] = torch.from_numpy(h)
    k = torch.fft.fftfreq(L, **f64)
    base = torch.fft.ifft(torch.fft.fft(up) * torch.fft.fft(hp)
                          * torch.exp(-2j * np.pi * QPSK_DELAY * k))
    n = torch.arange(QPSK_N, **f64)
    x = base.repeat(QPSK_N // L) * torch.exp(1j * (QPSK_CFO * n
                                                   + QPSK_PHASE))
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    noise = QPSK_NOISE * torch.randn(2, QPSK_N, generator=g, **f64)
    return ((x.real + noise[0]).float().contiguous(),
            (x.imag + noise[1]).float().contiguous(), bits)


def qpsk_bit_errors(sym, first: int, bits, rot: int, lag: int):
    """Bit errors of symbol planes ``sym`` [2, M] (on the card), whose
    symbol 0 is stream symbol ``first``, against the periodic reference
    bits: stream symbol g decides transmitted symbol g - lag after a
    rotation by j^rot."""
    import torch

    re, im = sym[0], sym[1]
    for _ in range(rot % 4):
        re, im = -im, re
    ref = torch.from_numpy(bits.reshape(-1, 2).astype(bool)).to(sym.device)
    idx = (torch.arange(sym.shape[1], device=sym.device) + first - lag) % (
        ref.shape[0])
    want = ref[idx]
    return int(((re > 0) != want[:, 0]).sum() + ((im > 0) != want[:, 1])
               .sum())


def qpsk_align(sym, first: int, bits):
    """``(rot, lag)`` of the best of the 4 rotations x symbol lags in
    [0, 16] on 1500 symbols from ``sym`` [2, M] (stream symbol ``first``
    at index 0), and its errors there."""
    from comms_tpu_torch.models import qpsk_rx as trx

    Ls = bits.shape[0] // 2
    head = sym[:, :4096].cpu().numpy()
    ref = bits.reshape(-1, 2)[(first + np.arange(4096)) % Ls].reshape(-1)
    (rot, lag), errs, _ = trx.resolve_ambiguity(head, ref, search=1500)
    return rot, lag, errs


def qpsk_phases(dev, card: str) -> list:
    """Phases 8-10; returns the kernel table rows of K4, K5's three
    entries and K11."""
    import torch

    from comms_tpu_torch.kernels import fir as FK
    from comms_tpu_torch.kernels import panel_reduce as PR
    from comms_tpu_torch.kernels import qpsk_sym as QS
    from comms_tpu_torch.models import qpsk_rx as trx
    from comms_tpu_torch.models import qpsk_rx_stream as tstream
    from comms_tpu_torch.ops import interp as tinterp
    from comms_tpu_torch.runtime import StreamRunner

    plain_calls = [0]

    def counting(fn):
        def wrapped(*a, **kw):
            plain_calls[0] += 1
            return fn(*a, **kw)
        return wrapped

    QS.qpsk_symbol_plain = counting(QS.qpsk_symbol_plain)
    QS.qpsk_panels_plain = counting(QS.qpsk_panels_plain)
    FK.fir_plain = counting(FK.fir_plain)
    PR.panel_reductions_plain = counting(PR.panel_reductions_plain)

    t0 = time.perf_counter()
    re, im, bits = qpsk_capture(dev, seed=7)
    torch.cuda.synchronize()
    print(f"QPSK capture: {QPSK_N} samples (period {QPSK_PERIOD}) in "
          f"{time.perf_counter() - t0:.1f} s")
    cfg = trx.QpskRxConfig()
    hw = cfg.panel_hw
    errs = {}

    def rel(a, b):
        return max_err(a, b), rel_err(a, b)

    # ---- 8a. the FIR kernel: the matched filter (zero context) and 257
    # complex taps from a mid-stream context
    cz_r, cz_i = FK.planar_ctx_zero(dev)
    mid_r, mid_i = FK.planar_ctx_from_tail(im, re)
    rng = np.random.default_rng(8)
    taps257 = rng.normal(size=257) + 1j * rng.normal(size=257)
    fir_cases = {"fir_mf_32": (cfg.mf_taps, cz_r, cz_i),
                 "fir_257_complex": (taps257, mid_r.contiguous(),
                                     mid_i.contiguous())}
    for name, (h, cr, ci) in fir_cases.items():
        yr, yi, _, _ = FK.fir_planar(re, im, h, cr, ci)
        wr, wi = FK.fir_plain(re, im, h, cr, ci)
        torch.cuda.synchronize()
        g, w = torch.complex(yr, yi), torch.complex(wr, wi)
        if g.shape != (QPSK_N,) or not torch.isfinite(g).all():
            fail(f"{name}: shape {tuple(g.shape)} or non-finite values")
        errs[name] = rel(g, w)
        if errs[name][1] > TOL_FIR:
            fail(f"{name}: {errs[name]} beyond {TOL_FIR}")

    # ---- 8b. the symbol kernel's entries at full width
    w_est = torch.tensor(0.0101, device=dev)
    lag = torch.from_numpy(tinterp.lagrange_taps(0.3).astype(
        np.float32)).to(dev)
    shift2 = torch.tensor(-1, dtype=torch.int32, device=dev)
    phase0 = 0.31
    fr, fi = trx.modulated_taps(cfg, w_est, lag, shift2)
    ws = w_est * 4
    C = trx.fused_gemm_ctx_len(cfg)
    ctx_mid = (im[-C:].clone(), re[-C:].clone())
    panels_plain = QS.qpsk_panels_plain(re, im, hw)
    pscale = max(float(p.abs().max()) for p in panels_plain[:4])

    def panel_err(got):
        return max(max_err(g, w) for g, w in zip(got[:4], panels_plain[:4]))

    sym_plain = {}
    for name, ctx in (("zero_ctx", None), ("mid_stream_ctx", ctx_mid)):
        sr, si, pan = QS.qpsk_symbol_gemm(re, im, fr, fi, ws, phase0, ctx,
                                          panels_hw=hw)
        pr, pi = QS.qpsk_symbol_plain(re, im, fr, fi, ws, phase0, ctx)
        torch.cuda.synchronize()
        g, w = torch.complex(sr, si), torch.complex(pr, pi)
        sym_plain[name] = w
        if g.shape != (QPSK_N // 4,) or not torch.isfinite(g).all():
            fail(f"symbol kernel {name}: shape or non-finite values")
        errs[f"qpsk_symbol_gemm_{name}"] = rel(g, w)
        errs[f"qpsk_symbol_gemm_panels_{name}"] = (panel_err(pan),
                                                   panel_err(pan) / pscale)
    kr, ki, kpan = QS.qpsk_symbol_gemm_scalars(
        re, im, cfg.mf_taps, w_est, lag, shift2, phase0=phase0, ctx=ctx_mid,
        panels_hw=hw)
    torch.cuda.synchronize()
    errs["qpsk_symbol_gemm_scalars"] = rel(torch.complex(kr, ki),
                                           sym_plain["mid_stream_ctx"])
    errs["qpsk_symbol_gemm_scalars_panels"] = (panel_err(kpan),
                                               panel_err(kpan) / pscale)
    qp = QS.qpsk_panels(re, im, hw)
    again = QS.qpsk_panels(re, im, hw)
    torch.cuda.synchronize()
    errs["qpsk_panels"] = (panel_err(qp), panel_err(qp) / pscale)
    if not all(torch.equal(a, b) for a, b in zip(qp[:4], again[:4])):
        fail("the panels differ between two runs")
    if not all(torch.equal(a, b) for a, b in zip(qp[:4], kpan[:4])):
        fail("the panels of the panel entry and the _scalars entry differ")
    for k, (_, e) in errs.items():
        tol = TOL_PANEL if "panel" in k else (
            TOL_SYM if k.startswith("qpsk") else TOL_FIR)
        if not e <= tol:
            fail(f"{k}: {e} beyond {tol}")
    blk = QS.IN_PER_STEP
    routes = [trx._fused_symbol_gemm(
        trx.QpskRxConfig(use_kernel=uk), re[:blk], im[:blk], w_est, lag,
        shift2, ctx=ctx_mid, phase0=phase0) for uk in (None, False)]
    torch.cuda.synchronize()
    e_route = rel_err(torch.complex(*routes[0]), torch.complex(*routes[1]))
    if not e_route <= TOL_ROUTE:
        fail(f"symbol kernel route vs tensor route: {e_route}")

    # ---- 8c. the panel reductions on the capture's panels
    p13 = torch.zeros((256, 256), device=dev)
    p24 = torch.zeros((256, 256), device=dev)
    width = qp[4]["width"]
    p13[:128, :width], p13[128:, :width] = qp[0], qp[2]
    p24[:128, :width], p24[128:, :width] = -qp[1], -qp[3]
    red = PR.panel_reductions(p13, p24, hw)
    red_plain = PR.panel_reductions_plain(p13, p24, hw)
    torch.cuda.synchronize()
    rows = [0, 1] + [8 + a for a in range(cfg.sps)]
    V = 2 * hw + 1
    errs["panel_reductions"] = rel(red[rows][:, :V], red_plain[rows][:, :V])
    gr, gi = cfg.timing.lag_sums_r2(qp)
    f_rot = float(torch.atan2(gi[hw - 1], gr[hw - 1]))
    f_model = float(trx._estimates_from_panels(cfg, qp)[0])
    print(f"panel reductions: row 2 {float(red[2, 0]):.7f} rad (plain "
          f"{float(red_plain[2, 0]):.7f}, angle of the r2-rotated v=-1 lag "
          f"sum {f_rot:.7f}; the receiver's f_est {f_model:.7f})")
    if not errs["panel_reductions"][1] <= TOL_REDUCE:
        fail(f"panel reductions: {errs['panel_reductions']}")
    if max(abs(float(red[2, 0]) - float(red_plain[2, 0])),
           abs(float(red[2, 0]) - f_rot)) > 1e-5:
        fail("panel reductions: row 2 is not the rotated v=-1 angle")
    print("QPSK kernels vs plain (max abs err, relative):", json.dumps(errs),
          f"kernel route vs tensor route {e_route:.3g}")

    # ---- 9a. the one-shot main paths: counts start at 0 here
    FK.launches = PR.launches = 0
    for k in QS.launches:
        QS.launches[k] = 0
    plain_calls[0] = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    sym, diag = trx.make_rx_fn_planar(cfg)(re, im)
    torch.cuda.synchronize()
    rx_s = time.perf_counter() - t0
    M = QPSK_N // 4
    rot, lag0, head_errs = qpsk_align(sym, 0, bits)
    lo, hi = lag0 + QPSK_MARGIN, M - QPSK_MARGIN
    ber = qpsk_bit_errors(sym[:, lo:hi], lo, bits, rot, lag0)
    sym_s, diag_s = trx._rx_core_staged(cfg, re, im)
    rot_s, lag_s, _ = qpsk_align(sym_s, 0, bits)
    ber_s = qpsk_bit_errors(sym_s[:, lo:hi], lo, bits, rot_s, lag_s)
    # the capture's timing estimate from the panel reductions' lag sums
    red_main = PR.panel_reductions(p13, p24, hw)
    t_k11 = cfg.timing.estimate_from_lag_sums(
        red_main[0, :V], red_main[1, :V], weights=cfg.wq2,
        lag_rot=diag["freq"])
    one_shot = {k: float(v) for k, v in diag.items()}
    staged = {k: float(v) for k, v in diag_s.items()}
    print(f"one-shot receiver ({QPSK_N} samples, {rx_s:.3f} s incl. the "
          f"first call's set-up): {json.dumps(one_shot)}; lag {lag0} rot "
          f"{rot}; {ber} bit errors over {2 * (hi - lo)} bits")
    print(f"staged core: {json.dumps(staged)}; {ber_s} bit errors; timing "
          f"from the panel reductions {float(t_k11):.6f}")
    if ber or ber_s or head_errs:
        fail(f"bit errors: one-shot {ber}, staged {ber_s}")
    if abs(one_shot["freq"] - QPSK_CFO) >= 0.01:
        fail(f"frequency estimate {one_shot['freq']}")
    if (one_shot["sym_phase"] != staged["sym_phase"]
            or abs(one_shot["freq"] - staged["freq"]) >= 2e-3
            or abs(one_shot["timing"] - staged["timing"]) >= 1e-2):
        fail("fused and staged cores disagree")
    if abs(float(t_k11) - one_shot["timing"]) > 1e-4:
        fail(f"timing from the panel reductions {float(t_k11)}")
    one_shot_counts = {"qpsk_panels": QS.launches["qpsk_panels"],
                       "qpsk_symbol_gemm": QS.launches["qpsk_symbol_gemm"],
                       "qpsk_symbol_gemm_scalars":
                           QS.launches["qpsk_symbol_gemm_scalars"],
                       "fir_planar": FK.launches,
                       "panel_reductions": PR.launches,
                       "plain": plain_calls[0]}
    print("QPSK one-shot main path launches:", json.dumps(one_shot_counts))
    want = {"qpsk_panels": 1, "qpsk_symbol_gemm": 1,
            "qpsk_symbol_gemm_scalars": 1, "fir_planar": 1,
            "panel_reductions": 1, "plain": 0}
    if one_shot_counts != want:
        fail(f"one-shot launches {one_shot_counts}, expected {want}")

    # ---- 9b. serving: 8 gap-free blocks (block k is the capture turned by
    # the carrier's phase advance over k blocks); counts start at 0 here
    blocks = []
    for b in range(SERVE_BLOCKS):
        a = (QPSK_CFO * b * QPSK_N) % (2 * np.pi)
        c, s_ = float(np.cos(a)), float(np.sin(a))
        blocks.append(((re * c - im * s_).contiguous(),
                       (re * s_ + im * c).contiguous()))
    host_blocks = [(r.cpu().pin_memory(), i.cpu().pin_memory())
                   for r, i in blocks]
    step = tstream.make_stream_fused_fn(cfg)
    FK.launches = PR.launches = 0
    for k in QS.launches:
        QS.launches[k] = 0
    plain_calls[0] = 0

    def serve(blks, n):
        outs = []
        torch.cuda.synchronize()
        runner = StreamRunner(
            lambda st, x: step(st, *x), tstream.init_state_fast(cfg, dev),
            (blks[i] for i in range(n)), sink=outs.append,
            samples_of=lambda x: x[0].shape[0], depth=SERVE_DEPTH,
            device=dev)
        return runner.run().msps, outs, runner.state

    rates, served, states = {}, {}, {}
    for name, blks in (("device", blocks), ("pinned_host", host_blocks)):
        serve(blks, SERVE_WARMUP)
        rates[name], served[name], states[name] = serve(blks, SERVE_BLOCKS)
    torch.cuda.synchronize()
    serve_counts = {"qpsk_symbol_gemm_scalars":
                    QS.launches["qpsk_symbol_gemm_scalars"],
                    "qpsk_symbol_gemm": QS.launches["qpsk_symbol_gemm"],
                    "qpsk_panels": QS.launches["qpsk_panels"],
                    "plain": plain_calls[0]}
    print(f"QPSK serving Msps ({SERVE_BLOCKS} blocks of {QPSK_N}, depth "
          f"{SERVE_DEPTH}, after {SERVE_WARMUP} warm-up blocks) on {card}:",
          json.dumps(rates), "launches:", json.dumps(serve_counts))
    n_served = 2 * (SERVE_WARMUP + SERVE_BLOCKS)
    if serve_counts != {"qpsk_symbol_gemm_scalars": n_served,
                        "qpsk_symbol_gemm": 0, "qpsk_panels": 0,
                        "plain": 0}:
        fail(f"serving launches {serve_counts}")
    for a, b in zip(served["device"], served["pinned_host"]):
        if not np.array_equal(a, b):
            fail("serving from device and from pinned host blocks differ")
    # block 0 of a run is the warm-up block; then one lag for all seams
    stream_sym = torch.from_numpy(np.concatenate(served["device"][1:],
                                                 axis=1)).to(dev)
    rot_v, lag_v, _ = qpsk_align(stream_sym, M, bits)
    ber_v = qpsk_bit_errors(stream_sym, M, bits, rot_v, lag_v)
    print(f"served stream: lag {lag_v} rot {rot_v}; {ber_v} bit errors over "
          f"{2 * stream_sym.shape[1]} bits (blocks 1-{SERVE_BLOCKS - 1})")
    if ber_v:
        fail(f"served stream: {ber_v} bit errors")
    del stream_sym

    fast = tstream.make_stream_fast_fn(cfg)
    st_f = tstream.init_state_fast(cfg, dev)
    e_fast = 0.0
    for b, (r, i) in enumerate(blocks):
        y, st_f = fast(st_f, r, i)
        w = torch.from_numpy(served["device"][b]).to(dev)
        e_fast = max(e_fast, rel_err(y, w))
    # the state as the JAX test holds it: |a - b| <= tol + tol * |b|
    e_state = max(float(((st_f[k].double() - states["device"][k].double())
                         .abs() / (1.0 + states["device"][k].double()
                                   .abs())).max()) for k in st_f)
    print(f"fast vs fused stream step: symbols {e_fast:.3g} relative, state "
          f"{e_state:.3g}")
    if e_fast > TOL_STREAM_SYM or e_state > TOL_STREAM_STATE:
        fail("fast and fused stream steps disagree")

    st = states["device"]
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    for r, i in blocks[:2]:
        y, st = step(st, r, i)
    torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    print("fused stream step: 2 blocks under set_sync_debug_mode('error')")

    # ---- 10. times at the main paths' shapes
    cz = FK.planar_ctx_zero(dev)
    timed = {
        "fir_planar": (
            lambda: FK.fir_planar(re, im, cfg.mf_taps, *cz),
            lambda: FK.fir_plain(re, im, cfg.mf_taps, *cz),
            "32 real taps"),
        "qpsk_symbol_gemm": (
            lambda: QS.qpsk_symbol_gemm(re, im, fr, fi, ws, phase0, ctx_mid,
                                        panels_hw=hw),
            lambda: (QS.qpsk_symbol_plain(re, im, fr, fi, ws, phase0,
                                          ctx_mid),
                     QS.qpsk_panels_plain(re, im, hw)),
            f"traced taps, panels hw {hw}"),
        "qpsk_symbol_gemm_scalars": (
            lambda: QS.qpsk_symbol_gemm_scalars(
                re, im, cfg.mf_taps, w_est, lag, shift2, phase0=phase0,
                ctx=ctx_mid, panels_hw=hw),
            lambda: (QS.qpsk_symbol_plain(
                re, im, *trx.modulated_taps(cfg, w_est, lag, shift2), ws,
                phase0, ctx_mid), QS.qpsk_panels_plain(re, im, hw)),
            f"taps from the estimates, panels hw {hw} (the served call)"),
        "qpsk_panels": (
            lambda: QS.qpsk_panels(re, im, hw),
            lambda: QS.qpsk_panels_plain(re, im, hw), f"hw {hw}"),
        "panel_reductions": (
            lambda: PR.panel_reductions(p13, p24, hw),
            lambda: PR.panel_reductions_plain(p13, p24, hw),
            f"[256, 256] x 2, hw {hw}"),
    }
    times = {}
    for name, (kern, plain, what) in timed.items():
        ms = cuda_ms(kern)
        plain_ms = cuda_ms(plain)
        times[name] = (ms, plain_ms)
        print(f"{name} at N={QPSK_N} ({what}) on {card}: kernel {ms:.4f} ms, "
              f"plain {plain_ms:.4f} ms")
    sym_ms = cuda_ms(lambda: QS.qpsk_symbol_gemm(re, im, fr, fi, ws, phase0,
                                                 ctx_mid))
    sym_plain_ms = cuda_ms(lambda: QS.qpsk_symbol_plain(re, im, fr, fi, ws,
                                                        phase0, ctx_mid))
    print(f"qpsk_symbol_gemm symbols only at N={QPSK_N} on {card}: kernel "
          f"{sym_ms:.4f} ms, plain {sym_plain_ms:.4f} ms")
    qpsk_profile(step, st, blocks[2], card)

    T = cfg.mf_taps.shape[0]
    lib_fir = conv1d_ms(
        torch.nn.functional.pad(torch.stack([re, im]), (T - 1, 0)),
        cfg.mf_taps, 1,
        want=torch.stack(FK.fir_planar(re, im, cfg.mf_taps, *cz)[:2]))
    print(f"library (F.conv1d) on {card}: fir_planar {lib_fir:.4f} ms")

    def worst(prefix):
        return max(v[0] for k, v in errs.items() if k.startswith(prefix))

    launches = {k: one_shot_counts[k] + serve_counts.get(k, 0)
                for k in ("fir_planar", "qpsk_symbol_gemm",
                          "qpsk_symbol_gemm_scalars", "qpsk_panels",
                          "panel_reductions")}
    # Bytes and operations from the shapes: complex taps on complex
    # samples 8 flops a tap at the N/4 symbols; the four panels 4w
    # multiply-adds a sample (w = 128 + 2hw); the reductions' 12 flops per
    # panel entry they read.
    N, MD, w = QPSK_N, int(fr.shape[0]), 128 + 2 * hw
    sym = (8 * N + 8 * N // 4, 2 * MD * N)
    pan = (8 * N, 8 * w * N)
    table = [
        ("fir_planar", "fir.cu", "comms_tpu/kernels/fir_pallas.py:253",
         worst("fir_"), 16 * N, 4 * T * N, lib_fir),
        ("qpsk_symbol_gemm", "qpsk_sym.cu",
         "comms_tpu/kernels/qpsk_sym_pallas.py:643",
         worst("qpsk_symbol_gemm_"), sym[0], sym[1] + pan[1], None),
        ("qpsk_symbol_gemm_scalars", "qpsk_sym.cu",
         "comms_tpu/kernels/qpsk_sym_pallas.py:501",
         worst("qpsk_symbol_gemm_scalars"), sym[0], sym[1] + pan[1], None),
        ("qpsk_panels", "qpsk_sym.cu",
         "comms_tpu/kernels/qpsk_sym_pallas.py:553", worst("qpsk_panels"),
         pan[0], pan[1], None),
        ("panel_reductions", "panel_reduce.cu",
         "comms_tpu/kernels/panel_reduce_pallas.py:125",
         worst("panel_reductions"), 2 * 256 * 256 * 4 + 16 * 128 * 4,
         12 * (2 * hw + 1) * 128, None),
    ]
    return [kernel_row(name, f, rep, launches[name], err, times[name][0],
                       times[name][1], nbytes, flops, lib)
            for name, f, rep, err, nbytes, flops, lib in table]


def busy_ms(ops, lo: float, hi: float) -> float:
    """Time in ms inside [lo, hi] (us) that at least one of the profiler's
    device events ``ops`` covers: overlaps counted once."""
    iv = sorted((max(k.time_range.start, lo), min(k.time_range.end, hi))
                for k in ops
                if k.time_range.end > lo and k.time_range.start < hi)
    total, end = 0.0, lo
    for s, e in iv:
        if e > end:
            total += e - max(s, end)
            end = e
    return total / 1e3


def qpsk_profile(step, state, block, card: str) -> None:
    """``torch.profiler`` over one served block.  Device time of the
    symbol kernel (its three CUDA kernels, by name), and per stage of the
    step (its ``qpsk_stream.*`` ranges as the trace's device-side marks
    show them): the stage's device span and the kernel time inside it.
    Then the device's busy and idle time between the block's first and
    last kernel, and the host's time to enqueue the step (with and
    without the profiler)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    enqueue = []
    for _ in range(5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step(state, *block)
        enqueue.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(state, *block)
        host_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
    on_dev = [e for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA]
    marks = [e for e in on_dev if e.name.startswith("qpsk_stream.")]
    kernels = [e for e in on_dev if not e.name.startswith("qpsk_stream.")
               and not getattr(e, "is_user_annotation", False)]
    if not kernels:
        print(f"profile of one served block on {card}: the trace holds no "
              f"device time (not measured)")
        return

    lo = min(k.time_range.start for k in kernels)
    hi = max(k.time_range.end for k in kernels)
    busy = busy_ms(kernels, lo, hi)
    k5 = sum(k.time_range.elapsed_us() for k in kernels
             if "qpsk_sym_kernel" in k.name or "qpsk_panel_" in k.name) / 1e3
    stages = {m.name: {"device_span_ms": m.time_range.elapsed_us() / 1e3,
                       "kernel_ms": busy_ms(kernels, m.time_range.start,
                                            m.time_range.end)}
              for m in marks}
    for e in prof.events():
        if (e.name in stages
                and e.device_type == torch.autograd.DeviceType.CPU):
            stages[e.name]["host_ms"] = e.cpu_time_total / 1e3
    print(f"profile of one served block on {card}: {len(kernels)} device "
          f"operations, busy {busy:.4f} ms of a {(hi - lo) / 1e3:.4f} ms "
          f"span (idle {(hi - lo) / 1e3 - busy:.4f} ms); symbol kernel "
          f"{k5:.4f} ms; host enqueue {host_ms:.4f} ms under the profiler, "
          f"{float(np.median(enqueue)):.4f} ms without (median of 5); by "
          f"stage: {json.dumps(stages)}")


def tone_capture(n: int, seed: int, dev):
    """complex64 [n] on the card: tones at the bins SP_TONES of an
    SP_NFFT-point FFT (amplitudes 1, 0.5, 0.25; phases from integer
    indices mod SP_NFFT, in float64) plus complex Gaussian noise of sigma
    SP_NOISE per component."""
    import torch

    t = torch.arange(n, dtype=torch.float64, device=dev)
    x = torch.zeros(n, dtype=torch.complex128, device=dev)
    for k, a in zip(SP_TONES, (1.0, 0.5, 0.25)):
        ph = (2 * np.pi / SP_NFFT) * torch.remainder(k * t, SP_NFFT)
        x += a * torch.exp(1j * ph)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    noise = SP_NOISE * torch.randn(2, n, generator=g, dtype=torch.float64,
                                   device=dev)
    return (x + torch.complex(noise[0], noise[1])).to(torch.complex64)


def profile_served(run, card: str, what: str) -> None:
    """``torch.profiler`` over ``run()`` (a served block): the device's
    busy time (kernels and copies, overlaps counted once) against the
    wall time, and the device time by operation."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not ops:
        print(f"profile of {what} on {card}: no device time in the trace "
              f"(not measured)")
        return
    busy = busy_ms(ops, min(e.time_range.start for e in ops),
                   max(e.time_range.end for e in ops))
    by = {}
    for e in ops:
        name = e.name.replace("(anonymous namespace)::", "")
        name = name[5:] if name.startswith("void ") else name
        key = name.split("(")[0].split("<")[0].strip()[:40] or "(unnamed)"
        by[key] = by.get(key, 0.0) + e.time_range.elapsed_us() / 1e3
    print(f"profile of {what} on {card}: {len(ops)} device operations, "
          f"busy {busy:.4f} ms of {wall_us / 1e3:.4f} ms wall "
          f"({1e5 * busy / wall_us:.1f}% busy); device ms by operation: "
          f"{json.dumps({k: round(v, 4) for k, v in by.items()})}")


def spectrum_phases(dev, card: str) -> list:
    """Phases 11-14: FFT and Welch spectrum monitoring (K6, K7's two
    entries, K10's three stages); returns their kernel table rows."""
    import torch

    from comms_tpu_torch.kernels import fft as SK
    from comms_tpu_torch.kernels import fft_big as BK
    from comms_tpu_torch.ops import fft as tfft
    from comms_tpu_torch.ops import spectrum as tspec
    from comms_tpu_torch.runtime import StreamRunner

    t0 = time.perf_counter()
    caps = [tone_capture(SP_N, 30 + b, dev) for b in range(3)]
    torch.cuda.synchronize()
    print(f"tone captures: 3 x {SP_N} samples in "
          f"{time.perf_counter() - t0:.1f} s")
    x0 = caps[0]
    re, im = x0.real.contiguous(), x0.imag.contiguous()
    # The kernels are held to their plain versions on white noise, where
    # every bin carries comparable power: on the tone capture a tone bin
    # outweighs a noise bin by ~1e6, so an error relative to the largest
    # magnitude would not see the noise floor.  The tone capture is for
    # the content check and the main path.
    g = torch.Generator(device=dev)
    g.manual_seed(29)
    nr, ni = torch.randn(2, SP_N, generator=g, device=dev)
    xn = torch.complex(nr, ni)
    errs = {}

    def check(key, err, tol):
        errs[key] = err
        if not err <= tol:
            fail(f"{key}: {err} beyond {tol}")

    def c128(r, i):
        return torch.complex(r.double(), i.double())

    # ---- 11a. K6 at 16,777,216 samples per size, scale 1/sqrt(n), against
    # a float64 oracle on a subset of rows and against the plain version;
    # the plane-swap step twice is an exact bin reversal
    abs_err = {}
    for n in (1024, 4096, 8192, 16384):
        rows = SP_N // n
        r2, i2 = nr.view(rows, n), ni.view(rows, n)
        s = 1.0 / np.sqrt(n)
        yr, yi = SK.fft_planar(r2, i2, n, scale=s)
        pr, pi = SK.fft_plain(r2, i2, s)
        idx = torch.tensor([0, 1, rows // 2, rows - 1], device=dev)
        oracle = torch.fft.fft(c128(r2[idx], i2[idx]), dim=1) * s
        y = torch.complex(yr, yi)
        check(f"fft_{n}_vs_float64", rel_err(y[idx].to(oracle.dtype),
                                             oracle), TOL_FFT)
        check(f"fft_{n}_vs_plain", rel_err(y, torch.complex(pr, pi)),
              TOL_FFT)
        abs_err[n] = max_err(y, torch.complex(pr, pi))
        ur, ui = SK.fft_planar(i2, r2, n, scale=s)
        ur2, ui2 = SK.fft_planar(ur, ui, n, scale=s)
        rev = torch.remainder(-torch.arange(n, device=dev), n)
        check(f"fft_{n}_involution", rel_err(torch.complex(ui2, ur2),
                                             torch.complex(r2, i2)[:, rev]),
              TOL_INVOLUTION)
        if not torch.isfinite(y).all():
            fail(f"FFT n={n}: non-finite output")
    del y, yr, yi, pr, pi, ur, ui, ur2, ui2
    # the 256-point spectrogram of the noise, kernel against tensor route
    S_k = tspec.spectrogram(xn, nperseg=256)
    S_t = tspec.spectrogram(xn, nperseg=256, use_kernel=False)
    if S_k.shape != (2 * SP_N // 256 - 1, 256):
        fail(f"spectrogram shape {tuple(S_k.shape)}")
    check("spectrogram_vs_tensor_route", rel_err(S_k, S_t), TOL_WELCH)
    abs_err["spectrogram"] = max_err(S_k, S_t)
    del S_k, S_t

    # ---- 11b. K7: the stream entry at N = 16,777,216, n = 1024, and the
    # segment-row entry through welch_psd, on the noise and per bin (each
    # bin's error relative to that bin); then the tones stand out
    w = tspec.hann(SP_NFFT)
    acc = SK.psd_stream_planar(nr, ni, w, SP_NFFT)
    want = SK.psd_stream_plain(nr, ni, w, SP_NFFT)
    check("psd_stream_vs_plain", bin_err(acc, want), TOL_PSD)
    check("psd_stream_vs_float64",
          bin_err(acc.double(), SK.psd_stream_plain(nr.double(), ni.double(),
                                                    w, SP_NFFT)), TOL_PSD)
    abs_err["psd_stream"] = max_err(acc, want)
    segs = (nr.unfold(0, SP_NFFT, SP_NFFT // 2),
            ni.unfold(0, SP_NFFT, SP_NFFT // 2))
    acc_rows = SK.psd_planar(*segs, w, SP_NFFT)
    want = SK.psd_plain(*segs, w)
    check("psd_rows_vs_plain", bin_err(acc_rows, want), TOL_PSD)
    abs_err["psd_rows"] = max_err(acc_rows, want)
    _, p_k = tspec.welch_psd(xn, nperseg=SP_NFFT)
    _, p_t = tspec.welch_psd(xn, nperseg=SP_NFFT, use_kernel=False)
    _, p_s = tspec.welch_psd_planar(nr, ni, nperseg=SP_NFFT)
    check("welch_kernel_vs_tensor_route", bin_err(p_k, p_t), TOL_WELCH)
    check("welch_planar_vs_welch", bin_err(p_s, p_k), TOL_WELCH)
    del acc, acc_rows, want, p_t
    _, p_k = tspec.welch_psd(x0, nperseg=SP_NFFT)
    _, p_s = tspec.welch_psd_planar(re, im, nperseg=SP_NFFT)
    med = float(p_s.median())
    peaks = {}
    for k in SP_TONES:
        local = p_s[k - 8:k + 9]
        peaks[k] = (int(local.argmax()) - 8, float(p_s[k]) / med)
        if abs(peaks[k][0]) > 1 or peaks[k][1] <= 100:
            fail(f"tone at bin {k}: peak offset {peaks[k][0]}, "
                 f"{peaks[k][1]:.3g} x the median")
    print("tones (peak offset from the bin, PSD over the median):",
          json.dumps(peaks))

    # ---- 11c. K10: the wideband PSD (welch_numerator at 2^20 x 32 in the
    # three layouts, with means and with sparse demean), stage A, and
    # fft_large at 2^20 x 32 and 2^22 x 8 (n1 = n2 = 2048)
    big = {}
    for F, B in BIG:
        n1, n2 = BK.factorize(F)
        g = torch.Generator(device=dev)
        g.manual_seed(F + B)
        xb = torch.randn(2, B, F, generator=g, device=dev) + 0.05
        rb, ib = xb[0], xb[1]
        wF = torch.from_numpy(tspec.hann(F).astype(np.float32)).to(dev)
        means = torch.stack([rb.mean(1), ib.mean(1)], -1)
        big[F] = (rb, ib, wF, means, n1, n2)
        tag = f"{F}x{B}"
        layouts = {
            "flat": (rb, ib),
            "3d": (rb.view(B, n1, n2), ib.view(B, n1, n2)),
            "blocked": tuple(p.view(B, n1, n2 // 128, 128).permute(
                0, 2, 1, 3).contiguous() for p in (rb, ib))}
        nums = {k: BK.welch_numerator(r, i, wF) for k, (r, i) in
                layouts.items()}
        for k in ("3d", "blocked"):
            check(f"welch_numerator_{tag}_{k}_vs_flat",
                  rel_err(nums[k], nums["flat"]), TOL_LAYOUT)
        want = BK.psd_big_plain(rb, ib, n1, n2, wF, means)
        check(f"psd_big_{tag}_vs_plain", rel_err(nums["flat"], want),
              TOL_PSD)
        oracle = BK.psd_big_plain(rb.double(), ib.double(), n1, n2, wF,
                                  means.double())
        check(f"psd_big_{tag}_vs_float64",
              rel_err(nums["flat"].double(), oracle), TOL_PSD)
        abs_err[f"psd_big_{tag}"] = max_err(nums["flat"], want)
        sp = BK.psd_big_planar(rb, ib, n1, n2, window=tspec.hann(F),
                               sparse_demean=True)
        check(f"psd_big_{tag}_sparse_vs_plain",
              rel_err(sp, BK.psd_big_plain(rb, ib, n1, n2, tspec.hann(F),
                                           sparse_demean=True)), TOL_PSD)
        check(f"psd_big_{tag}_sparse_vs_means", rel_err(sp, nums["flat"]),
              TOL_PSD)
        dr, di, _ = BK.stage_a(rb, ib, n1, n2, wF, means)
        d = torch.complex(dr, di)
        d_plain = BK.stage_a_plain(rb, ib, n1, n2, wF, means)
        check(f"stage_a_{tag}_vs_plain", rel_err(d, d_plain), TOL_FFT)
        abs_err[f"stage_a_{tag}"] = max_err(d, d_plain)
        del nums, layouts, dr, di, d, d_plain
        y = tfft.fft_large(torch.complex(rb, ib))
        idx = torch.tensor([0, B - 1], device=dev)
        oracle = torch.fft.fft(c128(rb[idx], ib[idx]), dim=1)
        check(f"fft_large_{tag}_vs_float64",
              rel_err(y[idx].to(oracle.dtype), oracle), TOL_FFT)
        yp = torch.complex(*BK.fft_big_plain(rb, ib, n1, n2))
        check(f"fft_large_{tag}_vs_plain", rel_err(y, yp), TOL_FFT)
        abs_err[f"fft_big_{tag}"] = max_err(y, yp)
        del y, yp, oracle, xb
    print("spectrum kernels (relative to the largest magnitude; K7 and "
          "the Welch routes per bin):",
          json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))

    # ---- 12. the spectrum main path: every count starts at 0 here
    SK.launches.update(fft=0, psd=0, psd_stream=0)
    BK.launches.update(stage_a=0, psd_stage_b=0, fft_stage_b=0)
    dev_blocks = [(c.real.contiguous(), c.imag.contiguous()) for c in caps]
    host_blocks = [(r.cpu().pin_memory(), i.cpu().pin_memory())
                   for r, i in dev_blocks]

    def step(state, x):
        _, psd = tspec.welch_psd_planar(x[0], x[1], nperseg=SP_NFFT)
        return psd, state

    def serve(blocks, n):
        outs = []
        torch.cuda.synchronize()
        runner = StreamRunner(step, None, (blocks[i % 3] for i in range(n)),
                              sink=outs.append,
                              samples_of=lambda x: x[0].shape[0],
                              depth=SERVE_DEPTH, device=dev)
        return runner.run().msps, outs

    rates, served = {}, {}
    for name, blocks in (("device", dev_blocks),
                         ("pinned_host", host_blocks)):
        serve(blocks, SERVE_WARMUP)
        rates[name], served[name] = serve(blocks, SERVE_BLOCKS)
    print(f"Welch serving Msps ({SERVE_BLOCKS} blocks of {SP_N}, "
          f"{SP_NFFT} bins, depth {SERVE_DEPTH}, after {SERVE_WARMUP} "
          f"warm-up blocks) on {card}:", json.dumps(rates))
    for a, b in zip(served["device"], served["pinned_host"]):
        if not np.array_equal(a, b):
            fail("Welch serving from device and pinned host blocks differ")
    if not np.array_equal(served["device"][0], p_s.cpu().numpy()):
        fail("a served Welch block differs from welch_psd_planar's")
    _, p_main = tspec.welch_psd(x0, nperseg=SP_NFFT)
    S_main = tspec.spectrogram(x0, nperseg=256)
    rb, ib, wF, means, n1, n2 = big[BIG[0][0]]
    F, B = BIG[0]
    _, p_big = tspec.welch_psd(torch.complex(rb, ib).reshape(-1),
                               nperseg=F, noverlap=0)
    y_big = tfft.fft_large(torch.complex(rb, ib))
    rb2, ib2 = big[BIG[1][0]][:2]
    y_big2 = tfft.fft_large(torch.complex(rb2, ib2))
    torch.cuda.synchronize()
    main_counts = {"fft": SK.launches["fft"], "psd": SK.launches["psd"],
                   "psd_stream": SK.launches["psd_stream"],
                   "stage_a": BK.launches["stage_a"],
                   "psd_stage_b": BK.launches["psd_stage_b"],
                   "fft_stage_b": BK.launches["fft_stage_b"]}
    print("spectrum main path launches:", json.dumps(main_counts))
    want_counts = {"fft": 1, "psd": 1,
                   "psd_stream": 2 * (SERVE_WARMUP + SERVE_BLOCKS),
                   "stage_a": 3, "psd_stage_b": 1, "fft_stage_b": 2}
    if main_counts != want_counts:
        fail(f"spectrum main path launches {main_counts}, expected "
             f"{want_counts}")
    if not (torch.equal(p_main, p_k) and torch.isfinite(S_main).all()
            and torch.isfinite(y_big).all() and torch.isfinite(y_big2).all()):
        fail("spectrum main path outputs differ from the checked ones")
    scale = 1.0 / float(np.sum(tspec.hann(F) ** 2)) / B
    check("welch_big_vs_plain",
          rel_err(p_big, BK.psd_big_plain(rb, ib, n1, n2, wF, means) * scale),
          TOL_PSD)
    del y_big, y_big2, S_main
    for name, blocks in (("device-resident", dev_blocks),
                         ("pinned host", host_blocks)):
        profile_served(lambda: serve(blocks, 1), card,
                       f"one served Welch block ({name})")
        profile_served(lambda: serve(blocks, SERVE_BLOCKS), card,
                       f"{SERVE_BLOCKS} served Welch blocks ({name})")

    # ---- 13. times at the main path's shapes
    r1k, i1k = re.view(SP_N // SP_NFFT, SP_NFFT), im.view(-1, SP_NFFT)
    z1k = torch.complex(r1k, i1k)
    s1k = 1.0 / np.sqrt(SP_NFFT)
    zb = torch.complex(rb, ib)
    times = {
        "fft_planar": (lambda: SK.fft_planar(r1k, i1k, SP_NFFT, scale=s1k),
                       lambda: SK.fft_plain(r1k, i1k, s1k),
                       lambda: torch.fft.fft(z1k)),
        "psd_stream_planar": (
            lambda: SK.psd_stream_planar(re, im, w, SP_NFFT),
            lambda: SK.psd_stream_plain(re, im, w, SP_NFFT), None),
        "psd_planar": (lambda: SK.psd_planar(*segs, w, SP_NFFT),
                       lambda: SK.psd_plain(*segs, w), None),
        "fft_big_stage_a": (
            lambda: BK.stage_a(rb, ib, n1, n2, wF, means),
            lambda: BK.stage_a_plain(rb, ib, n1, n2, wF, means), None),
        "psd_big": (
            lambda: BK.psd_big_planar(rb, ib, n1, n2, wF, means),
            lambda: BK.psd_big_plain(rb, ib, n1, n2, wF, means), None),
        "fft_big": (lambda: BK.fft_big_planar(rb, ib, n1, n2),
                    lambda: BK.fft_big_plain(rb, ib, n1, n2),
                    lambda: torch.fft.fft(zb)),
    }
    ms = {}
    for name, (kern, plain, lib) in times.items():
        ms[name] = (cuda_ms(kern), cuda_ms(plain),
                    cuda_ms(lib) if lib is not None else None)
        print(f"{name} on {card}: kernel {ms[name][0]:.4f} ms, plain "
              f"{ms[name][1]:.4f} ms, library "
              f"{'-' if lib is None else f'{ms[name][2]:.4f} ms'}")
    extra = {}
    for n in (4096, 8192, 16384):
        rr, ii = re.view(-1, n), im.view(-1, n)
        extra[f"fft_planar_{n}"] = (
            cuda_ms(lambda: SK.fft_planar(rr, ii, n)),
            cuda_ms(lambda: torch.fft.fft(torch.complex(rr, ii))))
    extra["welch_numerator_2^20x32"] = (
        cuda_ms(lambda: BK.welch_numerator(rb, ib, wF)), None)
    for k, (r, i) in {"3d": (rb.view(B, n1, n2), ib.view(B, n1, n2)),
                      "blocked": tuple(p.view(B, n1, n2 // 128, 128)
                                       .permute(0, 2, 1, 3).contiguous()
                                       for p in (rb, ib))}.items():
        extra[f"psd_big_{k}"] = (
            cuda_ms(lambda: BK.psd_big_planar(r, i, n1, n2, wF, means)),
            None)
    F2 = BIG[1][0]
    n12, n22 = BK.factorize(F2)
    zb2 = torch.complex(rb2, ib2)
    extra["fft_big_2^22x8"] = (
        cuda_ms(lambda: BK.fft_big_planar(rb2, ib2, n12, n22)),
        cuda_ms(lambda: torch.fft.fft(zb2)))
    extra["spectrogram_256"] = (cuda_ms(lambda: tspec.spectrogram(
        x0, nperseg=256)), cuda_ms(lambda: tspec.spectrogram(
            x0, nperseg=256, use_kernel=False)))
    print(f"more spectrum times on {card} (kernel ms, library or tensor "
          f"route ms):", json.dumps(extra))

    # ---- 14. kernel table rows: bytes and operations from the shapes
    # (complex samples 8 bytes; an n-point FFT 5 n log2(n) flops; the
    # window, demean, |.|^2 and sums ~10 flops a sample)
    def lg(v):
        return float(np.log2(v))

    nseg = 2 * SP_N // SP_NFFT - 1
    welch_flops = nseg * SP_NFFT * (5 * lg(SP_NFFT) + 10)
    N = F * B
    rows = [
        ("fft_planar", "fft.cu", "comms_tpu/kernels/fft_pallas.py:373",
         main_counts["fft"], max(abs_err[n] for n in (1024, 4096, 8192,
                                                      16384)),
         16 * SP_N, SP_N * (5 * lg(SP_NFFT) + 1)),
        ("psd_planar", "psd.cu", "comms_tpu/kernels/fft_pallas.py:528",
         main_counts["psd"], abs_err["psd_rows"], 8 * SP_N + 8 * SP_NFFT,
         welch_flops),
        ("psd_stream_planar", "psd.cu",
         "comms_tpu/kernels/fft_pallas.py:672", main_counts["psd_stream"],
         abs_err["psd_stream"], 8 * SP_N + 8 * SP_NFFT, welch_flops),
        ("fft_big_stage_a", "fft_big.cu",
         "comms_tpu/kernels/fft_big_pallas.py:390", main_counts["stage_a"],
         abs_err[f"stage_a_{F}x{B}"], 16 * N + 4 * F,
         N * (5 * lg(n1) + 10)),
        ("psd_big", "fft_big.cu", "comms_tpu/kernels/fft_big_pallas.py:529",
         main_counts["psd_stage_b"], abs_err[f"psd_big_{F}x{B}"],
         8 * N + 8 * F, N * (5 * lg(F) + 10)),
        ("fft_big", "fft_big.cu", "comms_tpu/kernels/fft_big_pallas.py:606",
         main_counts["fft_stage_b"], abs_err[f"fft_big_{F}x{B}"], 16 * N,
         N * 5 * lg(F)),
    ]
    return [kernel_row(name, f, rep, n, err, ms[name][0], ms[name][1],
                       nbytes, flops, ms[name][2])
            for name, f, rep, n, err, nbytes, flops in rows]


def fm_u8_planes(n: int, seed: int, dev):
    """u8 planes [n] on the card of the FM capture of ``synth_capture``
    (the same modulating tones, amplitude 100 around 127.5, Gaussian noise
    of sigma 2), made with torch on the card from float64 phases: numpy
    takes seconds per capture of this size."""
    import torch

    t = torch.arange(n, dtype=torch.float64, device=dev)
    ph = torch.cumsum(fm_tones(t, torch.sin), 0)
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    noise = torch.randn(2, n, generator=g, dtype=torch.float64, device=dev)
    re = torch.clamp(torch.round(100 * torch.cos(ph) + 127.5 + 2 * noise[0]),
                     0, 255).to(torch.uint8)
    im = torch.clamp(torch.round(100 * torch.sin(ph) + 127.5 + 2 * noise[1]),
                     0, 255).to(torch.uint8)
    return re, im


def sharded_phases(dev, card: str) -> list:
    """Phases 15-17: the sharded layer on an 8-shard mesh of the card; the
    kernel table row of K12."""
    import torch

    from comms_tpu_torch.kernels import band_monitor as BM
    from comms_tpu_torch.kernels import channelizer as CK
    from comms_tpu_torch.kernels import decim_fir as DF
    from comms_tpu_torch.kernels import fft_big as BK
    from comms_tpu_torch.kernels import fm_chain as FK
    from comms_tpu_torch.kernels import halo_ring as HR
    from comms_tpu_torch.kernels import qpsk_sym as QS
    from comms_tpu_torch.models import fm_band_monitor as bm
    from comms_tpu_torch.models import fm_receiver as fm
    from comms_tpu_torch.models import qpsk_rx as trx
    from comms_tpu_torch.ops import spectrum as tspec
    from comms_tpu_torch.parallel import dryrun
    from comms_tpu_torch.parallel import fused_wideband as fw
    from comms_tpu_torch.parallel import qpsk_rx_sharded as qs
    from comms_tpu_torch.parallel import sharding as sh
    from comms_tpu_torch.parallel import wideband as wb
    from comms_tpu_torch.parallel import wideband2d as w2
    from comms_tpu_torch.runtime import StreamRunner

    mesh = sh.time_mesh(SH_SHARDS, device=dev)
    mesh1 = sh.time_mesh(1, device=dev)
    per = BLOCK // SH_SHARDS
    g = torch.Generator(device=dev)
    g.manual_seed(41)

    # ---- 15. K12 against its plain version, bit for bit: the wrapped and
    # the ctx forms at the main paths' halos (complex64, float32, u8), the
    # 2-D column rings, several planes in one launch, a 1 MiB-per-shard
    # ring.  The inputs stand in for the paths' tails at their lengths.
    def ring(n, length, trailing=(), dtype=torch.float32, rings=1):
        shape = (length,) + tuple(trailing)
        if dtype == torch.uint8:
            return [[torch.randint(0, 256, shape, generator=g, device=dev,
                                   dtype=dtype) for _ in range(n)]
                    for _ in range(rings)]
        return [[torch.randn(shape, generator=g, device=dev).to(dtype)
                 for _ in range(n)] for _ in range(rings)]

    T = len(fm.FM_LPF_TAPS)
    cases = {
        # name: (rings, halo, ctx per ring or None)
        "iq_halo_c64": (ring(8, per, dtype=torch.complex64), T - 1, True),
        "yprev_c64": (ring(8, per, dtype=torch.complex64), 1, True),
        "fm_prev_c64": (ring(8, per // 5, dtype=torch.complex64), 1, True),
        "audio_halo_f32": (ring(8, per // 5), T - 1, True),
        "fused_raw_tails_u8": (ring(8, per, dtype=torch.uint8, rings=2),
                               fm.FUSED_TAIL_SAMPLES, False),
        "qpsk_ctx_f32": (ring(8, QPSK_N // 8, rings=2),
                         trx.fused_gemm_ctx_len(trx.QpskRxConfig()), True),
        "2d_chan_halo_f32": (ring(8, BM_BLOCK // 8, rings=2),
                             BM_K * 8 - 1, True),
        "2d_demod_rows_f32": (ring(2, BM_BLOCK // 2 // BM_K, (BM_K // 4,),
                                   rings=8), 1, True),
        "2d_audio_rows_f32": (ring(2, BM_BLOCK // 2 // BM_K, (BM_K // 4,),
                                   rings=4), 31, True),
        "ring_1MiB_f32": (ring(8, SH_RING_MIB // 4), SH_RING_MIB // 4,
                          False),
    }
    L0 = HR.launches
    k12_err = 0.0
    widths = {}
    for name, (rings, halo, with_ctx) in cases.items():
        ctxs = ([torch.zeros_like(r[0][:halo]) + 0.5 for r in rings]
                if with_ctx else None)
        if with_ctx and rings[0][0].dtype == torch.uint8:
            ctxs = [c.to(torch.uint8) for c in ctxs]
        got = HR.exchange(rings, halo, ctxs)
        want = HR.exchange_plain(rings, halo, ctxs)
        torch.cuda.synchronize()
        t = rings[0][0][-halo:]
        widths[name] = HR.copy_width([t.data_ptr()],
                                     t.numel() * t.element_size())
        for ga, wa in zip(got, want):
            for a, b in zip(ga, wa):
                if not torch.equal(a, b):
                    fail(f"K12 {name}: kernel and plain differ")
                if a.is_floating_point() or a.is_complex():
                    k12_err = max(k12_err, max_err(a, b))
    if HR.launches - L0 != len(cases):
        fail(f"K12 checks: {HR.launches - L0} launches for {len(cases)} "
             f"calls")
    print(f"K12 kernel == plain bit for bit on {len(cases)} forms; copy "
          f"widths (bytes): {json.dumps(widths)}")

    # ---- 16a. the sharded wideband chain at BLOCK (per shard BLOCK / 8):
    # within 1e-4 of the same chain on one shard, the rdma_halo build bit
    # for bit the default one, two blocks streamed.  Counts start here.
    counts = {}
    re_u8, im_u8 = fm_u8_planes(2 * BLOCK, 43, dev)
    pairs = torch.stack([re_u8, im_u8], -1).float().sub_(127.5).div_(127.5)
    cfg = wb.WidebandConfig(fm.FM_LPF_TAPS, block=BLOCK, dec1=5, dec2=5)
    steps = {"sharded": wb.make_sharded_step(cfg, mesh),
             "rdma_halo": wb.make_sharded_step(cfg, mesh, rdma_halo=True),
             "one_shard": wb.make_sharded_step(cfg, mesh1)}
    outs = {}
    HR.launches = 0
    for name, step in steps.items():
        st = wb.init_state(cfg, dev)
        res = []
        for b in range(2):
            (audio, freq), st = step(st, pairs[b * BLOCK:(b + 1) * BLOCK])
            res.append((audio, freq))
        outs[name] = (res, st)
    torch.cuda.synchronize()
    counts["wideband_chain"] = HR.launches
    if HR.launches != 2 * 2 * 4:
        fail(f"wideband chain: {HR.launches} K12 launches, expected 16 "
             f"(two sharded builds x two blocks x four rings)")
    e_chain, e_freq = 0.0, 0.0
    for (a, f), (a1, f1), (ar, fr) in zip(outs["sharded"][0],
                                          outs["one_shard"][0],
                                          outs["rdma_halo"][0]):
        if a.shape != (BLOCK // 25,) or not torch.isfinite(a).all():
            fail("wideband chain: audio shape or non-finite values")
        if not (torch.equal(a, ar) and torch.equal(f, fr)):
            fail("wideband chain: rdma_halo differs from the default")
        e_chain = max(e_chain, max_err(a, a1))
        e_freq = max(e_freq, abs(float(f) - float(f1)))
    e_state = max(max_err(x, y) for x, y in zip(outs["sharded"][1],
                                                 outs["one_shard"][1]))
    corr = demod_matches_tones(outs["sharded"][0][0][0].cpu().numpy(),
                               fm_tones(np.arange(BLOCK, dtype=np.float64)))
    print(f"wideband chain ({SH_SHARDS} x {per}, 2 blocks): vs one shard "
          f"audio {e_chain:.3g}, freq {e_freq:.3g}, state {e_state:.3g}; "
          f"rdma_halo bit-equal; tone correlation {corr:.5f}")
    if max(e_chain, e_freq, e_state) > TOL_SH_CHAIN or corr < 0.99:
        fail("the sharded wideband chain disagrees with one shard")
    del outs, pairs

    # ---- 16b. the sharded fused FM step at BLOCK: bit for bit a
    # sequential run of make_fused_block_fn over the 8 per-shard blocks;
    # served through StreamRunner beside the unsharded fused step.
    fstep = fw.make_sharded_fused_step(mesh, block=BLOCK)
    seq = fm.make_fused_block_fn(fm.FmReceiverConfig(block=per))
    FK.launches = HR.launches = 0
    a_sh, st_sh = fstep(fm.fused_init_state(dev), re_u8[:BLOCK],
                        im_u8[:BLOCK])
    a2_sh, st_sh = fstep(st_sh, re_u8[BLOCK:], im_u8[BLOCK:])
    torch.cuda.synchronize()
    step_counts = (FK.launches, HR.launches)
    st = fm.fused_init_state(dev)
    ref = []
    for b in range(2 * SH_SHARDS):
        a, st = seq(st, re_u8[b * per:(b + 1) * per],
                    im_u8[b * per:(b + 1) * per])
        ref.append(a)
    ref = torch.cat(ref)
    got = torch.cat([a_sh, a2_sh])
    n_diff = int((got != ref).sum())
    print(f"sharded fused FM (2 x {BLOCK}): {n_diff} of {got.numel()} audio "
          f"samples differ from the sequential per-shard blocks (max "
          f"{max_err(got, ref):.3g}); K1, K12 launches {step_counts}")
    if n_diff or not all(torch.equal(st_sh[k], st[k]) for k in st):
        fail("the sharded fused FM step is not bit-equal to the sequential "
             "blocks")
    if step_counts != (2 * SH_SHARDS, 2):
        fail(f"sharded fused FM: (K1, K12) launches {step_counts}")
    blocks = [(re_u8[:BLOCK], im_u8[:BLOCK]), (re_u8[BLOCK:], im_u8[BLOCK:])]
    unsharded = fm.make_fused_block_fn(fm.FmReceiverConfig(block=BLOCK))

    def serve(fn, n):
        sink = []
        torch.cuda.synchronize()
        runner = StreamRunner(lambda s, x: fn(s, *x), fm.fused_init_state(dev),
                              (blocks[i % 2] for i in range(n)),
                              sink=sink.append,
                              samples_of=lambda x: x[0].shape[0],
                              depth=SERVE_DEPTH, device=dev)
        return runner.run().msps, sink

    FK.launches = HR.launches = 0
    rates = {}
    for name, fn in (("sharded", fstep), ("unsharded", unsharded),
                     ("sharded_again", fstep)):
        serve(fn, SERVE_WARMUP)
        rates[name], served = serve(fn, SERVE_BLOCKS)
        if name == "sharded" and not np.array_equal(
                served[1], a2_sh.cpu().numpy()):
            fail("served sharded block differs from the step's")
    torch.cuda.synchronize()
    n_blk = SERVE_WARMUP + SERVE_BLOCKS
    serve_counts = (FK.launches, HR.launches)
    print(f"fused FM serving Msps ({SERVE_BLOCKS} blocks of {BLOCK}, depth "
          f"{SERVE_DEPTH}, after {SERVE_WARMUP} warm-up blocks) on {card}: "
          f"{json.dumps(rates)}; (K1, K12) launches {serve_counts}")
    if serve_counts != (2 * n_blk * SH_SHARDS + n_blk, 2 * n_blk):
        fail(f"fused FM serving: (K1, K12) launches {serve_counts}")
    counts["fused_fm"] = step_counts[1] + serve_counts[1]
    # where a sharded block's time goes: the host's enqueue of one step
    # and the device's busy share of one served block, beside unsharded
    enqueue = {}
    for name, fn in (("sharded", fstep), ("unsharded", unsharded)):
        ts = []
        for _ in range(5):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            fn(fm.fused_init_state(dev), *blocks[0])
            ts.append((time.perf_counter() - t0) * 1e3)
        enqueue[name] = statistics.median(ts)
        profile_served(lambda: serve(fn, 1), card,
                       f"one served {name} fused FM block")
    print(f"host enqueue of one fused FM step (ms, median of 5) on {card}:",
          json.dumps(enqueue))
    del blocks, ref, got, re_u8, im_u8

    # ---- 16c. the band monitor at BM_BLOCK, K=16: the fused step per
    # shard (K9) against the one-device fused step, the 2-D (2 x 4) mesh
    # (K8 + K2 per shard) against the one-device staged step, two blocks
    re16, im16, _ = station_capture(2 * BM_BLOCK, BM_K, 44, dev)
    bcfg = bm.BandMonitorConfig(num_channels=BM_K, block=BM_BLOCK)
    bblocks = [(re16[b * BM_BLOCK:(b + 1) * BM_BLOCK],
                im16[b * BM_BLOCK:(b + 1) * BM_BLOCK]) for b in range(2)]
    one_f = bm.make_fused_block_fn(bcfg)
    one_s = bm.make_planar_block_fn(bcfg)
    st_f, st_s = bm.init_state_fused(bcfg, dev), bm.init_state(bcfg, dev)
    want_f, want_s = [], []
    for r, i in bblocks:
        a, st_f = one_f(st_f, r, i)
        want_f.append(a)
        a, st_s = one_s(st_s, r, i)
        want_s.append(a)
    torch.cuda.synchronize()
    bstep = fw.make_sharded_band_monitor_step(bcfg, mesh, block=BM_BLOCK)
    step2d = w2.make_sharded_band_monitor_2d(bcfg,
                                             w2.mesh_2d(2, 4, device=dev))
    pairs16 = torch.stack([re16, im16], -1)
    BM.launches = CK.launches = DF.launches = HR.launches = 0
    st_b = bm.init_state_fused(bcfg, dev)
    got_f = []
    for r, i in bblocks:
        a, st_b = bstep(st_b, r, i)
        got_f.append(a)
    torch.cuda.synchronize()
    fused_counts = (BM.launches, HR.launches)
    st2 = bm.init_state(bcfg, dev)
    got_2d = []
    BM.launches = CK.launches = DF.launches = HR.launches = 0
    for b in range(2):
        (a, power), st2 = step2d(st2, pairs16[b * BM_BLOCK:
                                             (b + 1) * BM_BLOCK])
        got_2d.append(a)
    torch.cuda.synchronize()
    counts_2d = (CK.launches, DF.launches, BM.launches, HR.launches)
    e_f = max(rel_err(g_, w_) for g_, w_ in zip(got_f, want_f))
    e_2d = max(max_err(g_, w_) for g_, w_ in zip(got_2d, want_s))
    e_2d_state = max(max_err(x, y) for x, y in zip(st2, st_s))
    print(f"band monitor K={BM_K}, 2 x {BM_BLOCK}: fused per shard vs one "
          f"device {e_f:.3g} relative, (K9, K12) launches {fused_counts}; "
          f"2-D 2x4 vs one-device staged {e_2d:.3g} (state "
          f"{e_2d_state:.3g}), (K8, K2, K9, K12) launches {counts_2d}")
    if not e_f <= TOL_BM or not max(e_2d, e_2d_state) <= TOL_SH_2D:
        fail("a sharded band monitor disagrees with the one-device path")
    if fused_counts != (2 * SH_SHARDS, 2):
        fail(f"sharded fused band monitor: (K9, K12) {fused_counts}")
    if counts_2d != (2 * SH_SHARDS, 2 * SH_SHARDS, 0, 2 * 3):
        fail(f"2-D band monitor: (K8, K2, K9, K12) launches {counts_2d}")
    if not torch.isfinite(power).all() or power.shape != (BM_K,):
        fail("2-D band monitor: power map")
    counts["band_monitor_fused"] = fused_counts[1]
    counts["band_monitor_2d"] = counts_2d[3]
    del re16, im16, pairs16, bblocks, want_f, want_s, got_f, got_2d

    # ---- 16d. the sharded QPSK receiver on the 2^25-sample capture: zero
    # bit errors, K5's panel and symbol entries per shard
    re, im, bits = qpsk_capture(dev, seed=7)
    qcfg = trx.QpskRxConfig()
    rx = qs.make_sharded_rx_step(qcfg, mesh)
    for k in QS.launches:
        QS.launches[k] = 0
    HR.launches = 0
    sym, diag = rx(re, im)
    torch.cuda.synchronize()
    q_counts = (QS.launches["qpsk_panels"],
                QS.launches["qpsk_symbol_gemm_scalars"], HR.launches)
    M = QPSK_N // 4
    rot, lag0, head_errs = qpsk_align(sym, 0, bits)
    lo, hi = lag0 + QPSK_MARGIN, M - QPSK_MARGIN
    ber = qpsk_bit_errors(sym[:, lo:hi], lo, bits, rot, lag0)
    d = {k: float(v) for k, v in diag.items()}
    print(f"sharded QPSK receiver ({SH_SHARDS} x {QPSK_N // SH_SHARDS}): "
          f"{json.dumps(d)}; lag {lag0} rot {rot}; {ber} bit errors over "
          f"{2 * (hi - lo)} bits; (K5 panels, K5 symbols, K12) launches "
          f"{q_counts}")
    if ber or head_errs or sym.shape != (2, M):
        fail(f"sharded QPSK receiver: {ber} bit errors")
    if abs(d["freq"] - QPSK_CFO) >= 0.01:
        fail(f"sharded QPSK frequency estimate {d['freq']}")
    if q_counts != (SH_SHARDS, SH_SHARDS, 1):
        fail(f"sharded QPSK: (K5 panels, K5 symbols, K12) {q_counts}")
    counts["qpsk_rx"] = q_counts[2]
    del re, im, sym

    # ---- 16e. the sharded PSDs at 2^20 x 32: frequency-sharded through
    # the dfft, segment-sharded through K10 per shard; per bin against
    # welch_psd
    F, B = BIG[0]
    xb = torch.randn(2, B, F, generator=g, device=dev) + 0.05
    x = torch.complex(xb[0], xb[1])
    _, want = tspec.welch_psd(x.reshape(-1), nperseg=F, noverlap=0)
    pairs_b = xb.permute(1, 2, 0).contiguous()            # [B, F, 2]
    BK.launches.update(stage_a=0, psd_stage_b=0, fft_stage_b=0)
    HR.launches = 0
    p_freq = wb.make_sharded_psd(F, mesh)(pairs_b)
    dfft_counts = dict(BK.launches)
    p_seg = wb.make_sharded_psd_segments(F, mesh)(pairs_b)
    torch.cuda.synchronize()
    seg_counts = {k: v - dfft_counts[k] for k, v in BK.launches.items()}
    e_psd = {"frequency_sharded_dfft": bin_err(p_freq, want),
             "segment_sharded_k10": bin_err(p_seg, want)}
    print(f"sharded PSDs at {F} x {B} vs welch_psd per bin: "
          f"{json.dumps(e_psd)}; K10 launches (dfft route, segment route) "
          f"{dfft_counts}, {seg_counts}; K12 {HR.launches}")
    if max(e_psd.values()) > TOL_PSD:
        fail(f"sharded PSDs beyond {TOL_PSD} per bin: {e_psd}")
    if (dfft_counts != {"stage_a": 0, "psd_stage_b": 0, "fft_stage_b": 0}
            or seg_counts != {"stage_a": SH_SHARDS,
                              "psd_stage_b": SH_SHARDS, "fft_stage_b": 0}
            or HR.launches):
        fail("sharded PSDs: launch counts")
    del xb, x, pairs_b

    # ---- 17. the dry run of every sharded configuration, then K12's times
    HR.launches = 0
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(SH_SHARDS, device=dev)
    torch.cuda.synchronize()
    counts["dryrun"] = HR.launches
    print(f"dryrun_multichip({SH_SHARDS}) on {card}: OK in "
          f"{time.perf_counter() - t0:.1f} s, {HR.launches} K12 launches")
    # configs 1 (4 rings x 3 steps), 2 (2), 4 (1), 5 (2), 6 (2), 7 (1) and
    # 9 (3 rings x 2 steps on the 2 x 4 mesh)
    if HR.launches != 12 + 2 + 1 + 2 + 2 + 1 + 6:
        fail(f"dry run: {HR.launches} K12 launches, expected 26")
    print("K12 launches per sharded main path:", json.dumps(counts))

    times = {}
    lib = hasattr(torch, "_foreach_copy_")
    for name in ("fused_raw_tails_u8", "iq_halo_c64", "audio_halo_f32",
                 "2d_demod_rows_f32", "ring_1MiB_f32"):
        rings, halo, with_ctx = cases[name]
        srcs = [r[(i - 1) % len(r)][-halo:] for r in rings
                for i in range(len(r))]
        dsts = [torch.empty_like(s) for s in srcs]
        pairs_n = len(srcs)
        nbytes = srcs[0].numel() * srcs[0].element_size()
        times[name] = {
            "pairs": pairs_n, "bytes_each": nbytes,
            "ms": cuda_ms(lambda: HR.exchange(rings, halo)),
            "plain_ms": cuda_ms(lambda: HR.exchange_plain(rings, halo)),
            "library_ms": (cuda_ms(lambda: torch._foreach_copy_(dsts, srcs))
                           if lib else None),
            "bound_ms": bound(2 * pairs_n * nbytes, 0)[0]}
    print(f"K12 times on {card} (wrapped form):", json.dumps(times))
    row = times["fused_raw_tails_u8"]
    return [kernel_row("ring_halo_exchange", "halo_ring.cu",
                       "comms_tpu/kernels/halo_rdma.py:84",
                       sum(counts.values()), k12_err, row["ms"],
                       row["plain_ms"], 2 * row["pairs"] * row["bytes_each"],
                       0, row["library_ms"])]


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    import comms_tpu_torch
    if Path(comms_tpu_torch.__file__).resolve().parents[1] != REPO:
        fail(f"comms_tpu_torch imported from {comms_tpu_torch.__file__}, "
             f"not from this checkout")
    from comms_tpu_torch.kernels import _build

    # ---- 1. the card
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0]
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    if torch.backends.cuda.matmul.allow_tf32:
        fail("TF32 matmul is on; the plain version must run in float32")
    # The library yardsticks (F.conv1d) run on cuDNN, whose float32
    # convolutions default to TF32: hold them to float32 as well.
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    # ---- 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({_build.BUILD_DIR})")
    print_ptxas_report(_build)
    print_ptxas_kernels(_build, ("fir_kernel", "qpsk_sym_kernel",
                                 "qpsk_panel_partial_kernel",
                                 "qpsk_panel_reduce_kernel",
                                 "panel_reduce_kernel", "fft_rows_kernel",
                                 "psd_partial_kernel", "psd_reduce_kernel",
                                 "stage_a_kernel", "stage_b_psd_kernel",
                                 "stage_b_fft_kernel", "halo_ring_kernel"))

    rows = [fm_receiver_phases(dev, card)]
    rows += band_monitor_phases(dev, card)
    rows += qpsk_phases(dev, card)
    rows += spectrum_phases(dev, card)
    rows += sharded_phases(dev, card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
