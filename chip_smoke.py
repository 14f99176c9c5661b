#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one CUDA card: the FM broadcast
receiver, the wideband FM band monitor and the QPSK receiver.

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
   events), each beside the card's name and power limit;
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
   of one served block.

The inputs are synthetic captures made from fixed seeds (numpy for the
FM receiver, torch on the card for the band monitor, numpy bits and
torch on the card for the QPSK capture).  The line before the last is
the kernel table as JSON; the last line is ``{"ok": true, "device":
{...}}``.
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


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def synth_capture(n: int, seed: int):
    """u8 IQ [n, 2] of a carrier frequency-modulated by two tones, at
    amplitude 100 around 127.5 plus Gaussian noise (sigma 2), and its
    instantaneous frequency w [n] in rad/sample.  |w| <= 0.25, so the
    phase step per mid-rate sample (5w) stays far from +-pi."""
    rng = np.random.default_rng(seed)
    t = np.arange(n, dtype=np.float64)
    w = (0.05 + 0.12 * np.sin(2 * np.pi * 1.3e-4 * t)
         + 0.08 * np.sin(2 * np.pi * 3.1e-5 * t + 1.0))
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


def cuda_ms(fn, reps: int = 7, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
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

    return {
        "name": "fm_chain_fused",
        "route": "cuda",
        "source": "comms_tpu_torch/csrc/fm_chain.cu",
        "replaces": "comms_tpu/kernels/fm_chain_pallas.py:385",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }


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
            tmpl = "<true>" if "ILb1E" in current else (
                "<false>" if "ILb0E" in current else "")
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

    def worst(prefix):
        return max(v[0] for k, v in errs.items() if k.startswith(prefix))

    src = "comms_tpu_torch/csrc/"
    table = [
        ("channelize", "channelizer.cu",
         "comms_tpu/kernels/channelizer_pallas.py:305",
         main_counts["channelize"], worst("channelize_")),
        ("fir_decimate", "decim_fir.cu",
         "comms_tpu/kernels/decim_fir_pallas.py:262",
         main_counts["fir_decimate"], worst("fir_decimate_")),
        # The poly-FIR entry launches the same kernel as fir_decimate;
        # its count is that kernel's.
        ("poly_fir", "decim_fir.cu",
         "comms_tpu/kernels/poly_fir_pallas.py:173",
         main_counts["fir_decimate"], worst("poly_fir_")),
        ("band_monitor", "band_monitor.cu",
         "comms_tpu/kernels/band_monitor_pallas.py:349",
         main_counts["band_monitor"], worst("band_monitor_")),
    ]
    return [{"name": name, "route": "cuda", "source": src + f,
             "replaces": rep, "launches": n, "max_abs_err": err,
             "ms": times[name][0], "plain_ms": times[name][1]}
            for name, f, rep, n, err in table]


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

    def worst(prefix):
        return max(v[0] for k, v in errs.items() if k.startswith(prefix))

    src = "comms_tpu_torch/csrc/"
    launches = {k: one_shot_counts[k] + serve_counts.get(k, 0)
                for k in ("fir_planar", "qpsk_symbol_gemm",
                          "qpsk_symbol_gemm_scalars", "qpsk_panels",
                          "panel_reductions")}
    table = [
        ("fir_planar", "fir.cu", "comms_tpu/kernels/fir_pallas.py:253",
         worst("fir_")),
        ("qpsk_symbol_gemm", "qpsk_sym.cu",
         "comms_tpu/kernels/qpsk_sym_pallas.py:643",
         worst("qpsk_symbol_gemm_")),
        ("qpsk_symbol_gemm_scalars", "qpsk_sym.cu",
         "comms_tpu/kernels/qpsk_sym_pallas.py:501",
         worst("qpsk_symbol_gemm_scalars")),
        ("qpsk_panels", "qpsk_sym.cu",
         "comms_tpu/kernels/qpsk_sym_pallas.py:553", worst("qpsk_panels")),
        ("panel_reductions", "panel_reduce.cu",
         "comms_tpu/kernels/panel_reduce_pallas.py:125",
         worst("panel_reductions")),
    ]
    return [{"name": name, "route": "cuda", "source": src + f,
             "replaces": rep, "launches": launches[name],
             "max_abs_err": err, "ms": times[name][0],
             "plain_ms": times[name][1]}
            for name, f, rep, err in table]


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

    def busy_ms(lo, hi):
        """Kernel time inside [lo, hi] (us), overlaps counted once."""
        iv = sorted((max(k.time_range.start, lo), min(k.time_range.end, hi))
                    for k in kernels
                    if k.time_range.end > lo and k.time_range.start < hi)
        total, end = 0.0, lo
        for s, e in iv:
            if e > end:
                total += e - max(s, end)
                end = e
        return total / 1e3

    lo = min(k.time_range.start for k in kernels)
    hi = max(k.time_range.end for k in kernels)
    busy = busy_ms(lo, hi)
    k5 = sum(k.time_range.elapsed_us() for k in kernels
             if "qpsk_sym_kernel" in k.name or "qpsk_panel_" in k.name) / 1e3
    stages = {m.name: {"device_span_ms": m.time_range.elapsed_us() / 1e3,
                       "kernel_ms": busy_ms(m.time_range.start,
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
                                 "panel_reduce_kernel"))

    rows = [fm_receiver_phases(dev, card)]
    rows += band_monitor_phases(dev, card)
    rows += qpsk_phases(dev, card)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
