#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's FM broadcast receiver on one CUDA card.

    python3 chip_smoke.py        # from the repository root

Phases (each raises on failure, so any failure exits non-zero):

1. card name and power limit (nvidia-smi), torch and CUDA versions;
2. build the fused FM kernel from ``comms_tpu_torch/csrc`` (nvcc);
3. kernel against its plain PyTorch version on the card, at the
   26,214,400-sample block (from the stream-start context and from a
   mid-stream one) and on white noise;
4. the main path, ``run_file`` over a capture of three full blocks and a
   ragged tail, fused and unfused, plus a small capture against the
   CPU run of the same code;
5. serving: ``StreamRunner`` over the fused block step, 8 blocks
   after 3 warm-up blocks, state chained, depth 4, from device-resident
   and from pinned host blocks;
6. the dense 262,144-sample block of the reference's entry config, on
   the card against the CPU;
7. kernel and plain-version times at the full block (CUDA events).

The input is a synthetic FM broadcast capture made with numpy from a
fixed seed.  The line before the last is the kernel table as JSON; the
last line is ``{"ok": true, "device": {...}}``.
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


def main() -> None:
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False: this needs a CUDA card")
    import comms_tpu_torch
    if Path(comms_tpu_torch.__file__).resolve().parents[1] != REPO:
        fail(f"comms_tpu_torch imported from {comms_tpu_torch.__file__}, "
             f"not from this checkout")
    from comms_tpu_torch.kernels import _build
    from comms_tpu_torch.kernels import fm_chain as K
    from comms_tpu_torch.models import fm_receiver as fm
    from comms_tpu_torch.runtime import StreamRunner

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
    taps = fm.FM_LPF_TAPS

    # ---- 2. build
    t0 = time.perf_counter()
    _build.load()
    build_s = time.perf_counter() - t0
    print(f"build: {build_s:.2f} s ({_build.BUILD_DIR})")

    n_total = 3 * BLOCK + RAGGED
    t0 = time.perf_counter()
    iq, w = synth_capture(n_total, seed=0)
    print(f"capture: {n_total} samples in {time.perf_counter() - t0:.1f} s")

    def planes(a, b):
        x = torch.from_numpy(iq[a:b]).to(dev)
        return x[:, 0].contiguous(), x[:, 1].contiguous()

    # ---- 3. kernel vs plain
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

    # ---- 4-6. the main path: counts start at 0 here
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

    print(json.dumps({"kernels": [{
        "name": "fm_chain_fused",
        "route": "cuda",
        "source": "comms_tpu_torch/csrc/fm_chain.cu",
        "replaces": "comms_tpu/kernels/fm_chain_pallas.py:385",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
