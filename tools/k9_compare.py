#!/usr/bin/env python3
"""K9 (the fused band monitor, ``kernels/band_monitor.band_monitor_planar``)
against an earlier K9, in one process on one CUDA card.

    mkdir -p build/k9_before
    git show <rev>:comms_tpu_torch/csrc/band_monitor.cu \\
        > build/k9_before/band_monitor.cu
    git show 80165ab:comms_tpu_torch/csrc/channelize_tile.cuh \\
        > build/k9_before/channelize_tile.cuh    # K9 up to 141c1f8
    PYTHONPATH=.:tools python3 tools/k9_compare.py build/k9_before [--quick]

The earlier K9 (up to 141c1f8) takes C and the roots on the card and no
run length, and includes ``channelize_tile.cuh``, which the package no
longer has (K8's kernel dropped it): take it from 80165ab as above.
``atan2_poly.cuh`` is copied from the package where the directory lacks
it (the package leaves it unchanged).  Each build is loaded with ctypes.
Beside it the script builds the ``VARIANTS`` (the package's
``csrc/band_monitor.cu`` with one design choice undone: the roots read
from a shared table instead of taken as constant operands) and
``PROBES`` (one stage cut, so that its time can be read off; their output
is wrong by design and not checked), and runs the package with one tile a block (``recompute``: every tile
starts from the Ta frames before it instead of carrying them).

It prints ptxas's lines and the SASS opcode counts (``cuobjdump``) of both
kernels at K = 16 and K = 64, then, at K = 16 and 64, on the station
capture of ``chip_smoke.station_capture`` and on white noise, from zero
and from mid-stream state (the state after a block of 16,384 samples),
at 16,384, 1,048,576 and 16,777,216 samples:

- checks audio, new spectrum tail and new context equal to the earlier
  K9's, the variants' and the ``recompute`` partition's (``torch.equal``),
  and at the two larger sizes two chained calls of N/2 equal to one of N;
  reports the error against the plain version (the station capture held
  to ``chip_smoke.TOL_BM``);
- times (``chip_smoke.cuda_ms``, device time behind a spin kernel, median
  of 7) earlier / package / package / earlier at 16,777,216 samples, K = 16
  and K = 64, beside the bound of ``chip_smoke.bound``, then the variants,
  ``recompute`` and the probes at K = 16, and samples nvidia-smi's SM
  clock and power under back-to-back calls of both kernels.

``--quick`` stops after the checks at the two smaller sizes and the
times.  The last line is the result as JSON; the exit code is 1 if a
check failed.
"""

from __future__ import annotations

import contextlib
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

import chip_smoke as cs
from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import band_monitor as BM
from comms_tpu_torch.kernels import channelizer as CK
from comms_tpu_torch.models import fm_band_monitor as bm
from k1_compare import sass_text, sm_clock_under_load
from k7_compare import sass_histogram

SIZES = (16_384, 1_048_576, 16_777_216)
PRE = BM.step_samples()          # the block before a mid-stream case
HEADERS = ("atan2_poly.cuh",)
VARIANTS = {
    "table": [
        ("template <int K>\n__device__ __forceinline__ void frame_spectrum(",
         "__shared__ float2 s_roots[128];\n\n"
         "template <int K>\n__device__ __forceinline__ void frame_spectrum("),
        ("      const float2 w = cst.root[((c + 1) * ch) % K];",
         "      const float2 w = s_roots[((c + 1) * ch) % K];"),
        ("  for (int i = tid; i < s.Ta; i += kThreads) blk.s_h[i] = h[i];\n",
         "  for (int i = tid; i < s.Ta; i += kThreads) blk.s_h[i] = h[i];\n"
         "  for (int i = tid; i < K; i += kThreads) s_roots[i] = cst.root[i];\n"),
    ],
}
PROBES = {
    "p_no_dft": [
        ("#pragma unroll\n  for (int ch = 0; ch < K; ++ch) yr[ch] = yi[ch] = 0.f;",
         "  if (M > 0) {\n#pragma unroll\n    for (int ch = 0; ch < K; ++ch) {\n"
         "      yr[ch] = vr[ch];\n      yi[ch] = vi[ch];\n    }\n"
         "    return;\n  }\n"
         "#pragma unroll\n  for (int ch = 0; ch < K; ++ch) yr[ch] = yi[ch] = 0.f;")],
    "p_no_fir": [("    blk.fir(tile, audio);",
                  "    if (s.M < 0) blk.fir(tile, audio);")],
}


class _Swapped:
    """The package's library with another build's ``band_monitor_launch``."""

    def __init__(self, lib, other):
        self._lib, self.band_monitor_launch = lib, other.band_monitor_launch

    def __getattr__(self, name):
        return getattr(self._lib, name)


@contextlib.contextmanager
def kernel_of(lib=None, run_blocks=None):
    """The wrapper launching ``lib``'s K9 (same C entry as the package's),
    with ``run_blocks`` in place of ``BM._RUN_BLOCKS``."""
    pkg = _build.load()
    keep = BM._RUN_BLOCKS
    _build._lib = _Swapped(pkg, lib) if lib is not None else pkg
    if run_blocks is not None:
        BM._RUN_BLOCKS = run_blocks
    try:
        yield
    finally:
        _build._lib = pkg
        BM._RUN_BLOCKS = keep


def bind_package(lib):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.band_monitor_launch.restype = i32
    lib.band_monitor_launch.argtypes = [p, p, p, p, i32, p, p, i32, p, p, p,
                                        i32, i32, p, i32, i32, i64, i32,
                                        p, p, p, p, p, p]
    return lib


def bind_before(lib):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.band_monitor_launch.restype = i32
    lib.band_monitor_launch.argtypes = [p, p, p, p, i32, p, p, i32, p, p,
                                        i32, i32, p, i32, i32, i64,
                                        p, p, p, p, p, p]
    return lib


def before_call(lib, cfg, re_, im_, state):
    """The earlier K9 through its own C entry, with the arguments its
    wrapper passed (C and the roots as device tables)."""
    k, dev = cfg.num_channels, re_.device
    ctx_r, ctx_i, yh_r, yh_i = state
    at = cfg.audio_taps.astype(np.float32)
    hrows = BM.halo_rows(k, at.shape[0])
    frames = re_.shape[0] // k
    f32 = dict(dtype=torch.float32, device=dev)
    audio = torch.empty((k, frames // cfg.audio_dec), **f32)
    out = [torch.empty((hrows, 128), **f32) for _ in range(2)]
    ctx = [torch.empty((BM.CTX_SAMPLES,), **f32) for _ in range(2)]
    C = _build.device_constant(CK.branch_matrix(cfg.prototype, k), dev)
    roots = _build.device_constant(CK.root_table(k), dev)
    taps = _build.device_constant(at, dev)
    rc = lib.band_monitor_launch(
        re_.data_ptr(), im_.data_ptr(), ctx_r.data_ptr(), ctx_i.data_ptr(),
        BM.CTX_SAMPLES, yh_r.data_ptr(), yh_i.data_ptr(),
        hrows * (128 // k), C.data_ptr(), roots.data_ptr(), k,
        cfg.taps_per_branch, taps.data_ptr(), at.shape[0], cfg.audio_dec,
        frames, audio.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        ctx[0].data_ptr(), ctx[1].data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier K9: CUDA error {rc}")
    return audio.T, ctx[0], ctx[1], out[0], out[1]


def ptxas_report(log: str) -> list:
    """``band_monitor_kernel<K>: registers, spills`` lines of a ptxas log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w*band_monitor_kernel"
                      r"ILi(\d+)E\w*)'", line)
        if m:
            name = f"band_monitor_kernel<{m.group(2)}>"
        elif name and ("Used" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                name = None
    return out


def main(before_dir: Path, quick: bool) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    print("torch", torch.__version__, "CUDA", torch.version.cuda)
    csrc = _build.CSRC_DIR
    for hname in HEADERS:
        if not (before_dir / hname).exists():
            (before_dir / hname).write_text((csrc / hname).read_text())
    sources = {"before": before_dir / "band_monitor.cu"}
    for name, edits in {**VARIANTS, **PROBES}.items():
        text = (csrc / "band_monitor.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not once in the source")
            text = text.replace(old, new)
        d = before_dir / name
        d.mkdir(exist_ok=True)
        (d / "band_monitor.cu").write_text(text)
        (d / "atan2_poly.cuh").write_text((csrc / "atan2_poly.cuh").read_text())
        sources[name] = d / "band_monitor.cu"
    t0 = time.time()
    procs = {k: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(src.with_suffix(".so")), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, src in sources.items()}
    _build.load()
    logs = {}
    for k, proc in procs.items():
        logs[k] = proc.communicate()[1]
        if proc.returncode:
            print(logs[k])
            return 1
    print(f"builds {time.time() - t0:.1f} s")
    pkg_log = Path(f"{_build.library_path()}.log")
    logs["package"] = pkg_log.read_text() if pkg_log.exists() else ""
    for k in ("package", "before", *VARIANTS, *PROBES):
        for line in ptxas_report(logs[k]):
            print(f"ptxas, {k}, {line}")
    sass = {}
    for K in (16, 64):
        sass[f"package_K{K}"] = sass_histogram(
            _build.library_path(), f"band_monitor_kernelILi{K}E")
        sass[f"before_K{K}"] = sass_histogram(
            sources["before"].with_suffix(".so"), f"band_monitor_kernelILi{K}E")
    for k, hist in sass.items():
        print(f"SASS of band_monitor_kernel, {k}:", json.dumps(hist))
    (before_dir / "k9_sass.txt").write_text(
        sass_text(_build.library_path(), "band_monitor_kernelILi16E"))
    libs = {k: ctypes.CDLL(str(src.with_suffix(".so")))
            for k, src in sources.items()}
    before = bind_before(libs.pop("before"))
    libs = {k: bind_package(v) for k, v in libs.items()}

    def package(cfg, x, st, lib=None, run_blocks=None):
        with kernel_of(lib, run_blocks):
            return BM.band_monitor_planar(
                x[0], x[1], cfg.prototype, cfg.audio_taps, cfg.audio_dec,
                *st, num_channels=cfg.num_channels)

    sizes = SIZES[:2] if quick else SIZES
    n_max = max(sizes)
    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    fails, equal, errs, flips = [], {}, {}, {}
    times = {}
    for K in (16, 64):
        cfg = bm.BandMonitorConfig(num_channels=K, block=PRE)
        st0 = bm.init_state_fused(cfg, "cuda")
        re_, im_, _ = cs.station_capture(PRE + n_max, K, 11 + K, "cuda")
        caps = {"station": torch.stack([re_, im_]),
                "noise": torch.randn(2, PRE + n_max, generator=g,
                                     device="cuda")}
        del re_, im_
        for src_name, cap in caps.items():
            st_mid = package(cfg, (cap[0, :PRE], cap[1, :PRE]), st0)[1:]
            if not all(torch.equal(a, b) for a, b in zip(
                    st_mid, before_call(before, cfg, cap[0, :PRE],
                                        cap[1, :PRE], st0)[1:])):
                fails.append(f"K{K} {src_name}: state after {PRE} differs")
            for n in sizes:
                x = (cap[0, PRE:PRE + n], cap[1, PRE:PRE + n])
                for start, st in (("zero", st0), ("mid_stream", st_mid)):
                    key = f"K{K}_{n}_{src_name}_{start}"
                    got = package(cfg, x, st)
                    runs = {"before": before_call(before, cfg, *x, st),
                            "again": package(cfg, x, st),
                            "recompute": package(cfg, x, st,
                                                 run_blocks=1 << 30)}
                    for k in VARIANTS:
                        runs[k] = package(cfg, x, st, libs[k])
                    if n >= 1 << 20:
                        h = n // 2
                        a = package(cfg, (x[0][:h], x[1][:h]), st)
                        b = package(cfg, (x[0][h:], x[1][h:]), a[1:])
                        runs["chained"] = (torch.cat([a[0], b[0]]), *b[1:])
                    for k, out in runs.items():
                        same = all(torch.equal(u, v)
                                   for u, v in zip(got, out))
                        equal[f"{key}_{k}"] = same
                        if not same:
                            fails.append(f"{key}: {k} not bit-equal")
                    plain = BM.band_monitor_plain(
                        *x, cfg.prototype, cfg.audio_taps, cfg.audio_dec,
                        *st, num_channels=K)
                    errs[key] = cs.rel_err(got[0], plain[0])
                    if src_name == "noise":
                        flips[key] = int(((got[0] - plain[0]).abs()
                                          > cs.TOL_BM * plain[0].abs().max())
                                         .sum())
                    elif not errs[key] <= cs.TOL_BM:
                        fails.append(f"{key}: {errs[key]} against plain")
                    if not torch.isfinite(got[0]).all():
                        fails.append(f"{key}: non-finite audio")
        torch.cuda.synchronize()
        # Times at the main path's block, the station capture, mid-stream.
        n = n_max
        x = (caps["station"][0, PRE:PRE + n], caps["station"][1, PRE:PRE + n])
        st = package(cfg, (caps["station"][0, :PRE],
                           caps["station"][1, :PRE]), st0)[1:]
        t = {}
        for who in ("before", "package", "package", "before"):
            fn = ((lambda: package(cfg, x, st)) if who == "package" else
                  (lambda: before_call(before, cfg, *x, st)))
            t.setdefault(who, []).append(cs.cuda_ms(fn))
        if K == 16:
            for k in (*VARIANTS, *PROBES):
                t[k] = cs.cuda_ms(lambda: package(cfg, x, st, libs[k]))
            t["recompute"] = cs.cuda_ms(
                lambda: package(cfg, x, st, run_blocks=1 << 30))
        t["speedup"] = sum(t["before"]) / sum(t["package"])
        T = cfg.audio_taps.shape[0]
        dec = cfg.audio_dec
        t["bound"] = cs.bound(
            8 * n + 4 * n // dec,
            n * (4 * cfg.taps_per_branch + 5 * np.log2(K) + 46)
            + 2 * T * n // dec)[0]
        t["tiles_run_blocks"] = BM.partition(n // K, K)
        times[f"K{K}_{n}"] = t
        print(f"K={K} N={n} on {card}, ms:", json.dumps(t))
        del caps
    print("package vs plain, relative:", json.dumps(errs))
    print(f"noise outputs beyond {cs.TOL_BM} of scale from plain:",
          json.dumps(flips))
    print("bit-equal to the package:", json.dumps(equal))
    load = {}
    if not quick:
        cfg = bm.BandMonitorConfig(num_channels=16, block=n_max)
        st = bm.init_state_fused(cfg, "cuda")
        x = torch.randn(2, n_max, generator=g, device="cuda")
        load = {who: sm_clock_under_load(fn) for who, fn in (
            ("package", lambda: package(cfg, (x[0], x[1]), st)),
            ("before", lambda: before_call(before, cfg, x[0], x[1], st)))}
        print(f"under back-to-back calls at K=16, N={n_max}, nvidia-smi "
              f"(min, median, max):", json.dumps(load))
    print(json.dumps({"card": card, "ms": times, "errors": errs,
                      "noise_flips": flips, "under_load": load,
                      "bit_equal_all": all(equal.values()),
                      "sass": sass, "fails": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--quick"]
    if len(args) != 1:
        raise SystemExit(__doc__)
    sys.exit(main(Path(args[0]), "--quick" in sys.argv[1:]))
