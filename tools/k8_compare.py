#!/usr/bin/env python3
"""K8 (the polyphase channelizer, ``kernels/channelizer.channelize_planar``)
against an earlier K8, in one process on one CUDA card.

    mkdir -p build/k8_before
    for f in channelizer.cu channelize_tile.cuh; do
      git show 80165ab:comms_tpu_torch/csrc/$f > build/k8_before/$f
    done
    PYTHONPATH=.:tools python3 tools/k8_compare.py build/k8_before [--quick]

The earlier K8 (up to 80165ab: one tile a block, the direct DFT) has the
C entry of the package without the block count; it is built from the
directory and loaded with ctypes.  Beside it the script builds the
``VARIANTS``, the package's ``csrc/channelizer.cu`` with one
design choice undone (``runs``: each block walks a run of consecutive
tiles, only the first loading its whole window, the later ones their new
rows with the look-back copied from buffer to buffer; ``stcs``: the
spectrum stored with evict-first hints; ``own_stores``: at K <= 16 each
thread stores its own 16 outputs, in half sectors, instead of swapping
halves with its pair), and the ``PROBES`` (one stage cut, so that its time
can be read off; their output is wrong by design and not checked).  It
also runs the package with other block counts (``blocks_*``, and
``one_tile``: a block a tile).

It prints ptxas's lines of every build's ``channelize_kernel`` and the
SASS opcode counts of the package's and the earlier kernel at K = 16 and
64, then, on white noise from mid-stream context:

- at every K | 128 and M in {1, 8, 16} (M*K <= 1025) and N = 16,384 and
  1,048,576: the error against the plain version (held to
  ``chip_smoke.TOL_CHAN``) and against a float64 channelizer of the same
  float32 inputs and taps (``chip_smoke.channelize_f64``), for the package
  and the earlier K8; the package's repeat, ``one_tile``, the variants and
  two chained calls of N/2 bit-equal to one call (``torch.equal``);
- at N = 16,777,216, M = 8 and K = 16, 64 and 128: the same errors (the
  package no further from float64 than the earlier K8), then times
  (``chip_smoke.cuda_ms``, device time behind a spin kernel, median of 7)
  earlier / package / package / earlier beside the bound of
  ``chip_smoke.bound`` and the plain version, then the variants, the
  probes and the other block counts (``runs_264``: the runs variant in
  one wave of blocks, the first design);
- nvidia-smi's SM clock and power under back-to-back calls of both
  kernels at K = 64.

``--quick`` runs the checks at the two smaller sizes and the times at
K = 64 only.  The last line is the result as JSON; the exit code is 1 if
a check failed.
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
from comms_tpu_torch.kernels import channelizer as CK
from comms_tpu_torch.ops import channelizer as chan
from k1_compare import sm_clock_under_load
from k7_compare import sass_histogram

KS = (2, 4, 8, 16, 32, 64, 128)
TAPS = (1, 8, 16)
SIZES = (16_384, 1_048_576)
BIG = 16_777_216
TIMED_K = (16, 64, 128)
RUN_BLOCKS = (264, 1056)
BEFORE_FILES = ("channelizer.cu", "channelize_tile.cuh")
_STRIDED = (
    "  const int stride = static_cast<int>(gridDim.x);\n"
    "  load_rows<K>(smem, re, im, ctx_re, ctx_im, s, blockIdx.x, 0, F + s.M);"
    "\n\n  for (int tile = blockIdx.x, it = 0; tile < s.tiles; tile += stride,"
    " ++it) {\n"
    "    float* const cur = smem + 2 * s.buf * (it & 1);\n"
    "    float* const nxt = smem + 2 * s.buf * ((it + 1) & 1);\n"
    "    cp_async_wait();\n"
    "    __syncthreads();                  // window in; the last tile done\n"
    "    if (tile + stride < s.tiles) {\n"
    "      load_rows<K>(nxt, re, im, ctx_re, ctx_im, s, tile + stride, 0, "
    "F + s.M);\n"
    "    }\n")
# Runs of consecutive tiles a block: a run's first tile loads its whole
# window, each later one its F new rows, its look-back copied from the
# tile before's buffer (shared to shared).
_RUNS = (
    "  const int run = (s.tiles + gridDim.x - 1) / gridDim.x;\n"
    "  const int t_begin = static_cast<int>(blockIdx.x) * run;\n"
    "  const int t_end = min(t_begin + run, s.tiles);\n"
    "  if (t_begin < t_end) {\n"
    "    load_rows<K>(smem, re, im, ctx_re, ctx_im, s, t_begin, 0, F + s.M);\n"
    "  }\n"
    "  for (int tile = t_begin; tile < t_end; ++tile) {\n"
    "    float* const cur = smem + 2 * s.buf * ((tile - t_begin) & 1);\n"
    "    float* const nxt = smem + 2 * s.buf * ((tile - t_begin + 1) & 1);\n"
    "    cp_async_wait();\n"
    "    __syncthreads();\n"
    "    if (tile + 1 < t_end) {\n"
    "      load_rows<K>(nxt, re, im, ctx_re, ctx_im, s, tile + 1, s.M, F);\n"
    "      const int nq = s.M * (K / 4 < 1 ? 1 : K / 4);\n"
    "      for (int c = threadIdx.x; c < 2 * nq; c += kThreads) {\n"
    "        const int pl = c >= nq, i = c - pl * nq;\n"
    "        const int V = K < 4 ? K : 4;\n"
    "        const int q = i / (K / V), e = (i - q * (K / V)) * V;\n"
    "        for (int v = 0; v < V; ++v) {\n"
    "          nxt[pl * s.buf + row_word<K>(q) + e + v] =\n"
    "              cur[pl * s.buf + row_word<K>(F + q) + e + v];\n"
    "        }\n"
    "      }\n"
    "    }\n")
_STCS = [("  *reinterpret_cast<float4*>(p) = v;",
          "  __stcs(reinterpret_cast<float4*>(p), v);"),
         ("  *reinterpret_cast<float2*>(p) = v;",
          "  __stcs(reinterpret_cast<float2*>(p), v);")]
VARIANTS = {
    "runs": [(_STRIDED, _RUNS)],
    "stcs": _STCS,
    "own_stores": [
        ("  __syncwarp();\n  const int odd = tau & 1;",
         "  if (buf > 0) {\n#pragma unroll\n  for (int u = 0; u < 4; ++u) {\n"
         "    *reinterpret_cast<float4*>(yr + 16 * tau + 4 * u) =\n"
         "        *reinterpret_cast<const float4*>(cr + 4 * u);\n"
         "    *reinterpret_cast<float4*>(yi + 16 * tau + 4 * u) =\n"
         "        *reinterpret_cast<const float4*>(ci + 4 * u);\n  }\n"
         "  return;\n  }\n  __syncwarp();\n  const int odd = tau & 1;")],
}
PROBES = {
    "p_no_dft16": [
        ("  frame_dfts<K>(vr, vi);", "  if (buf < 0) frame_dfts<K>(vr, vi);"),
        ("  dft16<0>(vr, vi);\n  // B_t", "  if (buf < 0) dft16<0>(vr, vi);\n"
         "  // B_t")],
    "p_one_tap": [("    if (i < M) {", "    if (i < M && i < 1) {")],
}


class _Swapped:
    """The package's library with another build's ``channelize_launch``."""

    def __init__(self, lib, other):
        self._lib, self.channelize_launch = lib, other.channelize_launch

    def __getattr__(self, name):
        return getattr(self._lib, name)


@contextlib.contextmanager
def kernel_of(lib=None, run_blocks=None):
    """The wrapper launching ``lib``'s K8 (same C entry as the package's),
    with ``run_blocks`` in place of ``CK._RUN_BLOCKS``."""
    pkg = _build.load()
    keep = CK._RUN_BLOCKS
    _build._lib = _Swapped(pkg, lib) if lib is not None else pkg
    if run_blocks is not None:
        CK._RUN_BLOCKS = run_blocks
    try:
        yield
    finally:
        _build._lib = pkg
        CK._RUN_BLOCKS = keep


def bind(lib, with_run: bool):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.channelize_launch.restype = i32
    lib.channelize_launch.argtypes = (
        [p, p, p, p, i32, p, p, i32, i32, i64]
        + ([i32] if with_run else []) + [p, p, p])
    return lib


def before_call(lib, re_, im_, h, ctx_r, ctx_i, k):
    """The earlier K8 through its own C entry (no run length)."""
    dev = re_.device
    frames = re_.shape[0] // k
    yr = torch.empty((frames, k), dtype=torch.float32, device=dev)
    yi = torch.empty_like(yr)
    C = _build.device_constant(CK.branch_matrix(h, k), dev)
    roots = _build.device_constant(CK.root_table(k), dev)
    rc = lib.channelize_launch(
        re_.data_ptr(), im_.data_ptr(), ctx_r.data_ptr(), ctx_i.data_ptr(),
        CK.CTX_SAMPLES, C.data_ptr(), roots.data_ptr(), k, h.shape[0] // k,
        frames, yr.data_ptr(), yi.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"earlier K8: CUDA error {rc}")
    return yr, yi


def ptxas_report(log: str) -> list:
    """``channelize_kernel<K>: registers, spills`` lines of a ptxas log."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*17channelize_kernel"
                      r"ILi(\d+)E", line)
        if m:
            name = f"channelize_kernel<{m.group(1)}>"
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
    for f in BEFORE_FILES:
        if not (before_dir / f).exists():
            raise SystemExit(f"{before_dir / f} missing (see the usage)")
    csrc = _build.CSRC_DIR
    sources = {"before": before_dir / "channelizer.cu"}
    for name, edits in {**VARIANTS, **PROBES}.items():
        text = (csrc / "channelizer.cu").read_text()
        for old, new in edits:
            if text.count(old) != 1:
                raise SystemExit(f"{name}: {old!r} is not once in the source")
            text = text.replace(old, new)
        d = before_dir / name
        d.mkdir(exist_ok=True)
        (d / "channelizer.cu").write_text(text)
        (d / "fft_reg.cuh").write_text((csrc / "fft_reg.cuh").read_text())
        sources[name] = d / "channelizer.cu"
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
            _build.library_path(), f"channelize_kernelILi{K}E")
        sass[f"before_K{K}"] = sass_histogram(
            sources["before"].with_suffix(".so"), f"channelize_kernelILi{K}E")
    for k, hist in sass.items():
        print(f"SASS of channelize_kernel, {k}:", json.dumps(hist))
    libs = {k: ctypes.CDLL(str(src.with_suffix(".so")))
            for k, src in sources.items()}
    before = bind(libs.pop("before"), False)
    libs = {k: bind(v, True) for k, v in libs.items()}

    def package(x, h, ctx, k, lib=None, run_blocks=None):
        with kernel_of(lib, run_blocks):
            return CK.channelize_planar(x[0], x[1], h, *ctx, k)[:2]

    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    fails, equal, errs = [], {}, {}
    n_max = max(SIZES) if quick else BIG
    cap = torch.randn(2, CK.CTX_SAMPLES + n_max, generator=g, device="cuda")
    ctx = (cap[0, :CK.CTX_SAMPLES].contiguous(),
           cap[1, :CK.CTX_SAMPLES].contiguous())
    data = cap[:, CK.CTX_SAMPLES:]

    def check(key, x, h, k, chained):
        got = package(x, h, ctx, k)
        runs = {"again": package(x, h, ctx, k),
                "one_tile": package(x, h, ctx, k, run_blocks=1 << 30)}
        for v in VARIANTS:
            runs[v] = package(x, h, ctx, k, libs[v])
        if chained:
            n = x[0].shape[0] // 2
            a = CK.channelize_planar(x[0][:n], x[1][:n], h, *ctx, k)
            b = CK.channelize_planar(x[0][n:], x[1][n:], h, a[2], a[3], k)
            runs["chained"] = (torch.cat([a[0], b[0]]), torch.cat([a[1],
                                                                   b[1]]))
        for name, out in runs.items():
            same = all(torch.equal(u, v) for u, v in zip(got, out))
            equal[f"{key}_{name}"] = same
            if not same:
                fails.append(f"{key}: {name} not bit-equal")
        plain = CK.channelize_plain(x[0], x[1], h, *ctx, k)[:2]
        old = before_call(before, x[0], x[1], h, *ctx, k)
        f64 = cs.channelize_f64(x[0], x[1], h, *ctx, k)
        e = {"plain": max(cs.rel_err(a, b) for a, b in zip(got, plain)),
             "f64": max(cs.rel_err(a.double(), b) for a, b in zip(got, f64)),
             "before_plain": max(cs.rel_err(a, b) for a, b in zip(old, plain)),
             "before_f64": max(cs.rel_err(a.double(), b) for a, b in zip(old, f64))}
        errs[key] = e
        if not e["plain"] <= cs.TOL_CHAN:
            fails.append(f"{key}: {e['plain']} against plain")
        if not all(torch.isfinite(a).all() for a in got):
            fails.append(f"{key}: non-finite output")
        return e

    for k in KS:
        for M in TAPS:
            if M * k > CK.CTX_SAMPLES + 1:
                continue
            h = chan.design_prototype(k, M)
            for n in SIZES:
                x = (data[0, :n], data[1, :n])
                check(f"K{k}_M{M}_{n}", x, h, k, n >= 32_768)
    torch.cuda.synchronize()

    times = {}
    for k in ((64,) if quick else TIMED_K):
        h = chan.design_prototype(k, 8)
        x = (data[0, :n_max], data[1, :n_max])
        if not quick:
            e = check(f"K{k}_M8_{n_max}", x, h, k, True)
            if not e["f64"] <= e["before_f64"]:
                fails.append(f"K{k}: {e['f64']} from float64, the earlier "
                             f"K8 {e['before_f64']}")
        t = {}
        for who in ("before", "package", "package", "before"):
            fn = ((lambda: package(x, h, ctx, k)) if who == "package" else
                  (lambda: before_call(before, x[0], x[1], h, *ctx, k)))
            t.setdefault(who, []).append(cs.cuda_ms(fn))
        t["plain"] = cs.cuda_ms(lambda: CK.channelize_plain(
            x[0], x[1], h, *ctx, k))
        for v in (*VARIANTS, *PROBES):
            t[v] = cs.cuda_ms(lambda: package(x, h, ctx, k, libs[v]))
        t["one_tile"] = cs.cuda_ms(
            lambda: package(x, h, ctx, k, run_blocks=1 << 30))
        for rb in RUN_BLOCKS:
            t[f"blocks_{rb}"] = cs.cuda_ms(
                lambda: package(x, h, ctx, k, run_blocks=rb))
        t["runs_264"] = cs.cuda_ms(
            lambda: package(x, h, ctx, k, libs["runs"], 264))
        t["speedup"] = sum(t["before"]) / sum(t["package"])
        t["bound"] = cs.bound(16 * n_max,
                              n_max * (4 * 8 + 5 * np.log2(k)))[0]
        t["tiles_run_blocks"] = CK.partition(n_max // k, k)
        times[f"K{k}_{n_max}"] = t
        print(f"K={k} N={n_max} M=8 on {card}, ms:", json.dumps(t))
    print("errors (relative to the largest output):", json.dumps(errs))
    print("bit-equal to the package:", json.dumps(equal))
    load = {}
    if not quick:
        h = chan.design_prototype(64, 8)
        x = (data[0], data[1])
        load = {who: sm_clock_under_load(fn) for who, fn in (
            ("package", lambda: package(x, h, ctx, 64)),
            ("before", lambda: before_call(before, x[0], x[1], h, *ctx,
                                           64)))}
        print(f"under back-to-back calls at K=64, N={n_max}, nvidia-smi "
              f"(min, median, max):", json.dumps(load))
    print(json.dumps({"card": card, "ms": times, "errors": errs,
                      "under_load": load,
                      "bit_equal_all": all(equal.values()),
                      "sass": sass, "fails": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--quick"]
    if len(args) != 1:
        raise SystemExit(__doc__)
    sys.exit(main(Path(args[0]), "--quick" in sys.argv[1:]))
