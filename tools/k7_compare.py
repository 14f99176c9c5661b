#!/usr/bin/env python3
"""K7 (the Welch PSD kernel: ``kernels/fft.psd_stream_planar`` and
``psd_planar``) against an earlier K7, in one process on one CUDA card.

    mkdir -p build/k7_before
    git show <rev>:comms_tpu_torch/csrc/psd.cu > build/k7_before/psd.cu
    git show <rev>:comms_tpu_torch/csrc/fft_smem.cuh \\
        > build/k7_before/fft_smem.cuh
    PYTHONPATH=. python3 tools/k7_compare.py build/k7_before

The earlier K7 is the shared-memory kernel whose C entry takes planar
twiddle tables and a tile partition (``psd_launch(xr, xi, rows,
row_stride, n, win, row_w, demean, twr, twi, part, G, tiles_per_block,
out, stream)``, up to commit 4c4a2f1).  Beside it the script builds
variants of the package's own ``csrc/psd.cu`` with a few lines changed
(``VARIANTS``: the choices the design made, each undone) and probes with
one piece of work cut out, so that its time can be read off (``PROBES``;
their sums are wrong by design and are not checked), and runs the
package's kernel on other run partitions (``PARTITIONS``: other values
of ``_PSD_RUN_THREADS``).

It builds everything (nvcc for sm_90a, in parallel, into the earlier
K7's directory), prints ptxas's registers and spills for the PSD kernels
of the package and of each build and the SASS opcode counts of the
package's partial kernel at 1024 and 16384 points, then, at every size
256..16384 on a white-noise stream of 16,777,216 samples:

- checks bin by bin (2e-5) each entry of the package (the stream; rows
  as the stream's ``unfold`` view; contiguous rows at stride n) against
  the plain version and a float64 oracle, the earlier K7, the variants
  and the partitions against the plain version, and the package's
  repeats and its stream against its rows bit for bit;
- times (device time as ``chip_smoke.cuda_ms`` measures it) the stream
  entry as earlier / package / package / earlier, the rows entry on the
  ``unfold`` view the same way, contiguous rows, each variant, probe and
  partition, and beside them the FFT-alone yardstick (``torch.fft.fft``
  of the same segments packed beforehand: the same transforms, without
  the window, demean and sums) and the bound (``chip_smoke.bound``).

The last line is the result as JSON; the exit code is 1 if a check
failed.
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
from comms_tpu_torch.kernels import fft as SK
from comms_tpu_torch.ops import spectrum as tspec
from k6_compare import planar_twiddles, ptxas_lines

SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)
SAMPLES = 1 << 24
TOL = 2e-5
VARIANTS = {
    "volatile": [("  const int t = threadIdx.x % T;",
                  "  int t = threadIdx.x % T;"),
                 ("  for (int i = 0; i < p.per_run; ++i) {\n",
                  "  for (int i = 0; i < p.per_run; ++i) {\n"
                  '    asm volatile("" : "+r"(t));\n')],
    "window_regs": [("kWindowRegsUpTo = 1024;", "kWindowRegsUpTo = 8192;")],
    "no_carry": [("kCarry = true;", "kCarry = false;")],
    "reduce_rolled": [("#pragma unroll 8\n", "")],
}
# Each cuts one piece of work, so that its time can be read off; their
# sums are wrong by design and are not checked.
_L1 = "__ldg(p.win + t + T * "
PROBES = {
    "p_no_fft": [("    fft_reg<N, true>(vr, vi, t, smem + g * LD, p.tw);\n",
                  "")],
    "p_no_demean": [("    if (p.demean) {", "    if (false) {")],
    "p_reduce_only": [("  const int t = threadIdx.x % T;\n",
                       "  if (p.per_run > 0) return;\n"
                       "  const int t = threadIdx.x % T;\n")],
    "p_l1_loads": [("__ldg(a + T * q)", _L1 + "q)"),
                   ("__ldg(b + T * q)", _L1 + "q)"),
                   ("__ldg(a + T * (q + kHalf))", _L1 + "(q + kHalf))"),
                   ("__ldg(b + T * (q + kHalf))", _L1 + "(q + kHalf))")],
}
PARTITIONS = (1 << 15, 1 << 17)


@contextlib.contextmanager
def partition(run_threads: int):
    """The package's kernel on another run partition: ``SK.psd_partition``
    with another ``_PSD_RUN_THREADS``."""
    old = SK._PSD_RUN_THREADS
    SK._PSD_RUN_THREADS = run_threads
    try:
        yield
    finally:
        SK._PSD_RUN_THREADS = old


def sass_histogram(lib: Path, kernel: str) -> dict:
    """Opcode counts of one kernel's SASS (``cuobjdump -sass`` beside
    nvcc; ``kernel`` a part of its mangled name), or {} where the toolkit
    has no cuobjdump."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = kernel in line
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?"
                     r"([A-Z][\w.]*)", line)
        if inside and m:
            op = m.group(1).split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    counts["total"] = sum(counts.values())
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def main(before_dir: Path) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    print("torch", torch.__version__, "CUDA", torch.version.cuda)
    csrc = _build.CSRC_DIR
    sources = {"before": before_dir / "psd.cu"}
    for name, edits in {**VARIANTS, **PROBES}.items():
        text = (csrc / "psd.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in csrc/psd.cu")
            text = text.replace(old, new)
        d = before_dir / name
        d.mkdir(exist_ok=True)
        (d / "psd.cu").write_text(text)
        (d / "fft_reg.cuh").write_text((csrc / "fft_reg.cuh").read_text())
        sources[name] = d / "psd.cu"
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
    pkg_log = Path(f"{_build.library_path()}.log").read_text()
    for line in ptxas_lines(pkg_log, r"psd_"):
        print("ptxas, package:", line)
    for k, log in logs.items():
        for line in ptxas_lines(log, r"psd_"):
            print(f"ptxas, {k}:", line)
    for n in (1024, 16384):
        print(f"SASS of psd_partial_kernel<{n}>, package:",
              json.dumps(sass_histogram(_build.library_path(),
                                        f"psd_partial_kernelILi{n}E")))

    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    libs = {}
    for k, src in sources.items():
        lib = ctypes.CDLL(str(src.with_suffix(".so")))
        lib.psd_launch.restype = i32
        lib.psd_launch.argtypes = (
            [p, p, i64, i64, i32, p, p, i32, p, p, p, i32, i32, p, p]
            if k == "before" else
            [p, p, i64, i64, i32, p, p, i32, p, i32, p, i32, p, p])
        libs[k] = lib

    def other(k, xr, xi, n, w):
        """One call of the earlier K7 or a variant over the rows of the
        views xr, xi (demean on, no row weights); returns acc[n]."""
        rows, stride = xr.shape[0], xr.stride(0)
        out = torch.empty(n, device=xr.device)
        s = torch.cuda.current_stream().cuda_stream
        if k == "before":
            tile = max(n, 4096) // n
            tiles = -(-rows // tile)
            per_block = -(-tiles // 512)
            G = -(-tiles // per_block)
            part = torch.empty((G, n), device=xr.device)
            tw = planar_twiddles(n, xr.device)
            rc = libs[k].psd_launch(
                xr.data_ptr(), xi.data_ptr(), rows, stride, n, w.data_ptr(),
                None, 1, tw[0].data_ptr(), tw[1].data_ptr(), part.data_ptr(),
                G, per_block, out.data_ptr(), s)
        else:
            per_run, blocks = SK.psd_partition(rows, n)
            part = torch.empty((blocks, n), device=xr.device)
            rc = libs[k].psd_launch(
                xr.data_ptr(), xi.data_ptr(), rows, stride, n, w.data_ptr(),
                None, 1, SK.pass_twiddles(n, xr.device).data_ptr(), per_run,
                part.data_ptr(), blocks, out.data_ptr(), s)
        if rc:
            raise RuntimeError(f"{k}: CUDA error {rc}")
        return out

    g = torch.Generator(device="cuda")
    g.manual_seed(7)
    nr, ni = torch.randn(2, SAMPLES, generator=g, device="cuda")
    errs, fails, same, times = {}, [], {}, {}

    def check(key, got, want):
        e = cs.bin_err(got.to(want.dtype), want)
        errs[key] = e
        if not e <= TOL:
            fails.append(f"{key}: {e}")

    for n in SIZES:
        w = SK._window(tspec.hann(n), n, nr.device)
        ur, ui = nr.unfold(0, n, n // 2), ni.unfold(0, n, n // 2)
        cr, ci = nr.view(-1, n), ni.view(-1, n)
        got = SK.psd_stream_planar(nr, ni, w, n)
        again = SK.psd_stream_planar(nr, ni, w, n)
        rows = SK.psd_planar(ur, ui, w, n)
        contig = SK.psd_planar(cr, ci, w, n)
        plain = SK.psd_stream_plain(nr, ni, w, n)
        f64 = SK.psd_stream_plain(nr.double(), ni.double(), w, n)
        check(f"k7_{n}_stream_vs_plain", got, plain)
        check(f"k7_{n}_stream_vs_float64", got, f64)
        check(f"k7_{n}_rows_vs_plain", rows, plain)
        check(f"k7_{n}_contig_vs_plain", contig, SK.psd_plain(cr, ci, w))
        check(f"k7_{n}_contig_vs_float64", contig,
              SK.psd_plain(cr.double(), ci.double(), w))
        if not (torch.equal(got, again) and torch.equal(got, rows)):
            fails.append(f"k7_{n}: repeat or rows not bit-equal to stream")
        for k in (k for k in libs if k not in PROBES):
            o = other(k, ur, ui, n, w)
            check(f"{k}_{n}_vs_plain", o, plain)
            if k != "before":
                same[f"{k}_{n}"] = bool(torch.equal(o, got))
        for rt in PARTITIONS:
            with partition(rt):
                check(f"runs{rt}_{n}_vs_plain",
                      SK.psd_stream_planar(nr, ni, w, n), plain)
        del plain, f64

        z = torch.complex(ur, ui).contiguous()
        t = {"torch_fft": [cs.cuda_ms(lambda: torch.fft.fft(z, dim=1))]}
        for who in ("before", "k7", "k7", "before"):
            if who == "k7":
                ms = cs.cuda_ms(lambda: SK.psd_stream_planar(nr, ni, w, n))
            else:
                ms = cs.cuda_ms(lambda: other(who, ur, ui, n, w))
            t.setdefault(f"stream_{who}", []).append(ms)
        for who in ("before", "k7", "k7", "before"):
            if who == "k7":
                ms = cs.cuda_ms(lambda: SK.psd_planar(ur, ui, w, n))
            else:
                ms = cs.cuda_ms(lambda: other(who, ur, ui, n, w))
            t.setdefault(f"rows_{who}", []).append(ms)
        t["contig_rows_k7"] = cs.cuda_ms(lambda: SK.psd_planar(cr, ci, w, n))
        t["contig_rows_before"] = cs.cuda_ms(
            lambda: other("before", cr, ci, n, w))
        for k in (*VARIANTS, *PROBES):
            t[k] = cs.cuda_ms(lambda: other(k, ur, ui, n, w))
        for rt in PARTITIONS:
            with partition(rt):
                t[f"runs{rt}"] = cs.cuda_ms(
                    lambda: SK.psd_stream_planar(nr, ni, w, n))
        t["torch_fft"].append(cs.cuda_ms(lambda: torch.fft.fft(z, dim=1)))
        nseg = ur.shape[0]
        t["bound"] = cs.bound(8 * SAMPLES + 8 * n,
                              nseg * n * (5 * np.log2(n) + 10))[0]
        t["partition"] = SK.psd_partition(nseg, n)
        times[n] = t
        print(f"n={n} on {card}, ms:", json.dumps(t))
        del z
    print("worst per-bin errors:",
          json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))
    print("variants bit-equal to the package:", json.dumps(same))
    print(json.dumps({"card": card, "samples": SAMPLES, "errors": errs,
                      "ms": times, "bit_equal": same, "fails": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
