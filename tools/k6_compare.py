#!/usr/bin/env python3
"""K6 (the batched row FFT, ``kernels/fft.fft_planar``) against an earlier
K6 and ``torch.fft.fft``, in one process on one CUDA card.

    mkdir -p build/k6_before
    git show <rev>:comms_tpu_torch/csrc/fft.cu > build/k6_before/fft.cu
    git show <rev>:comms_tpu_torch/csrc/fft_smem.cuh \\
        > build/k6_before/fft_smem.cuh
    PYTHONPATH=. python3 tools/k6_compare.py build/k6_before

The earlier K6 is the shared-memory kernel whose C entry takes planar
twiddle tables (``fft_launch(xr, xi, rows, n, twr, twi, scale, yr, yi,
stream)``, up to commit 7dbfec7).  Beside it the script builds a
variant of the package's own ``csrc/fft.cu`` with one line changed,
``table_twiddles``: every pass twiddle a table entry (the core's
default) instead of K6's powers of one entry.

It builds the package's kernels, the earlier K6 and the variant (nvcc
for sm_90a, in parallel, into the earlier K6's directory), prints
ptxas's registers and spills for the FFT kernels of the package (K6, K10,
K7) and for the others, checks each K6 at every size (256..16384) and
several row counts against ``fft_plain`` (and the package's against a
float64 FFT; 1e-5 relative to the largest magnitude), then times each
size at 16,777,216 samples: ``torch.fft.fft`` of a complex tensor packed
beforehand, the earlier K6, the package's K6 twice, the earlier K6
again, the variant, ``torch.fft.fft`` again (device time as
``chip_smoke.cuda_ms`` measures it).  The last line is the result as
JSON; the exit code is 1 if a check failed.
"""

from __future__ import annotations

import ctypes
import functools
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

SIZES = (256, 512, 1024, 2048, 4096, 8192, 16384)
VARIANTS = {"table_twiddles": ("fft_reg<N, true>", "fft_reg<N, false>")}
SAMPLES = 1 << 24
TOL = 1e-5


@functools.lru_cache(maxsize=16)
def planar_twiddles(n: int, device: torch.device) -> torch.Tensor:
    """[2, n] float32 table (re, im) of W_n^k = e^{-2 pi i k / n} on
    ``device``, from float64 at the integer index k, made once per size
    and device: the planar tables that the shared-memory kernels before
    the register FFT took (the earlier K6 here, the earlier K7 in
    tools/k7_compare.py)."""
    w = np.exp((-2j * np.pi / n) * np.arange(n))
    return torch.from_numpy(np.stack([w.real, w.imag]).astype(
        np.float32)).to(device)


def ptxas_lines(log: str, pattern: str):
    """``name<args>: registers, spills`` for each kernel of ``log``
    (ptxas -v) whose mangled name matches ``pattern``."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if not m or not re.search(pattern, m.group(1)):
            continue
        # the identifier after its length, then the template arguments
        k = re.search(r"(?<=\d)((?:fft_rows|stage_\w+?|psd_\w+?)_kernel)"
                      r"(I(?:Li\d+E)+E)?", m.group(1))
        name = k.group(1) if k else m.group(1)
        if k and k.group(2):
            args = re.findall(r"Li(\d+)E", k.group(2))
            name += "<" + ", ".join(args) + ">"
        info = " ".join(lines[j].split(":", 1)[-1].strip()
                        for j in range(i + 1, min(i + 4, len(lines)))
                        if "spill" in lines[j] or "Used" in lines[j])
        out.append(f"{name}: {info}")
    return out


def main(before_dir: Path) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    print("torch", torch.__version__, "CUDA", torch.version.cuda)
    csrc = _build.CSRC_DIR
    sources = {"before": before_dir / "fft.cu"}
    for name, (old, new) in VARIANTS.items():
        text = (csrc / "fft.cu").read_text()
        if old not in text:
            raise SystemExit(f"{name}: {old!r} is not in csrc/fft.cu")
        d = before_dir / name
        d.mkdir(exist_ok=True)
        (d / "fft.cu").write_text(text.replace(old, new))
        (d / "fft_reg.cuh").write_text((csrc / "fft_reg.cuh").read_text())
        sources[name] = d / "fft.cu"
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
    for line in ptxas_lines(pkg_log, r"fft_rows|stage_|psd_"):
        print("ptxas, package:", line)
    for k, log in logs.items():
        for line in ptxas_lines(log, r"fft_rows"):
            print(f"ptxas, {k}:", line)

    p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
    libs = {}
    for k, src in sources.items():
        lib = ctypes.CDLL(str(src.with_suffix(".so")))
        lib.fft_launch.restype = i32
        lib.fft_launch.argtypes = (
            [p, p, i64, i32, p, p, f32, p, p, p] if k == "before" else
            [p, p, i64, i64, i32, p, f32, p, p, p])
        libs[k] = lib

    def other(k, xr, xi, n, yr, yi, scale=1.0):
        """One launch of the earlier K6 or a variant into yr, yi."""
        s = torch.cuda.current_stream().cuda_stream
        if k == "before":
            tw = planar_twiddles(n, xr.device)
            rc = libs[k].fft_launch(xr.data_ptr(), xi.data_ptr(),
                                    xr.shape[0], n, tw[0].data_ptr(),
                                    tw[1].data_ptr(), scale, yr.data_ptr(),
                                    yi.data_ptr(), s)
        else:
            rc = libs[k].fft_launch(xr.data_ptr(), xi.data_ptr(),
                                    xr.shape[0], xr.stride(0), n,
                                    SK.pass_twiddles(n, xr.device)
                                    .data_ptr(), scale, yr.data_ptr(),
                                    yi.data_ptr(), s)
        if rc:
            raise RuntimeError(f"{k}: CUDA error {rc}")

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    errs, fails = {}, []
    for n in SIZES:
        for rows in sorted({1, 3, 37, max(2, 2048 // n + 1)}):
            x = torch.randn(2, rows, n, generator=g, device="cuda")
            s = 1.0 / np.sqrt(n)
            yr, yi = SK.fft_planar(x[0], x[1], n, scale=s)
            want = torch.complex(*SK.fft_plain(x[0], x[1], s))
            o = torch.fft.fft(torch.complex(x[0].double(), x[1].double())) * s
            got = torch.complex(yr, yi)
            checks = [(f"k6_{n}_vs_plain", rel(got, want)),
                      (f"k6_{n}_vs_float64", rel(got.to(o.dtype), o))]
            for k in libs:
                br, bi = torch.empty_like(yr), torch.empty_like(yi)
                other(k, x[0], x[1], n, br, bi, s)
                checks.append((f"{k}_{n}_vs_plain",
                               rel(torch.complex(br, bi), want)))
            for key, e in checks:
                errs[key] = max(errs.get(key, 0.0), e)
                if not e <= TOL:
                    fails.append(f"{key} rows={rows}: {e}")
        r2 = torch.randn(2, 4 * n, generator=g, device="cuda")
        v = (r2[0].unfold(0, n, n // 2), r2[1].unfold(0, n, n // 2))
        e = rel(torch.complex(*SK.fft_planar(*v, n)),
                torch.complex(*SK.fft_plain(v[0].contiguous(),
                                            v[1].contiguous())))
        errs[f"k6_{n}_strided_vs_plain"] = e
        if not e <= TOL:
            fails.append(f"strided n={n}: {e}")
    print("worst relative errors:",
          json.dumps({k: float(f"{v:.3g}") for k, v in errs.items()}))

    nr, ni = torch.randn(2, SAMPLES, generator=g, device="cuda")
    times = {}
    for n in SIZES:
        rr, ii = nr.view(-1, n), ni.view(-1, n)
        z = torch.complex(rr, ii)
        yr, yi = torch.empty_like(rr), torch.empty_like(ii)
        t = {"torch_fft": [cs.cuda_ms(lambda: torch.fft.fft(z))],
             "before": [], "k6": []}
        for who in ("before", "k6", "k6", "before", *VARIANTS):
            if who == "k6":
                ms = cs.cuda_ms(lambda: SK.fft_planar(rr, ii, n))
            else:
                ms = cs.cuda_ms(lambda: other(who, rr, ii, n, yr, yi))
            t.setdefault(who, []).append(ms)
        t["torch_fft"].append(cs.cuda_ms(lambda: torch.fft.fft(z)))
        t["bound"] = 16 * SAMPLES / cs.HBM_BYTES_PER_S * 1e3
        times[n] = t
        print(f"n={n} on {card}, ms:", json.dumps(t))
        del z, yr, yi
    print(json.dumps({"card": card, "samples": SAMPLES, "errors": errs,
                      "ms": times, "fails": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
