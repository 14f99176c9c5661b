#!/usr/bin/env python3
"""K4, the dense streaming FIR (``kernels/fir.fir_planar``, on the
decimating-FIR kernel of ``csrc/decim_fir.cu`` at D = 1), against the
first K4 kernel (``csrc/fir.cu`` up to 28f7200), in one process on one
CUDA card.

    mkdir -p build/k4_before
    git show 28f7200:comms_tpu_torch/csrc/fir.cu > build/k4_before/fir.cu
    PYTHONPATH=.:tools python3 tools/k4_compare.py build/k4_before [--quick]

The first kernel (one block of 256 threads per 1024 outputs, 4 outputs a
thread sliding in registers, the next context copied by its wrapper) is
built from the directory and swapped in under the package's wrapper, so
both run the same host code up to the launch (its launch followed by the
two context copies its wrapper made).  Beside it the script builds the
``VARIANTS``, the package's ``csrc/decim_fir.cu`` with R, the outputs a
thread at D = 1, set to 5, 7 or 11 (odd: conflict-free loads; the
package has 9), and the ``PROBES`` of ``tools/k2_compare.py`` (no window
copy after a block's first window; no im-plane chain; their outputs are
wrong by design and are not checked).  It also runs the package with
other partitions (``blocks_*``: persistent blocks at most; ``one_tile``:
a block a tile; ``threads_64``).

It prints ptxas's lines of every build's kernels at D = 1 and the first
kernel's, the SASS opcode counts of both (real and complex taps), then
checks the package's outputs ``torch.equal`` to the first kernel's, to
the variants' and to the other partitions' (and the next context the
launch writes equal to the block's last 1024 samples):

- 33,554,432 samples with the QPSK matched filter's 32 real taps, from
  the zero context and from a mid-stream context;
- 257 complex taps (33,554,432 samples) and 1025 complex taps
  (8,388,608 samples), mid-stream context;
- T = 1 (1,048,576 samples);
- N = 1024 with ``tile_rows=8`` (32 taps);
- two chained halves against one call (32 real and 257 complex taps);

each also within ``chip_smoke.TOL_FIR`` of ``fir_plain``.  Then it times
(``chip_smoke.cuda_ms``, device time behind a spin kernel, median of 7)
first / package / package / first at every checked shape, beside the
plain version, ``F.conv1d`` over the two planes (cuDNN, TF32 off;
complex taps as two channels into two) and the bound; the variants,
probes and partitions at the 32-tap, 257- and 1025-tap shapes; and reads
nvidia-smi's SM clock and power under back-to-back 32-tap calls of both
kernels.

``--quick`` skips the variants, probes, partitions and the clock
readings.  The last line is the result as JSON; the exit code is 1 if a
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
from comms_tpu_torch.kernels import decim_fir as DF
from comms_tpu_torch.kernels import fir as FK
from comms_tpu_torch.models import qpsk_rx as trx
from k1_compare import sass_text, sm_clock_under_load
from k2_compare import PROBES, _Swapped
from k7_compare import sass_histogram

R_PKG = "{1, 9, 7, 5, 5, 7, 3, 3, 3}"
VARIANTS = {f"r{r}": [(R_PKG, "{1, %d, 7, 5, 5, 7, 3, 3, 3}" % r)]
            for r in (5, 7, 11)}
# The wrapper's constants a variant needs (its outputs a thread).
VARIANT_CONSTS = {f"r{r}": {"_R_OF_D": (1, r, 7, 5, 5, 7, 3, 3, 3)}
                  for r in (5, 7, 11)}
PARTITIONS = {"blocks_1056": {"_RUN_BLOCKS": 1056},
              "blocks_2112": {"_RUN_BLOCKS": 2112},
              "blocks_8448": {"_RUN_BLOCKS": 8448},
              "blocks_16896": {"_RUN_BLOCKS": 16896},
              "one_tile": {"_RUN_BLOCKS": 1 << 30},
              "threads_64": {"_THREADS": (64,)}}
TIMED_MORE = ("mf32_mid", "c257", "c1025")


def _first_launch(lib):
    """``kernels/fir._launch`` for the first kernel: its wrapper's launch
    (taps as float32 planes, T, complex flag) and its two copies of the
    block's last 1024 samples for the next context."""
    def launch(xr, xi, taps, ctx_r, ctx_i):
        dev = xr.device
        hr, hi = DF._padded_taps(taps, 1)
        cplx = int(hi is not None)
        yr, yi = torch.empty_like(xr), torch.empty_like(xi)
        th_r = _build.device_constant(hr, dev)
        th_i = _build.device_constant(hi, dev) if cplx else None
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.fir_launch(
            xr.data_ptr(), xi.data_ptr(), ctx_r.data_ptr(), ctx_i.data_ptr(),
            th_r.data_ptr(), th_i.data_ptr() if cplx else None,
            hr.shape[0], cplx, xr.shape[0], yr.data_ptr(), yi.data_ptr(),
            stream)
        if rc != 0:
            raise RuntimeError(f"first FIR kernel: CUDA error {rc}")
        FK.launches += 1
        return (yr, yi, xr[-1024:].reshape(8, 128).clone(),
                xi[-1024:].reshape(8, 128).clone())
    return launch


_PKG_LAUNCH = FK._launch


@contextlib.contextmanager
def kernel_of(lib=None, first=False, **consts):
    """``kernels/fir``'s wrapper launching ``lib``'s kernel (the first
    kernel's entry with ``first``, else a build of ``decim_fir.cu``), with
    module constants of ``kernels/fir`` (where it has them) or
    ``kernels/decim_fir`` set from ``consts``."""
    pkg = _build.load()
    mods = {k: FK if hasattr(FK, k) else DF for k in consts}
    keep = {k: getattr(mods[k], k) for k in consts}
    if first:
        FK._launch = _first_launch(lib)
    elif lib is not None:
        _build._lib = _Swapped(pkg, lib, False)
    for k, v in consts.items():
        setattr(mods[k], k, v)
    try:
        yield
    finally:
        FK._launch = _PKG_LAUNCH
        _build._lib = pkg
        for k, v in keep.items():
            setattr(mods[k], k, v)


def bind(lib, first: bool):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    if first:
        lib.fir_launch.restype = i32
        lib.fir_launch.argtypes = [p, p, p, p, p, p, i32, i32, i64, p, p, p]
        return lib
    lib.decim_fir_smem_bytes.restype = i64
    lib.decim_fir_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.decim_fir_launch.restype = i32
    lib.decim_fir_launch.argtypes = [p, p, p, p, i32, p, p, i32, i32, i32,
                                     i64, i32, i32, i32, p, p, p, p, p]
    return lib


def ptxas_report(log: str) -> list:
    """``kernel: registers, stack, smem, spills`` lines of a ptxas log for
    the D = 1 decimating-FIR kernels and the first K4 kernel."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(decim_fir_kernel"
                      r"ILi1ELb\d|fir_kernelILb\d)E", line)
        if m:
            name = m.group(1)
        elif "Compiling entry function" in line:
            name = None
        elif name and ("Used" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                name = None
    return out


def conv1d_ms(xr, xi, cr, ci, taps):
    """``F.conv1d`` over the planes, each with its T-1 context samples in
    front (complex taps: two channels into two), TF32 off; with the
    check of its output against the package's kernel."""
    T = np.asarray(taps).shape[0]
    head = (lambda c: c.reshape(-1)[-(T - 1):]) if T > 1 else (
        lambda c: c.reshape(-1)[:0])
    rows = torch.stack([torch.cat([head(cr), xr]), torch.cat([head(ci), xi])])
    keep = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        want = torch.stack(FK.fir_planar(xr, xi, taps, cr, ci,
                                         tile_rows=8)[:2])
        return cs.conv1d_ms(rows, taps, 1, want=want)
    finally:
        torch.backends.cudnn.allow_tf32 = keep


def main(before_dir: Path, quick: bool) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    print("torch", torch.__version__, "CUDA", torch.version.cuda)
    if not (before_dir / "fir.cu").exists():
        raise SystemExit(f"{before_dir / 'fir.cu'} missing (see the usage)")
    csrc = _build.CSRC_DIR
    sources = {"before": before_dir / "fir.cu"}
    for name, edits in ({} if quick else {**VARIANTS, **PROBES}).items():
        text = (csrc / "decim_fir.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        d = before_dir / name
        d.mkdir(exist_ok=True)
        (d / "decim_fir.cu").write_text(text)
        sources[name] = d / "decim_fir.cu"
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
    fails = []
    ptx = {k: ptxas_report(logs[k]) for k in logs}
    for k, lines in ptx.items():
        for line in lines:
            print(f"ptxas, {k}, {line}")
    spills = [x for x in ptx["package"]
              if "spill" in x and not re.search(r"\b0 bytes spill stores", x)]
    if spills or not ptx["package"]:
        fails.append(f"package kernels spill or no ptxas lines: {spills}")
    sass = {}
    for c in (0, 1):
        sass[f"package_{'complex' if c else 'real'}"] = sass_histogram(
            _build.library_path(), f"decim_fir_kernelILi1ELb{c}E")
        sass[f"before_{'complex' if c else 'real'}"] = sass_histogram(
            sources["before"].with_suffix(".so"), f"fir_kernelILb{c}E")
    for k, hist in sass.items():
        print(f"SASS, {k}:", json.dumps(hist))
    (before_dir / "k4_sass.txt").write_text(
        sass_text(_build.library_path(), "decim_fir_kernelILi1E"))
    libs = {k: ctypes.CDLL(str(src.with_suffix(".so")))
            for k, src in sources.items()}
    before = bind(libs.pop("before"), True)
    libs = {k: bind(v, False) for k, v in libs.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(18)
    rng = np.random.default_rng(18)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    def ctx():
        return normal(8, 128), normal(8, 128)

    def ctaps(T):
        return rng.normal(size=T) + 1j * rng.normal(size=T)

    mf = trx.QpskRxConfig().mf_taps
    big = (normal(1 << 25), normal(1 << 25))
    # cases: name -> (x planes, taps, ctx planes, tile_rows)
    cases = {
        "mf32_zero": (big, mf, FK.planar_ctx_zero(dev), 1024),
        "mf32_mid": (big, mf, ctx(), 1024),
        "c257": (big, ctaps(257), ctx(), 1024),
        "c1025": ((normal(1 << 23), normal(1 << 23)), ctaps(1025), ctx(),
                  1024),
        "t1": ((normal(1 << 20), normal(1 << 20)), rng.normal(size=1),
               ctx(), 1024),
        "n1024": ((normal(1024), normal(1024)), mf, ctx(), 8),
    }

    def call(case, outputs=2):
        (a, b), h, (c, e), tr = case
        return FK.fir_planar(a, b, h, c, e, tile_rows=tr)[:outputs]

    def plain(case):
        (a, b), h, (c, e), _ = case
        return FK.fir_plain(a, b, h, c, e)

    equal, errs, times = {}, {}, {}

    def same(key, a, b):
        eq = all(torch.equal(u, v) for u, v in zip(a, b))
        equal[key] = eq
        if not eq:
            fails.append(f"{key}: not bit-equal")

    n0, n2 = FK.launches, DF.launches
    for key, case in cases.items():
        got = call(case, 4)
        (a, b), _, _, _ = case
        same(f"{key}_next_ctx", got[2:], (a[-1024:].reshape(8, 128),
                                          b[-1024:].reshape(8, 128)))
        got = got[:2]
        with kernel_of(before, first=True):
            same(f"{key}_before", got, call(case))
        same(f"{key}_again", got, call(case))
        if not quick:
            for v in VARIANTS:
                with kernel_of(libs[v], **VARIANT_CONSTS.get(v, {})):
                    same(f"{key}_{v}", got, call(case))
            for pn, consts in PARTITIONS.items():
                with kernel_of(**consts):
                    same(f"{key}_{pn}", got, call(case))
        want = plain(case)
        e = cs.rel_err(torch.complex(*got), torch.complex(*want))
        errs[key] = e
        if not e <= cs.TOL_FIR:
            fails.append(f"{key}: {e} against plain")
        if not all(torch.isfinite(t).all() for t in got):
            fails.append(f"{key}: non-finite outputs")
    # two chained halves against one call
    for key in ("mf32_mid", "c257"):
        (a, b), h, (c, e), tr = cases[key]
        half = a.shape[0] // 2
        one = call(cases[key])
        ya = FK.fir_planar(a[:half], b[:half], h, c, e, tile_rows=tr)
        yb = FK.fir_planar(a[half:], b[half:], h, ya[2], ya[3], tile_rows=tr)
        same(f"{key}_chained", one, (torch.cat([ya[0], yb[0]]),
                                     torch.cat([ya[1], yb[1]])))
    torch.cuda.synchronize()
    launches = {"fir": FK.launches - n0, "decim_fir": DF.launches - n2}
    if launches["decim_fir"]:
        fails.append(f"K4 calls counted as the decimating FIR's: {launches}")
    print("against plain (relative):", json.dumps(errs))
    print("bit-equal:", json.dumps(equal))

    def bound_of(case):
        (a, _), h, _, _ = case
        n = a.numel()
        cplx = np.iscomplexobj(h) and np.any(np.imag(h))
        return cs.bound(16 * n, (8 if cplx else 4) * len(h) * n)

    for key, case in cases.items():
        t = {}
        for who in ("before", "package", "package", "before"):
            with kernel_of(before if who == "before" else None,
                           first=who == "before"):
                t.setdefault(who, []).append(cs.cuda_ms(lambda: call(case)))
        t["speedup"] = sum(t["before"]) / sum(t["package"])
        t["plain"] = cs.cuda_ms(lambda: plain(case))
        t["bound"], t["bound_by"] = bound_of(case)
        (a, b), h, (c, e), _ = case
        t["of_bound"] = t["bound"] / min(t["package"])
        t["partition"] = DF.partition(a.shape[0], 1, 1,
                                      run_blocks=FK._RUN_BLOCKS)
        t["conv1d"] = conv1d_ms(a, b, c, e, h)
        if not quick and key in TIMED_MORE:
            for v in (*VARIANTS, *PROBES):
                with kernel_of(libs[v], **VARIANT_CONSTS.get(v, {})):
                    t[v] = cs.cuda_ms(lambda: call(case))
            for pn, consts in PARTITIONS.items():
                with kernel_of(**consts):
                    t[pn] = cs.cuda_ms(lambda: call(case))
        times[key] = t
        print(f"{key} on {card}, ms:", json.dumps(t))
    load = {}
    if not quick:
        case = cases["mf32_mid"]
        load["package"] = sm_clock_under_load(lambda: call(case))
        with kernel_of(before, first=True):
            load["before"] = sm_clock_under_load(lambda: call(case))
        print("under back-to-back 32-tap calls, nvidia-smi (min, median, "
              "max):", json.dumps(load))
    print(json.dumps({"card": card, "ms": times, "errors": errs,
                      "under_load": load, "launches": launches,
                      "bit_equal_all": all(equal.values()), "sass": sass,
                      "ptxas": ptx, "fails": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--quick"]
    if len(args) != 1:
        raise SystemExit(__doc__)
    sys.exit(main(Path(args[0]), "--quick" in sys.argv[1:]))
