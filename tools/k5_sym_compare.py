#!/usr/bin/env python3
"""K5's symbol kernel (``qpsk_sym_kernel`` behind
``kernels/qpsk_sym.qpsk_symbol_gemm`` and ``qpsk_symbol_gemm_scalars``)
against an earlier one, in one process on one CUDA card.

    mkdir -p build/k5_sym_before
    git show a058f99:comms_tpu_torch/csrc/qpsk_sym.cu \\
        > build/k5_sym_before/qpsk_sym.cu
    PYTHONPATH=.:tools python3 tools/k5_sym_compare.py build/k5_sym_before \\
        [--quick]

The earlier kernel (up to a058f99: one block of 256 threads per 256
symbols) has the C entry of the package without the partition (threads
a block, blocks); it is built from the directory (``tf32x3.cuh`` from
the package where missing) and swapped in under the package's wrappers,
its panel entry with it, so both run the same host code.  Beside it the
script builds the ``VARIANTS``, the package's ``csrc/qpsk_sym.cu`` with
one design choice changed (``no_swizzle``: window quads at their own
shared address; ``stages3``: three window buffers, two copies in flight;
``r8``: 8 symbols a thread; ``lb3``: registers capped for three blocks
of 256 an SM), and the ``PROBES`` (one piece of work cut, so that its
time can be read off; their symbols are wrong by design and are not
checked): no ``sincosf``, no window copy after a block's first windows,
one FMA chain in place of four.  It also runs the package with other
partitions (``blocks_*``; ``one_tile``: a block a tile; ``threads_64``;
``threads_256_blocks_2112``, the first plan).

It prints ptxas's lines of every build's ``qpsk_sym_kernel`` and of the
panel kernels (package and earlier: they must not differ) and the SASS
opcode counts of the package's and the earlier ``qpsk_sym_kernel``, then,
on the QPSK capture of ``chip_smoke.py`` with its taps (MD = 44):

- at N = 2^25, 2^22 and 2^18, both entries, zero and mid-stream context:
  the package's symbols equal to the earlier kernel's (``torch.equal``),
  within ``chip_smoke.TOL_SYM`` of the plain version, equal to the
  variants' and the other partitions', and (traced taps at ws = 0: the
  product, de-rotated by phase0 alone) two chained half-blocks equal to
  one call; at 2^22 also MD = 4, 128 and 132 (random taps, the
  traced entry); at 2^25 and 2^22 the panels of both builds equal;
- times (``chip_smoke.cuda_ms``, device time behind a spin kernel, median
  of 7) earlier / package / package / earlier of the symbols-only call at
  every size, for both entries at 2^25, beside the bound and the plain
  version; then the variants, probes and partitions at 2^25; the served
  ``_scalars`` call with panels (halfwidth 51), earlier / package /
  package / earlier; and ``F.conv1d`` with stride 4 over the two planes
  as a 2 -> 2-channel real form of the complex taps (cuDNN, TF32 off),
  the product alone, held to the package at ws = 0;
- nvidia-smi's SM clock and power under back-to-back symbols-only calls
  of both kernels at 2^25.

``--quick`` stops at 2^22 and times there only.  The last line is the
result as JSON; the exit code is 1 if a check failed.
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
import torch.nn.functional as F

import chip_smoke as cs
from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import qpsk_sym as QS
from comms_tpu_torch.models import qpsk_rx as trx
from comms_tpu_torch.ops import interp as tinterp
from k1_compare import sass_text, sm_clock_under_load
from k7_compare import sass_histogram

SIZES = (1 << 25, 1 << 22, 1 << 18)
MDS = (4, 128, 132)
HW = 51
VARIANTS = {
    "no_swizzle": [("  return j ^ ((j >> 3) & (kSymR - 1));",
                    "  return j;")],
    "stages3": [("constexpr int kStages = 2;", "constexpr int kStages = 3;")],
    "r8": [("constexpr int kSymR = 4;", "constexpr int kSymR = 8;")],
    "lb3": [("__launch_bounds__(kSymThreadsMax, 2)",
             "__launch_bounds__(kSymThreadsMax, 3)")],
}
PROBES = {
    "p_no_sincos": [("      sincosf(ang, &sn, &cs);",
                     "      sn = __fmul_rn(ang, 1e-3f);\n"
                     "      cs = __fadd_rn(1.f, -sn);")],
    "p_no_copy": [("    if (ahead < s.tiles) {\n      load_window(",
                   "    if (ahead < 0) {\n      load_window(")],
    "p_one_chain": [("    c[1] = fmaf(", "    if (0) c[1] = fmaf("),
                    ("    c[2] = fmaf(", "    if (0) c[2] = fmaf("),
                    ("    c[3] = fmaf(", "    if (0) c[3] = fmaf(")],
}
PARTITIONS = {"blocks_1056": {"_RUN_BLOCKS": 1056},
              "blocks_2112": {"_RUN_BLOCKS": 2112},
              "one_tile": {"_RUN_BLOCKS": 1 << 30},
              "threads_64": {"_SYM_THREADS": (64,)},
              # the first plan: 256 threads, 2112 blocks
              "threads_256_blocks_2112": {"_SYM_THREADS": (256, 128, 64),
                                          "_RUN_BLOCKS": 2112}}
# The wrapper's constants a variant needs (its symbols a thread).
VARIANT_CONSTS = {"r8": {"_SYM_R": 8}}


class _Swapped:
    """The package's library with another build's symbol (and, for the
    earlier kernel, panel) entries."""

    def __init__(self, lib, other, earlier: bool):
        self._lib = lib
        if earlier:
            # the earlier C entry has no partition arguments
            def launch(*a):
                return other.qpsk_sym_launch(*a[:12], *a[14:])
            self.qpsk_sym_launch = launch
            self.qpsk_panels_launch = other.qpsk_panels_launch
        else:
            self.qpsk_sym_launch = other.qpsk_sym_launch

    def __getattr__(self, name):
        return getattr(self._lib, name)


@contextlib.contextmanager
def kernel_of(lib=None, earlier=False, **consts):
    """The wrappers launching ``lib``'s kernels, with module constants of
    ``kernels/qpsk_sym`` set from ``consts`` (the partition)."""
    pkg = _build.load()
    keep = {k: getattr(QS, k) for k in consts}
    _build._lib = _Swapped(pkg, lib, earlier) if lib is not None else pkg
    for k, v in consts.items():
        setattr(QS, k, v)
    try:
        yield
    finally:
        _build._lib = pkg
        for k, v in keep.items():
            setattr(QS, k, v)


def bind(lib, earlier: bool):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.qpsk_sym_launch.restype = i32
    lib.qpsk_sym_launch.argtypes = (
        [p, p, p, p, i32, p, p, p, p, p, p, i64]
        + ([] if earlier else [i32, i32]) + [p, p, p])
    lib.qpsk_panels_launch.restype = i32
    lib.qpsk_panels_launch.argtypes = [p, p, i64, i32, i32, p, i32, p, p]
    return lib


def ptxas_report(log: str) -> list:
    """``kernel: registers, stack, smem, spills`` lines of a ptxas log for
    the symbol and panel kernels."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(qpsk_\w+?_kernel)",
                      line)
        if m:
            name = m.group(1)
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
    if not (before_dir / "qpsk_sym.cu").exists():
        raise SystemExit(f"{before_dir / 'qpsk_sym.cu'} missing (see the "
                         f"usage)")
    csrc = _build.CSRC_DIR
    if not (before_dir / "tf32x3.cuh").exists():
        (before_dir / "tf32x3.cuh").write_text(
            (csrc / "tf32x3.cuh").read_text())
    sources = {"before": before_dir / "qpsk_sym.cu"}
    for name, edits in {**VARIANTS, **PROBES}.items():
        text = (csrc / "qpsk_sym.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        d = before_dir / name
        d.mkdir(exist_ok=True)
        (d / "qpsk_sym.cu").write_text(text)
        (d / "tf32x3.cuh").write_text((csrc / "tf32x3.cuh").read_text())
        sources[name] = d / "qpsk_sym.cu"
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
    ptx = {k: ptxas_report(logs[k]) for k in ("package", "before",
                                              *VARIANTS, *PROBES)}
    for k, lines in ptx.items():
        for line in lines:
            print(f"ptxas, {k}, {line}")
    panel_lines = {k: [x for x in ptx[k] if x.startswith("qpsk_panel")]
                   for k in ("package", "before")}
    if panel_lines["package"] != panel_lines["before"]:
        fails.append("the panel kernels' ptxas lines differ")
    if any("qpsk_sym_kernel" in x and not re.search(r"\b0 bytes spill "
                                                    r"stores", x)
           for x in ptx["package"] if "spill" in x):
        fails.append("qpsk_sym_kernel spills")
    sass = {k: sass_histogram(src, "qpsk_sym_kernel") for k, src in (
        ("package", _build.library_path()),
        ("before", sources["before"].with_suffix(".so")))}
    for k, hist in sass.items():
        print(f"SASS of qpsk_sym_kernel, {k}:", json.dumps(hist))
    (before_dir / "k5_sym_sass.txt").write_text(
        sass_text(_build.library_path(), "qpsk_sym_kernel"))
    libs = {k: ctypes.CDLL(str(src.with_suffix(".so")))
            for k, src in sources.items()}
    before = bind(libs.pop("before"), True)
    libs = {k: bind(v, False) for k, v in libs.items()}

    dev = torch.device("cuda")
    cfg = trx.QpskRxConfig()
    cs.QPSK_N = max(SIZES[1:]) if quick else max(SIZES)
    re_all, im_all, _ = cs.qpsk_capture(dev, seed=7)
    w_est = torch.tensor(0.0101, device=dev)
    lag = torch.from_numpy(tinterp.lagrange_taps(0.3).astype(
        np.float32)).to(dev)
    shift2 = torch.tensor(-1, dtype=torch.int32, device=dev)
    phase0 = 0.31
    fr, fi = trx.modulated_taps(cfg, w_est, lag, shift2)
    ws = w_est * 4
    C = int(fr.shape[0]) - 1
    sizes = [n for n in SIZES if n <= cs.QPSK_N]
    equal, errs, times = {}, {}, {}

    def entry(name, x, ctx, taps=None, hw=0):
        re_, im_ = x
        if name == "gemm":
            f_r, f_i = taps if taps is not None else (fr, fi)
            return QS.qpsk_symbol_gemm(re_, im_, f_r, f_i, ws, phase0, ctx,
                                       panels_hw=hw)
        return QS.qpsk_symbol_gemm_scalars(re_, im_, cfg.mf_taps, w_est, lag,
                                           shift2, phase0=phase0, ctx=ctx,
                                           panels_hw=hw)

    def plain(name, x, ctx, taps=None):
        f_r, f_i = taps if taps is not None else (fr, fi)
        return QS.qpsk_symbol_plain(x[0], x[1], f_r, f_i, ws, phase0, ctx)

    def same(key, a, b):
        eq = all(torch.equal(u, v) for u, v in zip(a, b))
        equal[key] = eq
        if not eq:
            fails.append(f"{key}: not bit-equal")

    for n in sizes:
        x = (re_all[:n], im_all[:n])
        ctxs = {"zero": None,
                "mid": (im_all[-C:].clone(), re_all[-C:].clone())}
        for name in ("gemm", "scalars"):
            for cn, ctx in ctxs.items():
                key = f"{name}_{cn}_{n}"
                got = entry(name, x, ctx)
                with kernel_of(before, earlier=True):
                    same(f"{key}_before", got, entry(name, x, ctx))
                same(f"{key}_again", got, entry(name, x, ctx))
                for v in VARIANTS:
                    with kernel_of(libs[v], **VARIANT_CONSTS.get(v, {})):
                        same(f"{key}_{v}", got, entry(name, x, ctx))
                for pn, consts in PARTITIONS.items():
                    with kernel_of(**consts):
                        same(f"{key}_{pn}", got, entry(name, x, ctx))
                h = n // 2
                if name == "gemm" and h % QS.IN_PER_STEP == 0:
                    # the product chained over two halves (at ws = 0 the
                    # de-rotation angle is phase0 at every symbol; tap 0,
                    # which reads one sample past a block at its last
                    # symbol, is zero at this timing shift)
                    one = QS.qpsk_symbol_gemm(x[0], x[1], fr, fi, 0.0,
                                              phase0, ctx)
                    a = QS.qpsk_symbol_gemm(x[0][:h], x[1][:h], fr, fi, 0.0,
                                            phase0, ctx)
                    b = QS.qpsk_symbol_gemm(x[0][h:], x[1][h:], fr, fi, 0.0,
                                            phase0, (x[0][h - C:h],
                                                     x[1][h - C:h]))
                    same(f"{key}_chained", one, (torch.cat([a[0], b[0]]),
                                                 torch.cat([a[1], b[1]])))
                want = plain(name, x, ctx)
                e = cs.rel_err(torch.complex(*got), torch.complex(*want))
                errs[key] = e
                if not e <= cs.TOL_SYM:
                    fails.append(f"{key}: {e} against plain")
                if not all(torch.isfinite(t).all() for t in got):
                    fails.append(f"{key}: non-finite symbols")
        if n >= 1 << 22:
            pan = QS.qpsk_panels(x[0], x[1], HW)
            with kernel_of(before, earlier=True):
                same(f"panels_{n}_before", pan[:4],
                     QS.qpsk_panels(x[0], x[1], HW)[:4])
        if n == 1 << 22:
            g = torch.Generator(device="cuda")
            g.manual_seed(3)
            for md in MDS:
                taps = tuple(torch.randn(md, generator=g, device=dev)
                             for _ in range(2))
                ctx = tuple(torch.randn(md - 1, generator=g, device=dev)
                            for _ in range(2))
                key = f"gemm_md{md}_{n}"
                got = entry("gemm", x, ctx, taps)
                with kernel_of(before, earlier=True):
                    same(f"{key}_before", got, entry("gemm", x, ctx, taps))
                e = cs.rel_err(torch.complex(*got),
                               torch.complex(*plain("gemm", x, ctx, taps)))
                errs[key] = e
                if not e <= cs.TOL_SYM:
                    fails.append(f"{key}: {e} against plain")
    torch.cuda.synchronize()
    print("against plain (relative):", json.dumps(errs))
    print("bit-equal to the package:", json.dumps(equal))

    ctx_mid = (im_all[-C:].clone(), re_all[-C:].clone())
    for n in ([1 << 22] if quick else sizes):
        x = (re_all[:n], im_all[:n])
        names = ("gemm", "scalars") if n == cs.QPSK_N else ("gemm",)
        for name in names:
            t = {}
            for who in ("before", "package", "package", "before"):
                with kernel_of(before if who == "before" else None, True):
                    t.setdefault(who, []).append(
                        cs.cuda_ms(lambda: entry(name, x, ctx_mid)))
            t["speedup"] = sum(t["before"]) / sum(t["package"])
            t["plain"] = cs.cuda_ms(lambda: plain(name, x, ctx_mid))
            t["bound"] = cs.bound(8 * n + 2 * n, 2 * 44 * n)[0]
            t["partition"] = QS.partition(n)
            if name == "gemm" and n == cs.QPSK_N:
                for v in (*VARIANTS, *PROBES):
                    with kernel_of(libs[v], **VARIANT_CONSTS.get(v, {})):
                        t[v] = cs.cuda_ms(lambda: entry(name, x, ctx_mid))
                for pn, consts in PARTITIONS.items():
                    with kernel_of(**consts):
                        t[pn] = cs.cuda_ms(lambda: entry(name, x, ctx_mid))
            times[f"{name}_{n}"] = t
            print(f"symbols only, {name}, N={n} on {card}, ms:",
                  json.dumps(t))
    n = cs.QPSK_N
    x = (re_all[:n], im_all[:n])
    t = {}
    for who in ("before", "package", "package", "before"):
        with kernel_of(before if who == "before" else None, True):
            t.setdefault(who, []).append(cs.cuda_ms(
                lambda: entry("scalars", x, ctx_mid, hw=HW)))
    times[f"served_scalars_panels_{n}"] = t
    print(f"the served _scalars call with panels (hw {HW}), N={n} on "
          f"{card}, ms:", json.dumps(t))

    # the product alone: F.conv1d, stride 4, [re, im] -> [re, im] with the
    # real form of the complex taps, on planes packed beforehand (the
    # context in front, 4 zeros behind); at ws = 0 the kernel's symbols
    # are this product (sincos(0) = (0, 1))
    md = int(fr.shape[0])
    xp = torch.cat([torch.stack(ctx_mid), torch.stack(x),
                    torch.zeros(2, 4, device=dev)], dim=1)[None]
    kr, ki = fr.flip(0), fi.flip(0)
    wgt = torch.stack([torch.stack([kr, -ki]), torch.stack([ki, kr])])
    keep = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = F.conv1d(xp, wgt, stride=4)[0, :, 1:]
        k0 = QS.qpsk_symbol_gemm(x[0], x[1], fr, fi, 0.0, 0.0, ctx_mid)
        e_conv = cs.rel_err(torch.complex(y[0], y[1]), torch.complex(*k0))
        conv_ms = cs.cuda_ms(lambda: F.conv1d(xp, wgt, stride=4))
    finally:
        torch.backends.cudnn.allow_tf32 = keep
    print(f"F.conv1d (stride 4, 2 -> 2 channels, {md} taps, TF32 off) at "
          f"N={n} on {card}: {conv_ms:.4f} ms; against the kernel at ws = 0 "
          f"{e_conv:.3g} relative")
    if not e_conv <= cs.TOL_SYM:
        fails.append(f"F.conv1d against the kernel at ws = 0: {e_conv}")
    load = {}
    if not quick:
        load = {who: sm_clock_under_load(
            lambda: entry("gemm", x, ctx_mid)) for who in ("package",)}
        with kernel_of(before, earlier=True):
            load["before"] = sm_clock_under_load(
                lambda: entry("gemm", x, ctx_mid))
        print(f"under back-to-back symbols-only calls at N={n}, nvidia-smi "
              f"(min, median, max):", json.dumps(load))
    print(json.dumps({"card": card, "ms": times, "conv1d_ms": conv_ms,
                      "errors": errs, "under_load": load,
                      "bit_equal_all": all(equal.values()), "sass": sass,
                      "ptxas": ptx, "fails": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    args = [a for a in sys.argv[1:] if a != "--quick"]
    if len(args) != 1:
        raise SystemExit(__doc__)
    sys.exit(main(Path(args[0]), "--quick" in sys.argv[1:]))
