#!/usr/bin/env python3
"""K2's decimating-FIR kernel (``decim_fir_kernel`` behind
``kernels/decim_fir.fir_decimate_planar``, K2's entry, and
``poly_fir_planar``, K3's) against an earlier one, in one process on one
CUDA card.

    mkdir -p build/k2_before
    git show 0020f28:comms_tpu_torch/csrc/decim_fir.cu \\
        > build/k2_before/decim_fir.cu
    PYTHONPATH=.:tools python3 tools/k2_compare.py build/k2_before [--quick]

The earlier kernel (up to 0020f28: one block of up to 256 threads per
run of outputs, one output a thread) has the package's C entry with
outputs a block in place of the partition (threads a block, blocks); it
is built from the directory and swapped in under the package's wrappers,
so both run the same host code (its outputs a block chosen by its own
rule: 256, halved until its window fits).  An earlier kernel from
28f7200 on has the package's C entry and is called as the package's.  Beside it the script builds
the ``VARIANTS``, the package's ``csrc/decim_fir.cu`` with one design
choice changed (``stages1``: one window buffer, the next window copied
once the block has read the current one; ``r3``: 3 outputs a thread at
D = 4 and 5; ``r5``: 5 at D = 5), and the ``PROBES`` (one piece of work
cut, so that its time can be read off; their outputs
are wrong by design and are not checked): no window copy after a
block's first window, no im-plane chain.  It also runs the package with
other partitions (``blocks_*``; ``one_tile``: a block a tile;
``threads_64``).

It prints ptxas's lines of every build's kernels and the SASS opcode
counts of the package's and the earlier kernel at D = 4 and 5 (real
taps), then checks the package's outputs ``torch.equal`` to the earlier
kernel's, to the variants' and to the other partitions' (and the next
context the launch writes equal to each row's last samples):

- K2's entry at the band monitor's audio FIR (8 rows x 1,048,576, D = 4,
  its 32 taps) from zero and from mid-stream context;
- D = 1..8 at each D's most taps (``max_taps``), real and complex, one
  row of D x 2^20 samples, mid-stream context;
- K3's entry at N = 16,752,640, D = 5, with 63 and 641 taps;
- a 2^18-sample call (D = 4, 4 rows) and the dry run's call (one row of
  5,120 samples, D = 5, 63 taps, ``tile_rows=8``);
- two chained halves against one call (K2's shape, the 641-tap entry);

each also within ``chip_smoke.TOL_FIR`` of the plain version.  Then it
times (``chip_smoke.cuda_ms``, device time behind a spin kernel, median
of 7) earlier / package / package / earlier at every checked shape,
beside the plain version, ``F.conv1d`` with stride D over the two planes
(cuDNN, TF32 off; for real taps) and the bound; the variants, probes and
partitions at K2's and the 641-tap shapes; and reads nvidia-smi's SM clock
and power under back-to-back calls of both kernels at the 641-tap shape.

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
from comms_tpu_torch.models import fm_band_monitor as bm
from k1_compare import sass_text, sm_clock_under_load
from k7_compare import sass_histogram

K2_ROWS, K2_N = 8, 1 << 20
POLY_N = cs.POLY_N
VARIANTS = {
    "stages1": [("constexpr int kStages = 2;", "constexpr int kStages = 1;")],
    "r3": [("{1, 9, 7, 5, 5, 7, 3, 3, 3}", "{1, 9, 7, 5, 3, 3, 3, 3, 3}")],
    "r5": [("{1, 9, 7, 5, 5, 7, 3, 3, 3}", "{1, 9, 7, 5, 5, 5, 3, 3, 3}")],
}
PROBES = {
    "p_no_copy": [("      if (ahead < s.tiles) {\n        load_window",
                   "      if (ahead < 0) {\n        load_window")],
    "p_one_chain": [("    ai = fmaf(hr, xi, ai);\n  }",
                     "  }")],
}
# The wrapper's constants a variant needs (its outputs a thread).
VARIANT_CONSTS = {"r3": {"_R_OF_D": (1, 9, 7, 5, 3, 3, 3, 3, 3)},
                  "r5": {"_R_OF_D": (1, 9, 7, 5, 5, 5, 3, 3, 3)}}
PARTITIONS = {"blocks_528": {"_RUN_BLOCKS": 528},
              "blocks_1056": {"_RUN_BLOCKS": 1056},
              "blocks_1584": {"_RUN_BLOCKS": 1584},
              "blocks_4224": {"_RUN_BLOCKS": 4224},
              "one_tile": {"_RUN_BLOCKS": 1 << 30},
              "threads_64": {"_THREADS": (64,)}}


class _Swapped:
    """The package's library with another build's decimating-FIR entry."""

    def __init__(self, lib, other, earlier: bool):
        self._lib = lib
        if earlier:
            # the earlier C entry takes outputs a block (its own rule)
            # in place of threads and blocks
            def launch(*a):
                MD, D, cplx = a[7], a[8], a[9]
                k = 256
                while k > 32 and other.decim_fir_smem_bytes(
                        MD, D, k, cplx) > DF._SMEM_LIMIT:
                    k //= 2
                return other.decim_fir_launch(*a[:12], k, a[14], a[15],
                                              a[18])
            self.decim_fir_launch = launch
        else:
            self.decim_fir_launch = other.decim_fir_launch
            self.decim_fir_smem_bytes = other.decim_fir_smem_bytes

    def __getattr__(self, name):
        return getattr(self._lib, name)


def _launch_copying_ctx(xr, xi, taps, dec, ctx_r, ctx_i):
    """The wrapper's launch for the earlier kernel, which does not write
    the next context: copies of each row's last samples, as its wrapper
    made them (two more device copies a call)."""
    yr, yi, _, _ = _PKG_LAUNCH(xr, xi, taps, dec, ctx_r, ctx_i)
    L = ctx_r.shape[-1]
    return (yr, yi, xr[..., -L:].reshape(ctx_r.shape).clone(),
            xi[..., -L:].reshape(ctx_i.shape).clone())


_PKG_LAUNCH = DF._launch


@contextlib.contextmanager
def kernel_of(lib=None, earlier=False, **consts):
    """The wrappers launching ``lib``'s kernel, with module constants of
    ``kernels/decim_fir`` set from ``consts`` (the partition)."""
    pkg = _build.load()
    if earlier and lib is not None:
        consts = {**consts, "_launch": _launch_copying_ctx}
    keep = {k: getattr(DF, k) for k in consts}
    _build._lib = _Swapped(pkg, lib, earlier) if lib is not None else pkg
    for k, v in consts.items():
        setattr(DF, k, v)
    try:
        yield
    finally:
        _build._lib = pkg
        for k, v in keep.items():
            setattr(DF, k, v)


def bind(lib, earlier: bool):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.decim_fir_smem_bytes.restype = i64
    lib.decim_fir_smem_bytes.argtypes = [i32, i32, i32, i32]
    lib.decim_fir_launch.restype = i32
    lib.decim_fir_launch.argtypes = (
        [p, p, p, p, i32, p, p, i32, i32, i32, i64, i32, i32]
        + ([p, p, p] if earlier else [i32, p, p, p, p, p]))
    return lib


def ptxas_report(log: str) -> list:
    """``kernel<D, complex>: registers, stack, smem, spills`` lines of a
    ptxas log for the decimating-FIR kernels."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?decim_fir_kernel"
                      r"(I\w*?E)Ev", line)
        if m:
            name = "decim_fir_kernel" + m.group(1)
        elif name and ("Used" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                name = None
    return out


def conv1d_ms(xr, xi, cr, ci, taps, dec):
    """``F.conv1d`` with stride ``dec`` over the planes (each row its
    MD-1 context samples in front), real taps only, TF32 off; with the
    check of its output against the package's kernel."""
    md = DF._padded_taps(taps, dec)[0].shape[0]
    rows = xr.reshape(-1, xr.shape[-1])
    ctx = (cr.reshape(rows.shape[0], -1), ci.reshape(rows.shape[0], -1))
    x = torch.cat([torch.cat([ctx[0][:, -(md - 1):], rows], 1),
                   torch.cat([ctx[1][:, -(md - 1):],
                              xi.reshape(rows.shape)], 1)]) if md > 1 else \
        torch.cat([rows, xi.reshape(rows.shape)])
    keep = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = False
    try:
        y = DF._launch(xr, xi, taps, dec, cr, ci)
        want = torch.cat([y[0].reshape(rows.shape[0], -1),
                          y[1].reshape(rows.shape[0], -1)])
        h = np.zeros(md, np.float32)
        h[:len(taps)] = np.asarray(taps, np.float32)
        return cs.conv1d_ms(x, h, dec, want=want)
    finally:
        torch.backends.cudnn.allow_tf32 = keep


def main(before_dir: Path, quick: bool) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    print("torch", torch.__version__, "CUDA", torch.version.cuda)
    if not (before_dir / "decim_fir.cu").exists():
        raise SystemExit(f"{before_dir / 'decim_fir.cu'} missing (see the "
                         f"usage)")
    csrc = _build.CSRC_DIR
    sources = {"before": before_dir / "decim_fir.cu"}
    # up to 0020f28 the C entry takes outputs a block, not the partition
    earlier = "int threads, int blocks" not in sources["before"].read_text()
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
    for d in (4, 5):
        sass[f"package_D{d}"] = sass_histogram(
            _build.library_path(), f"decim_fir_kernelILi{d}ELb0E")
    sass["before"] = sass_histogram(
        sources["before"].with_suffix(".so"),
        "decim_fir_kernelILb0E" if earlier else "decim_fir_kernelILi4ELb0E")
    for k, hist in sass.items():
        print(f"SASS of decim_fir_kernel, {k}:", json.dumps(hist))
    (before_dir / "k2_sass.txt").write_text(
        sass_text(_build.library_path(), "decim_fir_kernel"))
    libs = {k: ctypes.CDLL(str(src.with_suffix(".so")))
            for k, src in sources.items()}
    before = bind(libs.pop("before"), earlier)
    libs = {k: bind(v, False) for k, v in libs.items()}

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(17)
    rng = np.random.default_rng(17)

    def normal(*shape):
        return torch.randn(*shape, generator=gen, device=dev)

    cfg = bm.BandMonitorConfig(num_channels=cs.BM_K, block=cs.BM_BLOCK)
    tile = bm._audio_tile_rows(cfg)
    W4 = cfg.audio_dec * 128
    # cases: name -> (entry, x planes, taps, dec, ctx planes, tile_rows)
    cases = {}
    xr, xi = normal(K2_ROWS, K2_N), normal(K2_ROWS, K2_N)
    z4 = torch.zeros(K2_ROWS, W4, device=dev)
    cases["k2_zero"] = ("k2", (xr, xi), cfg.audio_taps, 4, (z4, z4), tile)
    cases["k2_mid"] = ("k2", (xr, xi), cfg.audio_taps, 4,
                       (normal(K2_ROWS, W4), normal(K2_ROWS, W4)), tile)
    for d in range(1, 9):
        T = DF.max_taps(d)
        n = d << 20
        for cplx in (False, True):
            h = rng.normal(size=T)
            if cplx:
                h = h + 1j * rng.normal(size=T)
            cases[f"d{d}_{'complex' if cplx else 'real'}_{T}"] = (
                "k2", (normal(n), normal(n)), h, d,
                (normal(1, d * 128), normal(1, d * 128)), 8)
    L5 = DF.CTX_ROWS * 5 * 128
    pr, pi = normal(POLY_N), normal(POLY_N)
    pctx = (normal(L5), normal(L5))
    for T in (63, 641):
        cases[f"k3_{T}"] = ("k3", (pr, pi), rng.normal(size=T), 5, pctx, 0)
    cases["k2_2e18"] = ("k2", (normal(4, 1 << 16), normal(4, 1 << 16)),
                        cfg.audio_taps, 4, (normal(4, W4), normal(4, W4)), 8)
    cases["dryrun"] = ("k2", (normal(5120), normal(5120)),
                       np.hamming(63).astype(np.float32), 5,
                       (normal(1, 640), normal(1, 640)), 8)

    def call(case, outputs=2):
        entry, (a, b), h, d, (c, e), tr = case
        if entry == "k2":
            return DF.fir_decimate_planar(a, b, h, d, c, e,
                                          tile_rows=tr)[:outputs]
        return DF.poly_fir_planar(a, b, h, c, e, d)[:outputs]

    def plain(case):
        _, (a, b), h, d, (c, e), _ = case
        return DF.fir_decimate_plain(a, b, h, d, c, e)

    equal, errs, times = {}, {}, {}

    def same(key, a, b):
        eq = all(torch.equal(u, v) for u, v in zip(a, b))
        equal[key] = eq
        if not eq:
            fails.append(f"{key}: not bit-equal")

    n0 = DF.launches
    for key, case in cases.items():
        got = call(case)
        # the next context the launch writes: each row's last samples
        _, (a, b), _, _, (c, _), _ = case
        nxt = call(case, 4)[2:]
        L = c.shape[-1]
        same(f"{key}_next_ctx", nxt, (a[..., -L:].reshape(nxt[0].shape),
                                      b[..., -L:].reshape(nxt[1].shape)))
        with kernel_of(before, earlier=earlier):
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
    for key in ("k2_mid", "k3_641"):
        entry, (a, b), h, d, (c, e), tr = cases[key]
        half = a.shape[-1] // 2
        one = call(cases[key])
        if entry == "k2":
            ya = DF.fir_decimate_planar(a[..., :half].contiguous(),
                                        b[..., :half].contiguous(), h, d, c,
                                        e, tile_rows=tr)
            yb = DF.fir_decimate_planar(a[..., half:].contiguous(),
                                        b[..., half:].contiguous(), h, d,
                                        ya[2], ya[3], tile_rows=tr)
        else:
            step = DF.step_samples(d)
            half = half // step * step
            ya = DF.poly_fir_planar(a[:half].contiguous(),
                                    b[:half].contiguous(), h, c, e, d)
            yb = DF.poly_fir_planar(a[half:].contiguous(),
                                    b[half:].contiguous(), h, ya[2], ya[3],
                                    d)
        same(f"{key}_chained", one, (torch.cat([ya[0], yb[0]], -1),
                                     torch.cat([ya[1], yb[1]], -1)))
    torch.cuda.synchronize()
    launches = DF.launches - n0
    print("against plain (relative):", json.dumps(errs))
    print("bit-equal:", json.dumps(equal))

    def bound_of(case):
        _, (a, _), h, d, _, _ = case
        n = a.numel()
        md = DF._padded_taps(h, d)[0].shape[0]
        cplx = np.iscomplexobj(h) and np.any(np.imag(h))
        return cs.bound(8 * n + 8 * n // d,
                        (8 if cplx else 4) * md * (n // d))

    for key, case in cases.items():
        if key == "k2_zero":
            continue
        t = {}
        for who in ("before", "package", "package", "before"):
            with kernel_of(before if who == "before" else None,
                           earlier):
                t.setdefault(who, []).append(cs.cuda_ms(lambda: call(case)))
        t["speedup"] = sum(t["before"]) / sum(t["package"])
        t["plain"] = cs.cuda_ms(lambda: plain(case))
        t["bound"], t["bound_by"] = bound_of(case)
        _, (a, b), h, d, (c, e), _ = case
        rows = 1 if a.ndim == 1 else a.shape[0]
        t["partition"] = DF.partition(a.shape[-1] // d, rows, d)
        if not (np.iscomplexobj(h) and np.any(np.imag(h))):
            t["conv1d"] = conv1d_ms(a, b, c, e, h, d)
        if not quick and key in ("k2_mid", "k3_641", "k3_63"):
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
        case = cases["k3_641"]
        load["package"] = sm_clock_under_load(lambda: call(case))
        with kernel_of(before, earlier=earlier):
            load["before"] = sm_clock_under_load(lambda: call(case))
        print("under back-to-back 641-tap calls, nvidia-smi (min, median, "
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
