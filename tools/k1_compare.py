#!/usr/bin/env python3
"""K1 (the fused FM chain, ``kernels/fm_chain.fm_chain_fused``) against an
earlier K1, in one process on one CUDA card.

    mkdir -p build/k1_before
    git show <rev>:comms_tpu_torch/csrc/fm_chain.cu \\
        > build/k1_before/fm_chain.cu
    PYTHONPATH=. python3 tools/k1_compare.py build/k1_before

The earlier K1 has the same C entry (``fm_chain_launch``), so each build
is loaded with ctypes and called with the wrapper's arguments.  Beside
it the script builds four ``VARIANTS`` (the earlier K1 at 256 threads a
block, and the package's ``csrc/fm_chain.cu`` with one design choice
undone each: a 256-entry shared table of the IEEE quotients instead of
the division-free conversion, the u8 window loaded when its tile starts
instead of copied ahead, the 256-output tiles at every size) and
``PROBES``, the package's kernel with the work after one stage cut, so
that each stage's time can be read off (their audio is wrong by design
and is not checked).

It builds everything (nvcc for sm_90a, in parallel, into the earlier
K1's directory; ``atan2_poly.cuh`` from the package), prints ptxas's
registers and spills of each build's FM kernels and the SASS opcode
counts of the package's and the earlier kernels (``cuobjdump``; the
package's whole FM SASS goes to ``k1_sass.txt`` in the earlier K1's
directory), then, on
a station-like FM capture and on white noise, from zero and from
mid-stream context, at N = 102,400 (the block quantum), 3,276,800 (one
of 8 shards of the wideband block) and 26,214,400 (the wideband block):

- checks the package's audio equal to the earlier K1's and to each
  variant's (``torch.equal``), its repeats equal (the mid-stream repeat
  from planes that start off a 4-byte boundary), and its error against
  the plain version on the capture within ``chip_smoke.TOL_KERNEL``; on
  white noise it counts the outputs beyond ``chip_smoke.TOL_NOISE``
  (atan2 branch-cut flips) without failing on them;
- times (device time as ``chip_smoke.cuda_ms`` measures it) earlier /
  package / package / earlier on the capture from mid-stream context,
  then each variant and probe, and samples nvidia-smi's SM clock and
  power draw under back-to-back calls of each kernel at 26,214,400;
- serves the FM block step (``make_fused_block_fn``) at 26,214,400 from
  device-resident blocks through ``StreamRunner``, earlier / package /
  package / earlier, with the earlier kernel swapped in under the
  wrapper: Msps, and from ``torch.profiler`` the device's busy time a
  block and K1's share of it.

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

import torch

import chip_smoke as cs
from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import fm_chain as K
from comms_tpu_torch.models import fm_receiver as fm
from comms_tpu_torch.runtime import StreamRunner
from k6_compare import ptxas_lines
from k7_compare import sass_histogram

SIZES = (102_400, 3_276_800, 26_214_400)
SERVE_BLOCKS, SERVE_WARMUP = 8, 3
VARIANTS = {
    "before_256_threads": [("constexpr int kThreads = 128;",
                            "constexpr int kThreads = 256;")],
    "table": [("  const int tid = threadIdx.x;\n",
               "  const int tid = threadIdx.x;\n"
               "  __shared__ float s_tab[256];\n"
               "  for (int u = tid; u < 256; u += T::kThreads) {\n"
               "    s_tab[u] = convert(static_cast<float>(u));\n"
               "  }\n"
               "  __syncthreads();\n"),
              ("convert4(b);",
               "make_float4(s_tab[b & 255], s_tab[(b >> 8) & 255],"
               " s_tab[(b >> 16) & 255], s_tab[b >> 24]);")],
    "no_prefetch": [
        ("  if (staged<T>(window_start<T>(tile), n_in, aligned)) {\n"
         "    stage_window<T>(s_u8, re, im, window_start<T>(tile));\n"
         "  }\n", ""),
        ('    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n',
         "    if (staged<T>(xa, n_in, aligned)) "
         "stage_window<T>(s_u8, re, im, xa);\n"
         '    asm volatile("cp.async.wait_group 0;\\n" ::: "memory");\n'),
        ("    if (next < tiles && staged<T>(window_start<T>(next), n_in, "
         "aligned)) {\n"
         "      stage_window<T>(s_u8, re, im, window_start<T>(next));\n"
         "    }\n", "")],
    "big_tiles_always": [("kSmallTilesBelow = 132;",
                          "kSmallTilesBelow = 0;")],
}
# Each skips the rest of a tile after one stage (writing one shared value
# a thread, so that the stage is not optimised away), or cuts the atan2.
_STOP = ("    if (n_in > 0) {{ audio[f0 + tid % T::A] = {}; continue; }}\n")
PROBES = {
    "p_convert_only": [("    // Stage 1: mid[m0 + i]",
                        _STOP.format("s_x[tid]")
                        + "    // Stage 1: mid[m0 + i]")],
    "p_to_stage1": [("    // Demod: d[j] from mid",
                     _STOP.format("s_m[tid]") + "    // Demod: d[j] from mid")],
    "p_no_atan2": [("  return atan2_poly(zim, zre);", "  return zim + zre;")],
}


class _Swapped:
    """The package's library with another build's ``fm_chain_launch``."""

    def __init__(self, lib, fm_lib):
        self._lib, self.fm_chain_launch = lib, fm_lib.fm_chain_launch

    def __getattr__(self, name):
        return getattr(self._lib, name)


@contextlib.contextmanager
def kernel_of(lib):
    """The wrapper (and so the model) launching ``lib``'s K1."""
    pkg = _build.load()
    _build._lib = _Swapped(pkg, lib) if lib is not None else pkg
    try:
        yield
    finally:
        _build._lib = pkg


def bind(lib):
    p, i64 = ctypes.c_void_p, ctypes.c_int64
    lib.fm_chain_launch.restype = ctypes.c_int
    lib.fm_chain_launch.argtypes = [p, p, p, p, p, p, p, p, p, i64, p]
    return lib


def serve_fm(blocks, card: str) -> dict:
    """Served FM Msps over device-resident blocks, then one profiled run
    of SERVE_BLOCKS: device busy ms a block, K1's device ms a block."""
    from torch.profiler import ProfilerActivity, profile

    cfg = fm.FmReceiverConfig(block=blocks[0][0].shape[0])
    step = fm.make_fused_block_fn(cfg)

    def run(n):
        torch.cuda.synchronize()
        runner = StreamRunner(
            lambda s, x: step(s, *x), fm.fused_init_state("cuda"),
            (blocks[i % len(blocks)] for i in range(n)), sink=lambda a: None,
            samples_of=lambda x: x[0].shape[0], depth=cs.SERVE_DEPTH,
            device="cuda")
        return runner.run().msps

    run(SERVE_WARMUP)
    msps = run(SERVE_BLOCKS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        run(SERVE_BLOCKS)
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    ops = [e for e in prof.events()
           if e.device_type == torch.autograd.DeviceType.CUDA
           and not getattr(e, "is_user_annotation", False)]
    if not ops:
        return {"msps": msps, "busy": "not measured"}
    busy = cs.busy_ms(ops, min(e.time_range.start for e in ops),
                      max(e.time_range.end for e in ops))
    k1 = sum(e.time_range.elapsed_us() for e in ops
             if "fm_chain_kernel" in e.name) / 1e3
    return {"msps": msps, "busy_ms_per_block": busy / SERVE_BLOCKS,
            "k1_ms_per_block": k1 / SERVE_BLOCKS,
            "wall_ms_per_block": wall / SERVE_BLOCKS,
            "busy_share": busy / wall}


def sm_clock_under_load(fn, seconds: float = 1.5) -> dict:
    """nvidia-smi's SM clock (MHz) and power draw (W), sampled every 100
    ms while ``fn`` runs back to back: their medians and ranges."""
    import statistics

    smi = subprocess.Popen(
        ["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
         "--format=csv,noheader,nounits", "-lms", "100"],
        stdout=subprocess.PIPE, text=True)
    t0 = time.time()
    while time.time() - t0 < seconds:
        for _ in range(100):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    rows = [[float(v) for v in line.split(",")]
            for line in smi.communicate()[0].split("\n") if line.strip()]
    rows = rows[2:-1] or rows          # drop the ramp and the tail
    out = {}
    for k, col in (("sm_mhz", 0), ("power_w", 1)):
        vals = [r[col] for r in rows]
        out[k] = [min(vals), statistics.median(vals), max(vals)]
    return out


def sass_text(lib: Path, kernel: str) -> str:
    """The SASS of the functions whose mangled name holds ``kernel``."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return ""
    keep, out = False, []
    for line in subprocess.run([str(tool), "-sass", str(lib)],
                               capture_output=True, text=True).stdout.split(
                                   "\n"):
        if "Function :" in line:
            keep = kernel in line
        if keep:
            out.append(line)
    return "\n".join(out)


def main(before_dir: Path) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    print("torch", torch.__version__, "CUDA", torch.version.cuda)
    csrc = _build.CSRC_DIR
    header = (csrc / "atan2_poly.cuh").read_text()
    (before_dir / "atan2_poly.cuh").write_text(header)
    sources = {"before": before_dir / "fm_chain.cu"}
    for name, edits in {**VARIANTS, **PROBES}.items():
        src = sources["before"] if name.startswith("before") else (
            csrc / "fm_chain.cu")
        text = src.read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in {src}")
            text = text.replace(old, new)
        d = before_dir / name
        d.mkdir(exist_ok=True)
        (d / "fm_chain.cu").write_text(text)
        (d / "atan2_poly.cuh").write_text(header)
        sources[name] = d / "fm_chain.cu"
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
    cs.print_ptxas_kernels(_build, ("fm_chain_kernel",))
    for k, log in logs.items():
        for line in ptxas_lines(log, r"fm_chain_kernel"):
            tile = re.search(r"TileI((?:Li\d+E)+)E", line)
            name = ("fm_chain_kernel<" + ", ".join(
                re.findall(r"\d+", tile[1])) + ">" if tile else
                "fm_chain_kernel")
            print(f"ptxas, {k}, {name}:", line.split(": ", 1)[1])
    sass = {f"package_{t}": sass_histogram(_build.library_path(),
                                           f"TileILi{t}E")
            for t in (256, 64)}
    sass["before"] = sass_histogram(sources["before"].with_suffix(".so"),
                                    "fm_chain_kernel")
    for k, h in sass.items():
        print(f"SASS of fm_chain_kernel, {k}:", json.dumps(h))
    (before_dir / "k1_sass.txt").write_text(
        sass_text(_build.library_path(), "fm_chain_kernel"))
    libs = {k: bind(ctypes.CDLL(str(src.with_suffix(".so"))))
            for k, src in sources.items()}

    def other(k, xr, xi, ctx):
        with kernel_of(libs[k]):
            return K.fm_chain_fused(xr, xi, ctx, taps, taps)

    taps = fm.FM_LPF_TAPS
    tail = fm.FUSED_TAIL_SAMPLES
    n_max = max(SIZES)
    iq, _ = cs.synth_capture(tail + n_max, seed=3)
    cap = torch.from_numpy(iq.T.copy()).cuda()
    g = torch.Generator(device="cuda")
    g.manual_seed(5)
    noise = torch.randint(0, 256, (2, tail + n_max), generator=g,
                          device="cuda", dtype=torch.uint8)
    fails, equal, errs, flips, times = [], {}, {}, {}, {}
    for n in SIZES:
        for src_name, src in (("capture", cap), ("noise", noise)):
            for start in ("zero", "mid_stream"):
                key = f"{n}_{src_name}_{start}"
                if start == "zero":
                    xr, xi = src[0, :n].clone(), src[1, :n].clone()
                    ctx = K.zero_ctx("cuda")
                else:
                    # views 25,669 bytes into the planes: read a byte at
                    # a time; their copies are aligned.
                    view = (src[0, tail:tail + n], src[1, tail:tail + n])
                    xr, xi = view[0].clone(), view[1].clone()
                    ctx = fm.fused_ctx_from_raw_tail(src[0, :tail],
                                                     src[1, :tail])
                got = K.fm_chain_fused(xr, xi, ctx, taps, taps)
                again = (K.fm_chain_fused(*view, ctx, taps, taps)
                         if start == "mid_stream" else
                         K.fm_chain_fused(xr, xi, ctx, taps, taps))
                plain = K.fm_chain_plain(xr, xi, ctx, taps, taps)
                errs[key] = cs.max_err(got, plain)
                # On white noise a phase step can sit at the atan2 branch
                # cut, where the plain version's summation order may land
                # on the other side (a 2 pi |h2| jump in up to 13
                # outputs): counted, not failed.  The capture's steps stay
                # far from it.
                if src_name == "noise":
                    flips[key] = int(((got - plain).abs()
                                      > cs.TOL_NOISE).sum())
                elif not errs[key] <= cs.TOL_KERNEL:
                    fails.append(f"{key}: {errs[key]} against plain")
                if not torch.equal(got, again):
                    fails.append(f"{key}: repeat (unaligned view from "
                                 f"mid-stream) not bit-equal")
                for k in (k for k in libs if k not in PROBES):
                    same = torch.equal(other(k, xr, xi, ctx), got)
                    equal[f"{key}_{k}"] = same
                    if not same:
                        fails.append(f"{key}: {k} not bit-equal")
        xr = cap[0, tail:tail + n].clone()
        xi = cap[1, tail:tail + n].clone()
        ctx = fm.fused_ctx_from_raw_tail(cap[0, :tail], cap[1, :tail])
        t = {}
        for who in ("before", "package", "package", "before"):
            fn = ((lambda: K.fm_chain_fused(xr, xi, ctx, taps, taps))
                  if who == "package" else
                  (lambda: other("before", xr, xi, ctx)))
            t.setdefault(who, []).append(cs.cuda_ms(fn))
        for k in (*VARIANTS, *PROBES):
            t[k] = cs.cuda_ms(lambda: other(k, xr, xi, ctx))
        t["speedup"] = (sum(t["before"]) / sum(t["package"]))
        t["bound"] = cs.bound(2 * n + 4 * (n // 25),
                              (n // 5) * (4 * 63 + 46)
                              + (n // 25) * 2 * 63)[0]
        times[n] = t
        print(f"N={n} on {card}, ms:", json.dumps(t))
    xr, xi = cap[0, tail:].clone(), cap[1, tail:].clone()
    ctx = fm.fused_ctx_from_raw_tail(cap[0, :tail], cap[1, :tail])
    load = {who: sm_clock_under_load(fn) for who, fn in (
        ("package", lambda: K.fm_chain_fused(xr, xi, ctx, taps, taps)),
        ("before", lambda: other("before", xr, xi, ctx)))}
    print(f"under back-to-back calls at {n_max}, nvidia-smi (min, median, "
          f"max):", json.dumps(load))
    print("kernel vs plain max abs err:", json.dumps(errs))
    print(f"noise outputs beyond {cs.TOL_NOISE} of plain:", json.dumps(flips))
    print("bit-equal to the package:", json.dumps(equal))

    blocks = [(cap[0, b:b + n_max].clone(), cap[1, b:b + n_max].clone())
              for b in (0, tail)]
    served = {}
    for who in ("before", "package", "package", "before"):
        with kernel_of(libs["before"] if who == "before" else None):
            served.setdefault(who, []).append(serve_fm(blocks, card))
    print(f"served FM at {n_max} on {card}:", json.dumps(served))
    print(json.dumps({"card": card, "ms": times, "errors": errs,
                      "noise_flips": flips, "under_load": load,
                      "bit_equal": equal, "served": served,
                      "sass": sass, "fails": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
