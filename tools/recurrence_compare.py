#!/usr/bin/env python3
"""The recurrence kernels (``csrc/recurrence.cu``: the Costas loop and the
AGC scan, B streams a launch, one lane a stream) against the parent's
(0474b6c: one thread walking one stream, its wrapper launching once a
stream), with the dependent chain's measured floor and a ``clock64()``
split of a step, in one process on one CUDA card.

    mkdir -p build/recurrence_before
    git show 0474b6c:comms_tpu_torch/csrc/recurrence.cu > build/recurrence_before/recurrence.cu
    git show 0474b6c:comms_tpu_torch/kernels/recurrence.py > build/recurrence_before/recurrence.py
    PYTHONPATH=.:tools python3 tools/recurrence_compare.py build/recurrence_before [out_dir]

In a git checkout the script extracts the two files itself when they are
missing.  It builds, one nvcc each and all at once: the parent's source;
the package's library (``_build.load``); the ``VARIANTS``, text edits of
the package's source run under the package's wrapper; and the probe
(``recurrence_floor``: the package's step functors on register-resident
data, the chain-only and the split kernels).

It prints ptxas's lines (registers, stack frame, spills) of the parent's,
the package's and the probe's kernels, the chain floor, the clock64()
split and the chain-only loop's SASS instructions a step (static, and
the fewest an iteration can issue; the SASS goes to ``out_dir``), then
checks: the package's kernels against the batched plain versions bit for
bit (33 streams), the parent's against the single-stream plain versions,
each variant against the package's.  Then it times
(``chip_smoke.cuda_ms``: device time behind a spin kernel) parent /
package / package / parent at 2,048 and 2^20 symbols and 4,096 and
262,144 samples, the package's kernel and the variants at B = 1, 32, 512
and 16,896 streams, and the parent under vmap at 32 streams (a launch a
stream), each beside the bound (``recurrence_floor.bound_ms``: the
largest of the chain floor x n, 16 bytes a step a stream over 3.35 TB/s,
and the step's fewest SASS instructions over the card's issue rate).

The last line is the result as JSON; the exit code is 1 if a check
failed.
"""

from __future__ import annotations

import contextlib
import json
import subprocess
import sys
import time
import types
from pathlib import Path

import numpy as np
import torch

import recurrence_floor as RF
from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import recurrence as R

PARENT = "0474b6c"
FILES = {"recurrence.cu": "comms_tpu_torch/csrc/recurrence.cu",
         "recurrence.py": "comms_tpu_torch/kernels/recurrence.py"}
REPS = 9
COSTAS_N, COSTAS_LONG = 2048, 1 << 20
AGC_N, AGC_LONG = 4096, 262_144
STREAMS = (1, 32, 512, 16_896)
CHECK_STREAMS = 33
ALPHA, BETA = RF.ALPHA, RF.BETA
AGC_TARGET, AGC_RATE = RF.AGC_TARGET, RF.AGC_RATE
VARIANTS = {
    "unroll1": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 1;")],
    "unroll2": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 2;")],
    "unroll8": [("constexpr int kUnroll = 4;", "constexpr int kUnroll = 8;")],
}


def card_name() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()


def bind_parent(lib):
    import ctypes
    p, i32, i64, f32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_float)
    lib.costas_loop_launch.restype = i32
    lib.costas_loop_launch.argtypes = [p, p, i64, i64, p, p, i32, f32, f32,
                                       p, p, i64, p, p, p]
    lib.agc_scan_launch.restype = i32
    lib.agc_scan_launch.argtypes = [p, p, i64, i64, p, f32, f32, p, p, i64,
                                    p, p]
    return lib


def parent_module(before_dir: Path, lib):
    """The parent's wrapper module (its own file, its ops renamed so they
    do not clash with the package's), loading ``lib``."""
    text = (before_dir / "recurrence.py").read_text().replace(
        "comms_tpu_torch::", "recurrence_parent::")
    mod = types.ModuleType("recurrence_parent")
    exec(compile(text, str(before_dir / "recurrence.py"), "exec"),
         mod.__dict__)
    mod._build = types.SimpleNamespace(load=lambda: lib,
                                       per_slice_vmap=_build.per_slice_vmap)
    return mod


@contextlib.contextmanager
def package_on(lib):
    """The package's wrappers launching ``lib``'s kernels."""
    saved = R._build
    R._build = types.SimpleNamespace(load=lambda: lib)
    try:
        yield
    finally:
        R._build = saved


def extract_parent(before_dir: Path) -> None:
    before_dir.mkdir(parents=True, exist_ok=True)
    for name, path in FILES.items():
        if not (before_dir / name).exists():
            text = subprocess.run(["git", "show", f"{PARENT}:{path}"],
                                  capture_output=True, text=True)
            if text.returncode:
                raise SystemExit(f"{before_dir / name} missing and git "
                                 f"show failed (see the usage)")
            (before_dir / name).write_text(text.stdout)


def symbols(B: int, n: int, seed: int, dev):
    """[B, n] locked QPSK symbol planes (chip_smoke.locked_symbols)."""
    import chip_smoke as cs
    x = cs.locked_symbols(B * n, seed, dev).reshape(B, n)
    return x.real.contiguous(), x.imag.contiguous()


def samples(B: int, n: int, seed: int, dev):
    """[B, n] AGC input planes: a step from 0.1 to 2.0 halfway, a tone,
    noise of sigma 0.01 (chip_smoke phase 20c's, a seed a stream)."""
    rng = np.random.default_rng(seed)
    k = np.arange(n)
    amp = np.where(k < n // 2, 0.1, 2.0)
    x = (amp * np.exp(1j * (0.3 * k + rng.uniform(0, 6.3, (B, 1))))
         + 0.01 * rng.normal(size=(B, n)))
    x = torch.from_numpy(x.astype(np.complex64)).to(dev)
    return x.real.contiguous(), x.imag.contiguous()


def same(got, want) -> bool:
    return all(torch.equal(g, w) for g, w in zip(got, want))


def main(before_dir: Path, out_dir: Path) -> int:
    import chip_smoke as cs

    card = card_name()
    print(card)
    print("torch", torch.__version__, "CUDA", torch.version.cuda)
    dev = torch.device("cuda")
    extract_parent(before_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    sources = {"parent": before_dir / "recurrence.cu"}
    for name, edits in VARIANTS.items():
        text = (_build.CSRC_DIR / "recurrence.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        d = before_dir / name
        d.mkdir(exist_ok=True)
        (d / "recurrence.cu").write_text(text)
        sources[name] = d / "recurrence.cu"
    t0 = time.time()
    procs = {k: RF.nvcc(src) for k, src in sources.items()}
    probe = RF.start_probe(before_dir / "probe")
    _build.load()
    logs = RF.finish(procs)
    pkg_log = Path(f"{_build.library_path()}.log").read_text()
    print(f"built in {time.time() - t0:.1f} s")
    for name, log in (("parent", logs["parent"]), ("package", pkg_log),
                      *((k, logs[k]) for k in VARIANTS)):
        for line in RF.ptxas_lines(log):
            print(f"ptxas {name} {line}")
    floor = RF.chain_floor(dev, probe, out_dir)
    for line in floor["ptxas"]:
        print(f"ptxas probe {line}")
    for k in ("costas", "agc"):
        f = floor[k]
        print(f"{k} chain-only on {card}: {f['cycles_a_step']:.1f} cycles, "
              f"{f['ns_a_step']:.2f} ns a step ({f['ghz']:.3f} GHz); SASS a "
              f"step {f['sass_a_step']} in the loop's span, "
              f"{f['sass_fewest_a_step']} the fewest an iteration issues: "
              f"issue term {f['issue_ns_a_stream_step']:.5f} ns a "
              f"stream-step; "
              f"clock64 split "
              f"{json.dumps({p: round(v, 1) for p, v in f['split_cycles'].items()})}"
              f" (sum {f['split_sum']:.1f} cycles)")

    import ctypes
    parent = parent_module(before_dir, bind_parent(
        ctypes.CDLL(str(sources["parent"].with_suffix(".so")))))
    variants = {}
    for k in VARIANTS:
        lib = ctypes.CDLL(str(sources[k].with_suffix(".so")))
        _build.bind_recurrence(lib)
        variants[k] = lib

    failed = []
    # ---- checks
    xr, xi = symbols(CHECK_STREAMS, COSTAS_N, 7, dev)
    ph0 = torch.linspace(-0.05, 0.05, CHECK_STREAMS, device=dev)
    fr0 = torch.full((CHECK_STREAMS,), -2e-4, device=dev)
    want = R.costas_loop_batched_plain(xr, xi, ph0, fr0, ALPHA, BETA)
    got = R.costas_loop_batched(xr, xi, ph0, fr0, ALPHA, BETA)
    ok = same(got, want)
    print(f"costas_loop_batched, {CHECK_STREAMS} x {COSTAS_N}: against the "
          f"batched plain {'bit for bit' if ok else 'NOT bit-equal'}")
    if not ok:
        failed.append("costas package")
    for k, lib in variants.items():
        with package_on(lib):
            v = R.costas_loop_batched(xr, xi, ph0, fr0, ALPHA, BETA)
        if not same(v, got):
            failed.append(f"costas {k}")
    p1 = parent.costas_loop(xr[0], xi[0], ph0[0], fr0[0], ALPHA, BETA)
    if not same(p1, (want[0][0], want[1][0], want[2][0], want[3][0])):
        failed.append("costas parent")
    ar, ai = samples(CHECK_STREAMS, AGC_N, 8, dev)
    g0 = torch.linspace(0.5, 2.0, CHECK_STREAMS, device=dev)
    want = R.agc_scan_batched_plain(ar, ai, g0, AGC_TARGET, AGC_RATE)
    got = R.agc_scan_batched(ar, ai, g0, AGC_TARGET, AGC_RATE)
    ok = same(got, want)
    print(f"agc_scan_batched, {CHECK_STREAMS} x {AGC_N}: against the "
          f"batched plain {'bit for bit' if ok else 'NOT bit-equal'}")
    if not ok:
        failed.append("agc package")
    for k, lib in variants.items():
        with package_on(lib):
            v = R.agc_scan_batched(ar, ai, g0, AGC_TARGET, AGC_RATE)
        if not same(v, got):
            failed.append(f"agc {k}")
    p1 = parent.agc_scan(ar[0], ai[0], g0[0], AGC_TARGET, AGC_RATE)
    if not same(p1, (want[0][0], want[1][0], want[2][0])):
        failed.append("agc parent")
    print(f"checks: {'all passed' if not failed else failed}")

    # ---- parent / package / package / parent, one stream
    res = {"card": card, "floor": floor, "failed": failed, "single": {},
           "streams": {}}
    z = torch.zeros((), device=dev)
    g1 = torch.ones((), device=dev)
    for name, n, reps, make, call_p, call_n in (
            ("costas", COSTAS_N, REPS, symbols,
             lambda x: parent.costas_loop(*x, z, z, ALPHA, BETA),
             lambda x: R.costas_loop(*x, z, z, ALPHA, BETA)),
            ("costas", COSTAS_LONG, 3, symbols,
             lambda x: parent.costas_loop(*x, z, z, ALPHA, BETA),
             lambda x: R.costas_loop(*x, z, z, ALPHA, BETA)),
            ("agc", AGC_N, REPS, samples,
             lambda x: parent.agc_scan(*x, g1, AGC_TARGET, AGC_RATE),
             lambda x: R.agc_scan(*x, g1, AGC_TARGET, AGC_RATE)),
            ("agc", AGC_LONG, 3, samples,
             lambda x: parent.agc_scan(*x, g1, AGC_TARGET, AGC_RATE),
             lambda x: R.agc_scan(*x, g1, AGC_TARGET, AGC_RATE))):
        xr, xi = make(1, n, 3, dev)
        x = (xr[0], xi[0])
        t = {"parent": [], "package": []}
        for who in ("parent", "package", "package", "parent"):
            fn = call_p if who == "parent" else call_n
            t[who].append(cs.cuda_ms(lambda: fn(x), reps=reps, warmup=1))
        b = RF.bound_ms(floor[name], 1, n)
        row = {"n": n, "parent_ms": t["parent"], "ms": t["package"],
               "ns_a_step": 1e6 * min(t["package"]) / n,
               "parent_ns_a_step": 1e6 * min(t["parent"]) / n,
               "floor_ns_a_step": floor[name]["ns_a_step"], **b}
        res["single"][f"{name}_{n}"] = row
        print(f"{name} at {n} on {card}: parent {t['parent']} ms, package "
              f"{t['package']} ms: {row['ns_a_step']:.1f} ns a step (was "
              f"{row['parent_ns_a_step']:.1f}), chain floor "
              f"{row['floor_ns_a_step']:.1f}; bound {b['bound_ms']:.4f} ms "
              f"({b['bound_by']})")

    # ---- B streams a launch: the package's kernel and the variants
    for name, n, make, call in (
            ("costas", COSTAS_N, symbols,
             lambda x, s: R.costas_loop_batched(*x, s, s, ALPHA, BETA)),
            ("agc", AGC_N, samples,
             lambda x, s: R.agc_scan_batched(*x, s, AGC_TARGET,
                                             AGC_RATE))):
        for B in STREAMS:
            x = make(B, n, 5, dev)
            s = torch.zeros(B, device=dev) + (name == "agc")
            row = {"B": B, "n": n,
                   "ms": cs.cuda_ms(lambda: call(x, s), reps=REPS)}
            for k, lib in variants.items():
                with package_on(lib):
                    row[f"{k}_ms"] = cs.cuda_ms(lambda: call(x, s),
                                                reps=REPS)
            b = RF.bound_ms(floor[name], B, n)
            row.update(b)
            row["ns_a_step"] = 1e6 * row["ms"] / n
            row["msteps_a_s"] = B * n / row["ms"] / 1e3
            res["streams"][f"{name}_{B}"] = row
            print(f"{name}, {B} streams x {n} on {card}: {row['ms']:.4f} ms "
                  f"({row['ns_a_step']:.1f} ns a step a stream, "
                  f"{row['msteps_a_s']:.1f} M steps/s); "
                  + ", ".join(f"{k} {row[f'{k}_ms']:.4f}" for k in VARIANTS)
                  + f"; bound {b['bound_ms']:.4f} ms ({b['bound_by']}: "
                  f"chain {b['chain_ms']:.4f}, bytes {b['bytes_ms']:.4f}, "
                  f"issue {b['issue_ms']:.4f})")
            del x
    # the parent under vmap: a launch a stream
    B = STREAMS[1]
    x = symbols(B, COSTAS_N, 5, dev)
    s = torch.zeros(B, device=dev)
    vm = torch.func.vmap(lambda a, b, p, f: parent.costas_loop(
        a, b, p, f, ALPHA, BETA))
    res["parent_vmap_32_ms"] = cs.cuda_ms(lambda: vm(*x, s, s), reps=3)
    vm_new = torch.func.vmap(lambda a, b, p, f: R.costas_loop(
        a, b, p, f, ALPHA, BETA))
    n0 = R.launches["costas_loop"]
    vm_new(*x, s, s)
    res["package_vmap_32_launches"] = R.launches["costas_loop"] - n0
    res["package_vmap_32_ms"] = cs.cuda_ms(lambda: vm_new(*x, s, s), reps=REPS)
    print(f"costas under vmap, {B} streams x {COSTAS_N} on {card}: parent "
          f"{res['parent_vmap_32_ms']:.4f} ms ({B} launches), package "
          f"{res['package_vmap_32_ms']:.4f} ms "
          f"({res['package_vmap_32_launches']} launch)")
    (out_dir / "recurrence_compare.json").write_text(json.dumps(res,
                                                                indent=1))
    print(json.dumps(res))
    return 1 if failed else 0


if __name__ == "__main__":
    args = sys.argv[1:]
    sys.exit(main(Path(args[0]) if args else Path("build/recurrence_before"),
                  Path(args[1]) if len(args) > 1
                  else Path("build/recurrence_compare")))
