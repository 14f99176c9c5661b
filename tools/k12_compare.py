#!/usr/bin/env python3
"""K12, the ring halo exchange (``kernels/halo_ring.exchange`` on
``csrc/halo_ring.cu``), against the first K12 (d9c4025: its kernel and
its wrapper), in one process on one CUDA card.

    mkdir -p build/k12_before
    git show d9c4025:comms_tpu_torch/csrc/halo_ring.cu > build/k12_before/halo_ring.cu
    git show d9c4025:comms_tpu_torch/kernels/halo_ring.py > build/k12_before/halo_ring.py
    PYTHONPATH=.:tools python3 tools/k12_compare.py build/k12_before

The first K12 (copies of 16, 4 or 1 bytes by the OR of every pointer and
the length, up to 1,024 blocks of 256 threads a pair, a 2 KB parameter
block on every launch; its wrapper slices every tail and allocates every
destination on its own) runs under its own wrapper, loaded from the
directory with the first library swapped in, so its host time is its
own.  Beside it the script builds the ``VARIANTS``, text edits of the
package's ``csrc/halo_ring.cu`` launched under the package's wrapper:
``cap128`` (the 2 KB parameter block for every call), ``parent_grid``
(the realigned copies on the first kernel's grid: one word a thread, up
to 1,024 blocks a pair), ``words1`` and ``words4`` (words a thread, in
one wave; the package has 2), ``rolled_head`` (the last word's narrow
stores in loops), ``index64`` (the word indices in 64-bit arithmetic),
``templated_q`` (four realigned paths, one a word part
of the source offset, their lanes fixed at compile time, in place of the
package's one path with selects), and
``tma``, a separate kernel for pairs whose sources and length are
16-byte aligned: one thread a 32 KB chunk copies it global -> shared ->
global with ``cp.async.bulk`` (TMA bulk copies) on an mbarrier.

It prints ptxas's lines of every build, then checks the package's
output byte for byte against ``exchange_plain`` and the first K12's, and
the variants' against the package's: a sweep of the sources' byte
offsets 0..15 (each the dtype allows) × lengths 1, 15, 16, 17, 4,095
and 25,669 elements and 1 MiB for u8, float32 and complex64, 2 rings of 4
shards each at other offsets, wrapped and with contexts; the 2-D rows
``[n, 4]``; 180 pairs (two launches).  Then it times (``chip_smoke.cuda_ms``,
device time behind a spin kernel, median of 25) first / package /
package / first at the sharded paths' shapes (the fused FM raw tails, 16
× 25,669 B u8; the 62-sample complex64 and float32 halos; the 2-D demod
rows; the 1 MiB ring, 8 pairs), beside the launch floor (the empty
kernel of ``csrc/halo_ring.cu`` with the 2 KB and the 16-byte parameter
block, at one block and at the package's grid), the bound, plain and
``torch._foreach_copy_``, then the variants; and the host's µs per call
of both wrappers (``time.perf_counter`` over 100 unsynchronised calls
after 20 warm-up calls, first / package / package / first).

The last line is the result as JSON; the exit code is 1 if a check
failed.
"""

from __future__ import annotations

import ctypes
import importlib.util
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import halo_ring as HR

REPS = 25
VARIANTS = {
    "cap128": [("return static_cast<int>(npairs <= kSmallPairs",
                "return static_cast<int>(false")],
    "parent_grid": [("constexpr int kWords = 2;", "constexpr int kWords = 1;"),
                    ("const long long cap = resident / npairs > 0 ? "
                     "resident / npairs : 1;", "const long long cap = 1024;")],
    "words1": [("constexpr int kWords = 2;", "constexpr int kWords = 1;")],
    "words4": [("constexpr int kWords = 2;", "constexpr int kWords = 4;")],
    # the narrow stores of the last word in loops, not unrolled
    "rolled_head": [("#pragma unroll\n  for (int k = 0; k < 4; ++k) {",
                     "#pragma unroll 1\n  for (int k = 0; k < 4; ++k) {"),
                    ("#pragma unroll\n      for (int c = 0; c < 3; ++c) {",
                     "#pragma unroll 1\n      for (int c = 0; c < 3; ++c) {")],
    # the word indices in 64-bit arithmetic
    "index64": [
        ("int nbytes, int last, unsigned q,\n                              "
         "            unsigned sh, int w0, int stride) {\n"
         "  const int nwords = (nbytes + 15) >> 4;\n"
         "  for (int w = w0; w < nwords; w += kWords * stride) {",
         "long long nbytes, long long last, unsigned q,\n"
         "    unsigned sh, long long w0, long long stride) {\n"
         "  const long long nwords = (nbytes + 15) >> 4;\n"
         "  for (long long w = w0; w < nwords; w += kWords * stride) {"),
        ("      const int wj = w + j * stride;\n      if (wj < nwords) {\n"
         "        a[j]", "      const long long wj = w + j * stride;\n"
         "      if (wj < nwords) {\n        a[j]"),
        ("      const int wj = w + j * stride;\n      if (wj < nwords) {\n"
         "        uint4 o;", "      const long long wj = w + j * stride;\n"
         "      if (wj < nwords) {\n        uint4 o;"),
        ("        const int rem = nbytes - 16 * wj;",
         "        const long long rem = nbytes - 16 * wj;"),
        ("          store_head(dst + wj, o, rem);",
         "          store_head(dst + wj, o, static_cast<int>(rem));"),
        ("  const int nbytes = p.nbytes;\n"
         "  const int last = static_cast<int>((off + nbytes - 1) >> 4);\n"
         "  const int w0 = blockIdx.x * kThreads + threadIdx.x;\n"
         "  const int stride = gridDim.x * kThreads;",
         "  const long long nbytes = p.nbytes;\n"
         "  const long long last = (off + nbytes - 1) >> 4;\n"
         "  const long long w0 =\n"
         "      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;\n"
         "  const long long stride = static_cast<long long>(gridDim.x) * "
         "kThreads;")],
    # four realigned paths, one a word part of the offset (kQ), each with
    # its lanes fixed at compile time, in place of the selects
    "templated_q": [
        ("__device__ __forceinline__ uint4 realign(const uint4& a, "
         "const uint4& b,\n                                         "
         "unsigned q, unsigned sh) {",
         "template <int kQ>\n__device__ __forceinline__ uint4 realign("
         "const uint4& a, const uint4& b,\n                              "
         "           unsigned q, unsigned sh) {\n  q = kQ;"),
        ("template <bool kAligned>\n__device__ __forceinline__ void "
         "copy_pair(", "template <int kQ>\n__device__ __forceinline__ void "
         "copy_pair("),
        ("        if (!kAligned) {", "        if (kQ >= 0) {"),
        ("        if constexpr (kAligned) {", "        if constexpr (kQ < 0) {"),
        ("o = realign(a[j], b[j], q, sh);",
         "o = realign<kQ < 0 ? 0 : kQ>(a[j], b[j], q, sh);"),
        ("    copy_pair<true>(base, dst, nbytes, last, 0, 0, w0, stride);",
         "    copy_pair<-1>(base, dst, nbytes, last, 0, 0, w0, stride);"),
        ("    copy_pair<false>(base, dst, nbytes, last, off >> 2, "
         "8u * (off & 3u), w0,\n                     stride);",
         "    const unsigned sh = 8u * (off & 3u);\n"
         "    switch (off >> 2) {\n"
         "      case 0: copy_pair<0>(base, dst, nbytes, last, 0, sh, w0, "
         "stride); break;\n"
         "      case 1: copy_pair<1>(base, dst, nbytes, last, 1, sh, w0, "
         "stride); break;\n"
         "      case 2: copy_pair<2>(base, dst, nbytes, last, 2, sh, w0, "
         "stride); break;\n"
         "      default: copy_pair<3>(base, dst, nbytes, last, 3, sh, w0, "
         "stride); break;\n    }")],
}

# Pairs with 16-byte aligned sources and lengths only: one thread a 32 KB
# chunk, global -> shared by a bulk copy on an mbarrier, shared -> global
# by a bulk copy; the same C entry as the package's.
TMA_SOURCE = r"""
#include <cuda_runtime.h>
#include <stdint.h>
namespace {
constexpr int kChunk = 32768;
struct Pair { const void* src; void* dst; };
struct Params { Pair pair[128]; long long nbytes; };
__global__ void __launch_bounds__(32) halo_tma_kernel(const __grid_constant__ Params p) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(8) uint64_t bar;
  const long long off = static_cast<long long>(blockIdx.x) * kChunk;
  if (threadIdx.x != 0 || off >= p.nbytes) return;
  const Pair pr = p.pair[blockIdx.y];
  const long long left = p.nbytes - off;
  const uint32_t bytes = static_cast<uint32_t>(left < kChunk ? left : kChunk);
  const uint32_t b = static_cast<uint32_t>(__cvta_generic_to_shared(&bar));
  const uint32_t s = static_cast<uint32_t>(__cvta_generic_to_shared(smem));
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" :: "r"(b));
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(b), "r"(bytes) : "memory");
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];"
               :: "r"(s), "l"(static_cast<const char*>(pr.src) + off), "r"(bytes),
                  "r"(b) : "memory");
  uint32_t done = 0;
  for (uint32_t i = 0; !done; ++i) {
    if (i == (1u << 26)) __trap();
    asm volatile("{\n.reg .pred q;\n"
                 "mbarrier.try_wait.parity.shared::cta.b64 q, [%1], 0;\n"
                 "selp.u32 %0, 1, 0, q;\n}\n" : "=r"(done) : "r"(b) : "memory");
  }
  asm volatile("cp.async.bulk.global.shared::cta.bulk_group [%0], [%1], %2;"
               :: "l"(static_cast<char*>(pr.dst) + off), "r"(s), "r"(bytes)
               : "memory");
  asm volatile("cp.async.bulk.commit_group;" ::: "memory");
  asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
}
}  // namespace
extern "C" int halo_ring_launch(const void* const* ptrs, int npairs,
                                long long nbytes, void* stream) {
  if (npairs < 1 || npairs > 128 || nbytes < 16 || (nbytes & 15)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p = {};
  uintptr_t bits = 0;
  for (int i = 0; i < npairs; ++i) {
    p.pair[i].src = ptrs[i];
    p.pair[i].dst = const_cast<void*>(ptrs[npairs + i]);
    bits |= reinterpret_cast<uintptr_t>(ptrs[i]) |
            reinterpret_cast<uintptr_t>(ptrs[npairs + i]);
  }
  if (bits & 15u) return static_cast<int>(cudaErrorMisalignedAddress);
  p.nbytes = nbytes;
  const dim3 grid(static_cast<unsigned>((nbytes + kChunk - 1) / kChunk),
                  static_cast<unsigned>(npairs));
  halo_tma_kernel<<<grid, 32, kChunk, static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}
"""


class _Swapped:
    """The package's library with another build's K12 entry."""

    def __init__(self, lib, other):
        self._lib = lib
        self.halo_ring_launch = other.halo_ring_launch

    def __getattr__(self, name):
        return getattr(self._lib, name)


def bind(lib, first: bool):
    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    lib.halo_ring_launch.restype = i32
    if first:
        lib.halo_ring_launch.argtypes = [ctypes.POINTER(p), ctypes.POINTER(p),
                                         i32, i64, p]
    else:
        lib.halo_ring_launch.argtypes = [p, i32, i64, p]
    return lib


def first_wrapper(before_dir: Path, lib):
    """The first K12's wrapper module (its own file), loading ``lib``."""
    spec = importlib.util.spec_from_file_location(
        "k12_first_halo_ring", before_dir / "halo_ring.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)

    class _Build:
        @staticmethod
        def load():
            return lib
    mod._build = _Build
    return mod


def ptxas_report(log: str) -> list:
    """``kernel: registers, stack, spills`` lines of a ptxas log for the
    K12 kernels."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(halo_\w+?kernel\w*)'",
                      line)
        if m:
            name = m.group(1)
        elif "Compiling entry function" in line:
            name = None
        elif name and ("Used" in line or "spill" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
            if "Used" in line:
                name = None
    return out


def sweep_rings(dev, gen, dtype, length: int, off: int, rings=2, n=4):
    """``rings`` rings of ``n`` shards whose ``length``-element tails start
    at byte offsets off, off + 5 es, ... (mod 16): each shard is 16 bytes
    and the tail, cut from a fresh byte buffer."""
    es = torch.empty(0, dtype=dtype).element_size()
    out = []
    for _ in range(rings):
        ring = []
        for i in range(n):
            o = (off + 5 * i * es) % 16
            buf = torch.randint(0, 256, (32 + length * es,), generator=gen,
                                device=dev, dtype=torch.uint8)
            ring.append(buf[o:o + 16 + length * es].view(dtype))
        out.append(ring)
    return out


def same_bytes(got, want) -> bool:
    return all(torch.equal(a.reshape(-1).view(torch.uint8),
                           b.reshape(-1).view(torch.uint8))
               for ga, wa in zip(got, want) for a, b in zip(ga, wa))


def host_us(fn, calls: int = 100, warmup: int = 20) -> float:
    """The host's µs per call of ``fn`` over ``calls`` unsynchronised
    calls after ``warmup`` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


def main(before_dir: Path) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    print("torch", torch.__version__, "CUDA", torch.version.cuda)
    for f in ("halo_ring.cu", "halo_ring.py"):
        if not (before_dir / f).exists():
            raise SystemExit(f"{before_dir / f} missing (see the usage)")
    csrc = _build.CSRC_DIR
    sources = {"first": before_dir / "halo_ring.cu"}
    for name, edits in VARIANTS.items():
        text = (csrc / "halo_ring.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        d = before_dir / name
        d.mkdir(exist_ok=True)
        (d / "halo_ring.cu").write_text(text)
        sources[name] = d / "halo_ring.cu"
    (before_dir / "tma").mkdir(exist_ok=True)
    (before_dir / "tma" / "halo_tma.cu").write_text(TMA_SOURCE)
    sources["tma"] = before_dir / "tma" / "halo_tma.cu"
    t0 = time.time()
    procs = {k: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(src.with_suffix(".so")), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, src in sources.items()}
    _build.load()
    logs, fails = {}, []
    for k, proc in procs.items():
        logs[k] = proc.communicate()[1]
        if proc.returncode:
            print(logs[k])
            if k == "first":
                return 1
            fails.append(f"{k}: the build failed")
            sources.pop(k)
            VARIANTS.pop(k, None)
    print(f"builds {time.time() - t0:.1f} s")
    pkg_log = Path(f"{_build.library_path()}.log")
    logs["package"] = pkg_log.read_text() if pkg_log.exists() else ""
    ptx = {k: ptxas_report(v) for k, v in logs.items()}
    for k, lines in ptx.items():
        for line in lines:
            print(f"ptxas, {k}, {line}")
    spills = [x for x in ptx["package"]
              if "spill" in x and not re.search(r"\b0 bytes spill stores", x)]
    if spills or not ptx["package"]:
        fails.append(f"package kernels spill or no ptxas lines: {spills}")
    libs = {k: bind(ctypes.CDLL(str(src.with_suffix(".so"))), k == "first")
            for k, src in sources.items()}
    first = first_wrapper(before_dir, libs.pop("first"))
    pkg = _build.load()

    def variant(name):
        _build._lib = _Swapped(pkg, libs[name])

    def package():
        _build._lib = pkg

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(19)
    if HR.MAX_PAIRS != pkg.halo_ring_max_pairs():
        fails.append("MAX_PAIRS differs from the library's")

    # ---- checks: the sweep, then the 2-D rows and 180 pairs
    n_calls, bad = 0, []
    L0 = HR.launches
    for dtype in (torch.uint8, torch.float32, torch.complex64):
        es = torch.empty(0, dtype=dtype).element_size()
        for nb in (1, 15, 16, 17, 4095, 25669, 1 << 20):
            length = nb if nb < (1 << 20) else nb // es
            for off in range(0, 16, es):
                rings = sweep_rings(dev, gen, dtype, length, off)
                ctxs = [sweep_rings(dev, gen, dtype, length, 0, 1, 1)[0][0]
                        [-length:].clone() for _ in rings]
                for form, c in (("wrap", None), ("ctx", ctxs)):
                    want = HR.exchange_plain(rings, length, c)
                    got = HR.exchange(rings, length, c)
                    outs = {"package": got,
                            "first": first.exchange(rings, length, c)}
                    if form == "wrap":
                        for v in VARIANTS:
                            variant(v)
                            outs[v] = HR.exchange(rings, length, c)
                        package()
                    torch.cuda.synchronize()
                    n_calls += 1
                    for who, o in outs.items():
                        if not same_bytes(o, want):
                            bad.append(f"{who} {dtype} {length} off {off} "
                                       f"{form}")
                    for ga in got:
                        for a in ga:
                            if HR.source_offset(a.data_ptr()) or not \
                                    a.is_contiguous():
                                bad.append(f"destination {dtype} {length}")
    g2 = [[torch.randn((4096, 4), generator=gen, device=dev)
           for _ in range(2)] for _ in range(8)]
    c2 = [torch.randn((1, 4), generator=gen, device=dev) for _ in range(8)]
    big = [[torch.randn(256, generator=gen, device=dev) for _ in range(60)]
           for _ in range(3)]
    for name, (rings, halo, c) in {"rows_2d": (g2, 1, c2),
                                   "pairs_180": (big, 31, None)}.items():
        n0 = HR.launches
        got = HR.exchange(rings, halo, c)
        k = HR.launches - n0
        torch.cuda.synchronize()
        n_calls += 1
        if not (same_bytes(got, HR.exchange_plain(rings, halo, c))
                and same_bytes(got, first.exchange(rings, halo, c))):
            bad.append(name)
        if k != (2 if name == "pairs_180" else 1):
            bad.append(f"{name}: {k} launches")
    launches = HR.launches - L0
    print(f"checks: {n_calls} calls, {launches} package launches; "
          f"{len(bad)} mismatches {bad[:10]}")
    fails += bad

    # ---- times
    per = cs.BLOCK // cs.SH_SHARDS

    def ring(n, length, dtype=torch.float32, rings=1):
        if dtype == torch.uint8:
            return [[torch.randint(0, 256, (length,), generator=gen,
                                   device=dev, dtype=dtype) for _ in range(n)]
                    for _ in range(rings)]
        return [[torch.randn(length, generator=gen, device=dev).to(dtype)
                 for _ in range(n)] for _ in range(rings)]

    shapes = {
        "fused_raw_tails_u8": (ring(8, per, torch.uint8, 2), 25669),
        "iq_halo_c64": (ring(8, per, torch.complex64, 2), 62),
        "audio_halo_f32": (ring(8, per // 5, rings=2), 62),
        "2d_demod_rows_f32": (ring(2, 4096, rings=8), 4),
        "ring_1MiB_f32": (ring(8, cs.SH_RING_MIB // 4), cs.SH_RING_MIB // 4),
    }
    times = {}
    for key, (rings, halo) in shapes.items():
        t = {}
        pairs = sum(len(r) for r in rings)
        nbytes = halo * rings[0][0].element_size()
        for who in ("first", "package", "package", "first"):
            fn = (lambda: first.exchange(rings, halo)) if who == "first" \
                else (lambda: HR.exchange(rings, halo))
            t.setdefault(who, []).append(cs.cuda_ms(fn, reps=REPS))
        t["speedup"] = sum(t["first"]) / sum(t["package"])
        words = -(-nbytes // 16)
        grid = -(-words // 512) * pairs        # the package's grid here
        for big_p in (True, False):
            for blocks in (1, grid):
                t[f"floor_{'2KB' if big_p else '16B'}_{blocks}"] = cs.cuda_ms(
                    lambda: HR.launch_floor(big_p, blocks), reps=REPS)
        t["bound"] = cs.bound(2 * pairs * nbytes, 0)[0]
        t["of_bound"] = t["bound"] / min(t["package"])
        t["plain"] = cs.cuda_ms(lambda: HR.exchange_plain(rings, halo),
                                reps=REPS)
        srcs = [r[(i - 1) % len(r)][-halo:] for r in rings
                for i in range(len(r))]
        dsts = [torch.empty_like(s) for s in srcs]
        t["foreach_copy"] = cs.cuda_ms(lambda: torch._foreach_copy_(dsts,
                                                                    srcs),
                                       reps=REPS)
        for v in VARIANTS:
            variant(v)
            t[v] = cs.cuda_ms(lambda: HR.exchange(rings, halo), reps=REPS)
        package()
        t["pairs"], t["bytes_each"] = pairs, nbytes
        times[key] = t
        print(f"{key} on {card}, ms:", json.dumps(t))

    # ---- host µs per call, first / package / package / first
    host = {}
    for key in ("fused_raw_tails_u8", "iq_halo_c64"):
        rings, halo = shapes[key]
        rings = [[x for x in r] for r in rings]
        if key == "iq_halo_c64":
            rings = rings[:1]           # the 8-pair complex64 case
        h = {}
        for who in ("first", "package", "package", "first"):
            fn = (lambda: first.exchange(rings, halo)) if who == "first" \
                else (lambda: HR.exchange(rings, halo))
            h.setdefault(who, []).append(host_us(fn))
        h["ratio"] = min(h["package"]) / min(h["first"])
        h["pairs"] = sum(len(r) for r in rings)
        host[key] = h
        print(f"host us per call, {key}:", json.dumps(h))

    result = {"card": card, "ms": times, "host_us": host,
              "checks": n_calls, "ptxas": ptx, "fails": fails}
    print(json.dumps(result))
    sys.stdout.flush()

    # ---- the TMA bulk-copy variant last (an mbarrier fault traps)
    tma = {}
    for key in ("iq_halo_c64", "ring_1MiB_f32") if "tma" in libs else ():
        rings, halo = shapes[key]
        want = HR.exchange(rings, halo)
        variant("tma")
        got = HR.exchange(rings, halo)
        torch.cuda.synchronize()
        ok = same_bytes(got, want)
        if not ok:
            fails.append(f"tma {key}: not bit-equal")
        tma[key] = {"equal": ok,
                    "tma": cs.cuda_ms(lambda: HR.exchange(rings, halo),
                                      reps=REPS)}
        package()
        tma[key]["package"] = cs.cuda_ms(lambda: HR.exchange(rings, halo),
                                         reps=REPS)
        print(f"tma {key} on {card}, ms:", json.dumps(tma[key]))
    print(json.dumps({"tma": tma, "fails": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
