#!/usr/bin/env python3
"""K11, the panel reductions (``kernels/panel_reduce.panel_reductions``
on ``csrc/panel_reduce.cu``), against the first K11 (d9c4025), in one
process on one CUDA card.

    mkdir -p build/k11_before
    git show d9c4025:comms_tpu_torch/csrc/panel_reduce.cu > build/k11_before/panel_reduce.cu
    PYTHONPATH=.:tools python3 tools/k11_compare.py build/k11_before

The first K11 (one block of 128 threads, thread v walking the 128 rows
of its lag's diagonal in order with a ``sincosf`` a row) is built from
the directory (with the package's ``atan2_poly.cuh``) and swapped in
under the package's wrapper.  Beside it the script builds the
``VARIANTS``, text edits of the package's source: ``groups4`` and
``groups2`` (4 or 2 row groups of 32 or 64 rows: 512 or 256 threads),
``batch4`` and ``batch16`` (rows of loads in flight a thread),
``cluster`` (:func:`cluster_source`: the row groups spread over a
cluster of 8 blocks, combined through distributed shared memory in the
same order, so the same bits), and the
``PROBES``, which cut one piece of work to read off its time (no panel
loads; no row-group sums, leaving the phase table, the combine and the
stores).

On the panels of random planes (``TimingEstimator.corr_panels``, 2^20
samples) at hw 20, 51 and 63 it checks, for sps 1..8: the package's
block bit-equal over repeated calls; rows 0, 1 and 8+a within
``chip_smoke.TOL_REDUCE`` of ``panel_reductions_plain`` (relative to the
largest lag sum), row 2 within 1e-5 rad of plain and of the angle of the
r2-rotated v = -1 lag sum, every other entry 0; the first kernel and the
variants the same way.  It prints each one's error against a float64
evaluation of the same reductions (relative to the largest lag sum) at
sps 4, then times (``chip_smoke.cuda_ms``, device time behind a spin
kernel, median of 15) first / package / package / first at hw 20, 51
and 63 (sps 4) beside the launch floor (``halo_ring.launch_floor``, the
empty kernel with a 16-byte parameter block), the bound, plain, the
variants and the probes.  ptxas's lines of every build come first.

The last line is the result as JSON; the exit code is 1 if a check
failed.
"""

from __future__ import annotations

import ctypes
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

import chip_smoke as cs
from comms_tpu_torch.kernels import _build
from comms_tpu_torch.kernels import halo_ring as HR
from comms_tpu_torch.kernels import panel_reduce as PR
from comms_tpu_torch.models import qpsk_rx as trx

REPS = 15
HWS = (20, 51, 63)
VARIANTS = {
    "groups4": [("constexpr int kGroups = 8;", "constexpr int kGroups = 4;")],
    "groups2": [("constexpr int kGroups = 8;", "constexpr int kGroups = 2;")],
    "batch4": [("constexpr int kBatch = 8;", "constexpr int kBatch = 4;")],
    "batch16": [("constexpr int kBatch = 8;", "constexpr int kBatch = 16;")],
}


def cluster_source(text: str) -> str:
    """The package's source with the kernel spread over a cluster of
    kGroups blocks of 128 threads, one row group a block: each block's
    partial sums in its own shared memory, combined in block order
    through distributed shared memory after a cluster barrier (the
    package's summation order, so the same bits)."""
    text = text.replace('#include "atan2_poly.cuh"',
                        '#include <cooperative_groups.h>\n\n'
                        '#include "atan2_poly.cuh"\n\n'
                        'namespace cg = cooperative_groups;')
    edits = [
        ("constexpr int kBatch = 8; ", "constexpr int kBatch = 16;"),
        ("constexpr int kThreads = kGroups * kLanes;",
         "constexpr int kThreads = kLanes;"),
        ("__global__ void __launch_bounds__(kThreads)",
         "__global__ void __cluster_dims__(kGroups, 1, 1) "
         "__launch_bounds__(kThreads)"),
        ("  __shared__ float part[kGroups][kSums][kLanes];\n"
         "  const int t = threadIdx.x;\n"
         "  const int v = t % kLanes;\n"
         "  const int g = t / kLanes;\n",
         "  __shared__ float part[1][kSums][kLanes];\n"
         "  cg::cluster_group cluster = cg::this_cluster();\n"
         "  const int t = threadIdx.x;\n"
         "  const int v = t;\n"
         "  const int g = static_cast<int>(cluster.block_rank());\n"),
        ("    part[g][0][v] = gr;\n    part[g][1][v] = gi;",
         "    part[0][0][v] = gr;\n    part[0][1][v] = gi;"),
        ("for (int b = 0; b < 8; ++b) part[g][2 + b][v] = ga[b];",
         "for (int b = 0; b < 8; ++b) part[0][2 + b][v] = ga[b];"),
        ("  __syncthreads();\n  // Every entry of out once",
         "  cluster.sync();\n  // Every entry of out once"),
        ("    const int e = t + k * kThreads;",
         "    const int e = (g * (kOutRows / kGroups) + k) * kLanes + t;"),
        ("  for (int k = 0; k < kOutRows * kLanes / kThreads; ++k) {",
         "  for (int k = 0; k < kOutRows / kGroups; ++k) {"),
        ("val += part[gg][s][lane];",
         "val += *cluster.map_shared_rank(&part[0][s][lane], gg);"),
        ("        gr += part[gg][0][hw - 1];\n        gi += part[gg][1][hw - 1];",
         "        gr += *cluster.map_shared_rank(&part[0][0][hw - 1], gg);\n"
         "        gi += *cluster.map_shared_rank(&part[0][1][hw - 1], gg);"),
        ("    out[e] = val;\n  }\n}",
         "    out[e] = val;\n  }\n  cluster.sync();\n}"),
        ("panel_reduce_kernel<<<1, kThreads, 0,",
         "panel_reduce_kernel<<<kGroups, kThreads, 0,"),
    ]
    for old, new in edits:
        if old not in text:
            raise SystemExit(f"cluster: {old!r} is not in the source")
        text = text.replace(old, new)
    return text


# Text edits that cut one piece of work, to read off its time; their
# blocks are wrong by design and are not checked.
PROBES = {
    "no_loads": [("P1[i] = p13[j * 256 + c];", "P1[i] = c;"),
                 ("P3[i] = p13[(kLanes + j) * 256 + c];", "P3[i] = 1.f;"),
                 ("P2[i] = -p24[j * 256 + c];", "P2[i] = 2.f;"),
                 ("P4[i] = -p24[(kLanes + j) * 256 + c];", "P4[i] = 3.f;")],
    "no_sums": [("if (v <= 2 * hw) {", "if (v <= 2 * hw && hw < 0) {")],
}


class _Swapped:
    """The package's library with another build's K11 entry."""

    def __init__(self, lib, other):
        self._lib = lib
        self.panel_reduce_launch = other.panel_reduce_launch

    def __getattr__(self, name):
        return getattr(self._lib, name)


def bind(lib):
    p, i32 = ctypes.c_void_p, ctypes.c_int
    lib.panel_reduce_launch.restype = i32
    lib.panel_reduce_launch.argtypes = [p, p, i32, i32, p, p]
    return lib


def ptxas_report(log: str) -> list:
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '\w*?(panel_reduce_kernel)",
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


def packed(cfg, dev, gen, hw: int):
    """The [256, 256] accumulators of random planes' panels and the
    panels."""
    n = 1 << 20
    re_ = torch.randn(n, generator=gen, device=dev)
    im_ = torch.randn(n, generator=gen, device=dev)
    qp = cfg.timing.corr_panels(re_, im_, halfwidth=hw)
    w = qp[4]["width"]
    p13 = torch.zeros((256, 256), device=dev)
    p24 = torch.zeros((256, 256), device=dev)
    p13[:128, :w], p13[128:, :w] = qp[0], qp[2]
    p24[:128, :w], p24[128:, :w] = -qp[1], -qp[3]
    return p13, p24, qp


def reductions_f64(p13, p24, hw: int, sps: int):
    """Rows 0, 1 and 8+a of the block in float64 (exact phases)."""
    P1, P3 = p13[:128].double(), p13[128:].double()
    P2, P4 = -p24[:128].double(), -p24[128:].double()
    a = torch.arange(128, device=p13.device) % sps
    ph = (2 * math.pi / sps) * a.double()[:, None]
    c2, s2 = torch.cos(ph), torch.sin(ph)
    Er = (c2 * P1 + s2 * P3) - (c2 * P4 - s2 * P2)
    Ei = (c2 * P2 + s2 * P4) + (c2 * P3 - s2 * P1)
    V = 2 * hw + 1
    cols = (torch.arange(128, device=p13.device)[:, None]
            + torch.arange(V, device=p13.device)[None, :])
    Dr, Di = torch.gather(Er, 1, cols), torch.gather(Ei, 1, cols)
    out = torch.zeros((16, 128), dtype=torch.float64, device=p13.device)
    out[0, :V], out[1, :V] = Dr.sum(0), Di.sum(0)
    for r in range(sps):
        out[8 + r, :V] = Dr[r::sps].sum(0)
    return out


def check(block, plain, hw: int, sps: int, f_rot: float) -> list:
    """What is wrong with ``block`` against ``plain`` (module docstring)."""
    bad = []
    V = 2 * hw + 1
    rows = [0, 1] + [8 + a for a in range(sps)]
    scale = float(plain[:2, :V].abs().max())
    e = float((block[rows][:, :V] - plain[rows][:, :V]).abs().max()) / scale
    if not e <= cs.TOL_REDUCE:
        bad.append(f"{e:.3g} from plain")
    if max(abs(float(block[2, 0]) - float(plain[2, 0])),
           abs(float(block[2, 0]) - f_rot)) > 1e-5:
        bad.append("row 2")
    written = torch.zeros((16, 128), dtype=torch.bool, device=block.device)
    written[rows, :V] = True
    written[2, 0] = True
    if bool((block[~written] != 0).any()):
        bad.append("unwritten entries not 0")
    return bad


def main(before_dir: Path) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    print("torch", torch.__version__, "CUDA", torch.version.cuda)
    if not (before_dir / "panel_reduce.cu").exists():
        raise SystemExit(f"{before_dir / 'panel_reduce.cu'} missing (see "
                         f"the usage)")
    csrc = _build.CSRC_DIR
    sources = {"first": before_dir / "panel_reduce.cu"}
    for name, edits in {**VARIANTS, **PROBES}.items():
        text = (csrc / "panel_reduce.cu").read_text()
        for old, new in edits:
            if old not in text:
                raise SystemExit(f"{name}: {old!r} is not in the source")
            text = text.replace(old, new)
        d = before_dir / name
        d.mkdir(exist_ok=True)
        (d / "panel_reduce.cu").write_text(text)
        sources[name] = d / "panel_reduce.cu"
    d = before_dir / "cluster"
    d.mkdir(exist_ok=True)
    (d / "panel_reduce.cu").write_text(cluster_source(
        (csrc / "panel_reduce.cu").read_text()))
    sources["cluster"] = d / "panel_reduce.cu"
    VARIANTS["cluster"] = []
    t0 = time.time()
    procs = {k: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(csrc), "-shared",
         "-o", str(src.with_suffix(".so")), str(src)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for k, src in sources.items()}
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
    ptx = {k: ptxas_report(v) for k, v in logs.items()}
    for k, lines in ptx.items():
        for line in lines:
            print(f"ptxas, {k}, {line}")
    spills = [x for x in ptx["package"]
              if "spill" in x and not re.search(r"\b0 bytes spill stores", x)]
    if spills or not ptx["package"]:
        fails.append(f"package kernel spills or no ptxas lines: {spills}")
    libs = {k: bind(ctypes.CDLL(str(src.with_suffix(".so"))))
            for k, src in sources.items()}
    pkg = _build.load()

    def use(name):
        _build._lib = pkg if name == "package" else _Swapped(pkg, libs[name])

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    cfg = trx.QpskRxConfig()
    panels = {hw: packed(cfg, dev, gen, hw) for hw in HWS}
    f64, times = {}, {}
    n0 = PR.launches
    for hw, (p13, p24, qp) in panels.items():
        gr, gi = cfg.timing.lag_sums_r2(qp)
        f_rot = float(torch.atan2(gi[hw - 1], gr[hw - 1]))
        for sps in range(1, 9):
            plain = PR.panel_reductions_plain(p13, p24, hw, sps)
            for who in ("package", "first", *VARIANTS):
                use(who)
                a = PR.panel_reductions(p13, p24, hw, sps)
                b = PR.panel_reductions(p13, p24, hw, sps)
                torch.cuda.synchronize()
                bad = check(a, plain, hw, sps, f_rot if sps == 4 else
                            float(plain[2, 0]))
                if not torch.equal(a, b):
                    bad.append("repeat differs")
                if bad:
                    fails.append(f"{who} hw {hw} sps {sps}: {bad}")
            use("package")
        ref = reductions_f64(p13, p24, hw, 4)
        V = 2 * hw + 1
        rows = [0, 1] + [8 + a for a in range(4)]
        scale = float(ref[:2, :V].abs().max())
        f64[hw] = {}
        for who in ("first", "package", "plain", *VARIANTS):
            if who == "plain":
                got = PR.panel_reductions_plain(p13, p24, hw, 4)
            else:
                use(who)
                got = PR.panel_reductions(p13, p24, hw, 4)
            f64[hw][who] = float((got[rows][:, :V].double()
                                  - ref[rows][:, :V]).abs().max()) / scale
        use("package")
        print(f"hw {hw}, error against float64 (relative to the largest "
              f"lag sum):", json.dumps(f64[hw]))
    torch.cuda.synchronize()
    launches = PR.launches - n0

    for hw, (p13, p24, _) in panels.items():
        t = {}
        for who in ("first", "package", "package", "first"):
            use(who)
            t.setdefault(who, []).append(cs.cuda_ms(
                lambda: PR.panel_reductions(p13, p24, hw), reps=REPS))
        use("package")
        t["speedup"] = sum(t["first"]) / sum(t["package"])
        t["floor_16B_1"] = cs.cuda_ms(lambda: HR.launch_floor(False, 1),
                                      reps=REPS)
        t["bound"] = cs.bound(2 * 256 * 256 * 4 + 16 * 128 * 4,
                              12 * (2 * hw + 1) * 128)[0]
        t["plain"] = cs.cuda_ms(lambda: PR.panel_reductions_plain(p13, p24,
                                                                  hw),
                                reps=REPS)
        for v in (*VARIANTS, *PROBES):
            use(v)
            t[v] = cs.cuda_ms(lambda: PR.panel_reductions(p13, p24, hw),
                              reps=REPS)
        use("package")
        times[hw] = t
        print(f"hw {hw} on {card}, ms:", json.dumps(t))
    print(json.dumps({"card": card, "ms": times, "err_f64": f64,
                      "launches": launches, "ptxas": ptx, "fails": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
