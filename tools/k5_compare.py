#!/usr/bin/env python3
"""K5's panels (``kernels/qpsk_sym.qpsk_panels``) against an earlier K5,
timing probes of the current one and the packed-operand ``torch.matmul``,
in one process on one CUDA card.

    mkdir -p build/k5_before
    git show <rev>:comms_tpu_torch/csrc/qpsk_sym.cu \\
        > build/k5_before/qpsk_sym.cu
    PYTHONPATH=. python3 tools/k5_compare.py build/k5_before

The earlier K5 is the CUDA-core SGEMM whose C entry takes no chunk rows
(``qpsk_panels_launch(xr, xi, n, hw, part, chunks, panels, stream)``,
4096-row chunks, partial sums [chunks, 256, 512]; up to commit 311dd2e).
Beside it the script builds probes of the package's own
``csrc/qpsk_sym.cu``, each with one piece of work cut out (``PROBES``:
their panels are wrong by design and are not held to the tolerance), so
that the time each piece adds can be read off.

It builds the package's kernels, the earlier K5 and the probes (nvcc for
sm_90a, in parallel, into the earlier K5's directory), prints ptxas's
registers and spills for the panel kernels (and any ptxas line about
wgmma) and the opcode counts of the panel kernel's SASS, then on the
QPSK capture of ``chip_smoke.py`` at 2^25 and 2^22 samples (halfwidth
51) checks every version against the float64 panels (``corr_panels`` on
float64 copies of the planes) and against the plain version (cuBLAS
float32), relative to the largest float64 panel entry, and times them:
the packed ``torch.matmul`` (TF32 off; ``chip_smoke.packed_panel_operands``,
packed beforehand), the earlier K5, the package's K5 twice, the earlier K5
again, each probe, the packed ``torch.matmul`` again (device time as
``chip_smoke.cuda_ms`` measures it).  The last line is the result as
JSON; the exit code is 1 if a check failed.
"""

from __future__ import annotations

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
from comms_tpu_torch.kernels import qpsk_sym as QS

HW = 51
SIZES = (1 << 25, 1 << 22)
TOL = 1e-5
# Each probe: text replacements in csrc/qpsk_sym.cu (every occurrence).
# One TF32 product a term (the tensor cores' share of the time); no split
# of the next stage's B while the products run (the split's share).
PROBES = {
    "probe_one_product": [
        ("tf32x3::wgmma_tf32x3(acc, ",
         "tf32x3::wgmma_m64n128k8(acc, ah[kb], "
         "tf32x3::smem_desc_sw128(bh + 32 * kb, 1024), kb > 0);\n"
         "      if (0) tf32x3::wgmma_tf32x3(acc, ")],
    "probe_no_split": [
        ("panel_split_b(raw + ((s + 1) % 2) * kRawFloats,",
         "if (0) panel_split_b(raw + ((s + 1) % 2) * kRawFloats,")],
}


def ptxas_lines(log: str):
    """``name: registers, shared memory, spills`` for each panel kernel of
    ``log`` (ptxas -v)."""
    lines = log.splitlines()
    out = []
    for i, line in enumerate(lines):
        m = re.search(r"Compiling entry function '([^']*)'", line)
        if "wgmma" in line and "Compiling" not in line:
            out.append(line.strip())
        if not m or "qpsk_panel" not in m.group(1):
            continue
        name = re.search(r"qpsk_panel\w*?_kernel", m.group(1)).group(0)
        info = " ".join(lines[j].split(":", 1)[-1].strip()
                        for j in range(i + 1, min(i + 4, len(lines)))
                        if "spill" in lines[j] or "Used" in lines[j])
        out.append(f"{name}: {info}")
    return out


def sass_histogram(lib: Path) -> dict:
    """Opcode counts of the panel kernel's SASS (``cuobjdump -sass``
    beside nvcc), or {} where the toolkit has no cuobjdump."""
    tool = Path(_build.nvcc_path()).with_name("cuobjdump")
    if not tool.exists():
        return {}
    sass = subprocess.run([str(tool), "-sass", str(lib)], capture_output=True,
                          text=True).stdout
    counts, inside = {}, False
    for line in sass.splitlines():
        if "Function :" in line:
            inside = "qpsk_panel_tf32x3_kernel" in line
        m = re.match(r"\s*/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                     line)
        if inside and m:
            op = m.group(1).split(".")[0]
            counts[op] = counts.get(op, 0) + 1
    return dict(sorted(counts.items(), key=lambda kv: -kv[1]))


def panels_of_product(C, w):
    return (C[:128, :w], -C[:128, w:], C[128:, :w], -C[128:, w:])


def main(before_dir: Path) -> int:
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(card)
    print("torch", torch.__version__, "CUDA", torch.version.cuda)
    csrc = _build.CSRC_DIR
    text = (csrc / "qpsk_sym.cu").read_text()
    sources = {"before": before_dir / "qpsk_sym.cu"}
    for name, edits in PROBES.items():
        src = text
        for old, new in edits:
            if old not in src:
                raise SystemExit(f"{name}: {old!r} is not in "
                                 f"csrc/qpsk_sym.cu")
            src = src.replace(old, new)
        d = before_dir / name
        d.mkdir(exist_ok=True)
        (d / "qpsk_sym.cu").write_text(src)
        (d / "tf32x3.cuh").write_text((csrc / "tf32x3.cuh").read_text())
        sources[name] = d / "qpsk_sym.cu"
    t0 = time.time()
    procs = {k: subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(src.with_suffix(".so")), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for k, src in sources.items()}
    _build.load()
    logs = {"package": Path(f"{_build.library_path()}.log").read_text()}
    for k, proc in procs.items():
        logs[k] = proc.communicate()[1]
        if proc.returncode:
            print(logs[k])
            return 1
    print(f"builds {time.time() - t0:.1f} s")
    for k, log in logs.items():
        for line in ptxas_lines(log):
            print(f"ptxas, {k}:", line)
    print("SASS of qpsk_panel_tf32x3_kernel, instructions by opcode:",
          json.dumps(sass_histogram(_build.library_path())))

    p, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_int64
    libs = {}
    for k, src in sources.items():
        lib = ctypes.CDLL(str(src.with_suffix(".so")))
        lib.qpsk_panels_launch.restype = i32
        lib.qpsk_panels_launch.argtypes = (
            [p, p, i64, i32, p, i32, p, p] if k == "before" else
            [p, p, i64, i32, i32, p, i32, p, p])
        libs[k] = lib

    def other(k, re_, im_, hw, out, part):
        """One call of the earlier K5 or a probe into out [4, 128, w]."""
        n = re_.shape[0]
        s = torch.cuda.current_stream().cuda_stream
        if k == "before":
            chunks = -(-(-(-(n - hw) // 128)) // 4096)
            rc = libs[k].qpsk_panels_launch(
                re_.data_ptr(), im_.data_ptr(), n, hw, part.data_ptr(),
                chunks, out.data_ptr(), s)
        else:
            rows, chunks = QS.panel_chunking(n, hw)
            rc = libs[k].qpsk_panels_launch(
                re_.data_ptr(), im_.data_ptr(), n, hw, rows, part.data_ptr(),
                chunks, out.data_ptr(), s)
        if rc:
            raise RuntimeError(f"{k}: CUDA error {rc}")

    assert not torch.backends.cuda.matmul.allow_tf32
    dev = torch.device("cuda")
    cs.QPSK_N = max(SIZES)
    re_all, im_all, _ = cs.qpsk_capture(dev, seed=7)
    errs, times, fails = {}, {}, []
    w = 128 + 2 * HW
    for n in SIZES:
        re_, im_ = re_all[:n], im_all[:n]
        exact = QS.qpsk_panels_plain(re_.double(), im_.double(), HW)[:4]
        scale = max(float(e.abs().max()) for e in exact)
        plain = QS.qpsk_panels_plain(re_, im_, HW)[:4]
        V, W = cs.packed_panel_operands(re_, im_, HW)
        out = torch.empty(4, 128, w, device=dev)
        part = torch.empty(67 * 4 * 128 * 256, device=dev)   # >= any
        got = {"k5": QS.qpsk_panels(re_, im_, HW)[:4],
               "plain": plain,
               "matmul_packed": panels_of_product(V.T @ W, w)}
        for k in libs:
            other(k, re_, im_, HW, out, part)
            got[k] = tuple(out.clone())
        again = QS.qpsk_panels(re_, im_, HW)[:4]
        if not all(torch.equal(a, b) for a, b in zip(got["k5"], again)):
            fails.append(f"k5 at {n}: two runs differ")
        for k, pan in got.items():
            e64 = max(float((g.double() - e).abs().max())
                      for g, e in zip(pan, exact)) / scale
            e32 = max(float((g - q).abs().max())
                      for g, q in zip(pan, plain)) / scale
            errs[f"{k}_{n}"] = {"vs_float64": e64, "vs_plain": e32}
            if (k != "plain" and k not in PROBES
                    and not (e64 <= TOL and e32 <= TOL)):
                fails.append(f"{k} at {n}: {e64} {e32}")
        print(f"N={n}, hw {HW}, relative to the largest float64 panel "
              f"entry:", json.dumps({k: v for k, v in errs.items()
                                     if k.endswith(f"_{n}")}))
        t = {"matmul_packed": [cs.cuda_ms(lambda: V.T @ W)],
             "before": [], "k5": []}
        for who in ("before", "k5", "k5", "before", *PROBES):
            if who == "k5":
                ms = cs.cuda_ms(lambda: QS.qpsk_panels(re_, im_, HW))
            else:
                ms = cs.cuda_ms(lambda: other(who, re_, im_, HW, out, part))
            t.setdefault(who, []).append(ms)
        t["matmul_packed"].append(cs.cuda_ms(lambda: V.T @ W))
        t["plain"] = cs.cuda_ms(lambda: QS.qpsk_panels_plain(re_, im_, HW))
        t["bound"] = cs.bound(8 * n, 0, 8 * w * n)[0]
        times[n] = t
        print(f"N={n} on {card}, ms:", json.dumps(t))
        del V, W
    print(json.dumps({"card": card, "hw": HW, "errors": errs, "ms": times,
                      "fails": fails}))
    return 1 if fails else 0


if __name__ == "__main__":
    if len(sys.argv) != 2:
        raise SystemExit(__doc__)
    sys.exit(main(Path(sys.argv[1])))
