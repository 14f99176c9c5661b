"""The recurrence kernels' measured floor and bound (``csrc/recurrence.cu``:
the Costas loop and the AGC scan, a lane a stream), shared by
``chip_smoke.py`` (phase 20's rows) and ``tools/recurrence_compare.py``.

The probe is the package's ``recurrence.cu`` with kernels appended that
run the package's step functors (``CostasStep<4>``, ``AgcStep``) on
register-resident data, no loads or stores:

* ``*_chain_only_kernel``: n steps a thread over four noisy QPSK inputs
  made before the loop and held in registers, one warp, timed by
  ``clock64()`` and by CUDA events: the dependent chain's floor;
* ``*_split_kernel``: a copy of each step with a ``clock64()`` read after
  each part, each read made to wait for the part's result (a compare on
  it predicates the read), summed over n steps: Costas sincosf |
  rotation and c^4 | atan2f | error and updates; AGC scale | hypotf |
  division and logf | expf and the gain.

The issue term of the bound comes from the chain-only loop's SASS
(``cuobjdump -sass``): the fewest instructions any iteration of the loop
can issue (the shortest path through its control flow from the loop's
head to its back edge, an out-of-line slow path's instructions counted
where a path calls it), a step's share over the card's issue rate (one
warp instruction a cycle on each of 132 x 4 schedulers, 32 streams a
warp instruction) at the clock the chain run measured.

Nothing here imports ``chip_smoke``; a CUDA card, nvcc and cuobjdump are
needed at call time only.
"""

from __future__ import annotations

import ctypes
import heapq
import re
import subprocess
from pathlib import Path

import torch

from comms_tpu_torch.kernels import _build

CHAIN_STEPS = 1 << 16
SPLIT_STEPS = 4096
ALPHA, BETA = 0.1, 0.005
AGC_TARGET, AGC_RATE = 1.0, 5e-2
# The card (NVIDIA H100 SXM data sheet): memory rate, schedulers.
HBM_BYTES_PER_S = 3.35e12
SCHEDULERS = 132 * 4
LANES = 32
BYTES_A_STEP = 16        # read re, im; write re, im (float32)
STEPS_AN_ITERATION = 4   # the chain-only loop's unrolled steps

PROBE_SOURCE = r"""
namespace {

// clock64() once x and y are ready: the compares wait for them, and the
// read is predicated on the compares (never true: no value here is
// FLT_MAX), so it cannot issue before them.
__device__ __forceinline__ long long clock_after(float x, float y) {
  long long t;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.eq.f32 p, %1, 0f7F7FFFFF;\n\t"
      "setp.eq.or.f32 p, %2, 0f7F7FFFFF, p;\n\t"
      "@p mov.u64 %0, 0;\n\t"
      "@!p mov.u64 %0, %%clock64;\n\t}"
      : "=l"(t)
      : "f"(x), "f"(y)
      : "memory");
  return t;
}

// A step's input made in registers (off the chain): a QPSK point of
// amplitude a a component plus noise uniform in +-w, from a xorshift32
// state.  The loop then tracks a locked stream, as on real symbols.
__device__ __forceinline__ void next_input(uint32_t& h, float a, float w,
                                           float& sr, float& si) {
  h ^= h << 13;
  h ^= h >> 17;
  h ^= h << 5;
  const float ur = __uint2float_rn(h & 0x7fffu) * (2.f / 32768.f) - 1.f;
  const float ui = __uint2float_rn((h >> 15) & 0x7fffu) * (2.f / 32768.f) - 1.f;
  sr = ((h >> 31) ? a : -a) + w * ur;
  si = (((h >> 30) & 1u) ? a : -a) + w * ui;
}

// n steps (a multiple of 4) of ``step`` a thread, each thread its own
// stream, over 4 inputs made before the loop and held in registers (no
// loads or stores in the loop); thread 0 reports the loop's clock64()
// cycles.
template <class Step>
__device__ __forceinline__ void chain_only(const float* x, const float* s_in,
                                           int n, const Step& step,
                                           float* s_out, long long* cycles) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const float a = x[0], w = x[1];
  uint32_t h = 0x9e3779b9u ^ (static_cast<uint32_t>(tid) * 0x85ebca6bu);
  float in_r[4], in_i[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) next_input(h, a, w, in_r[j], in_i[j]);
  float st[Step::kStates];
  for (int j = 0; j < Step::kStates; ++j) st[j] = s_in[j];
  const long long t0 = clock_after(st[0], in_i[3]);
#pragma unroll 1
  for (int k = 0; k < n; k += 4) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float yr, yi;
      step(in_r[j], in_i[j], st, yr, yi);
    }
  }
  const long long t1 = clock_after(st[0], st[Step::kStates - 1]);
  for (int j = 0; j < Step::kStates; ++j) {
    s_out[static_cast<long long>(tid) * Step::kStates + j] = st[j];
  }
  if (tid == 0) cycles[0] = t1 - t0;
}

__global__ void costas_chain_only_kernel(const float* x, const float* s_in,
                                         int n, float alpha, float beta,
                                         float* s_out, long long* cycles) {
  chain_only(x, s_in, n, CostasStep<4>{4, alpha, beta}, s_out, cycles);
}

__global__ void agc_chain_only_kernel(const float* x, const float* s_in,
                                      int n, float target, float rate,
                                      float* s_out, long long* cycles) {
  chain_only(x, s_in, n, AgcStep{target, rate}, s_out, cycles);
}

// CostasStep<4>'s arithmetic, a clock read after each part.
__global__ void costas_split_kernel(const float* x, const float* s_in, int n,
                                    float alpha, float beta, float* s_out,
                                    long long* parts) {
  const float am = x[0], w = x[1];
  uint32_t h = 0x9e3779b9u;
  float ph = s_in[0], fr = s_in[1];
  long long p[4] = {0, 0, 0, 0};
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    float sr, si;
    next_input(h, am, w, sr, si);
    const long long t = clock_after(ph, sr + si);
    float s, c;
    sincosf(ph, &s, &c);
    const long long t1 = clock_after(s, c);
    const float ar = __fadd_rn(__fmul_rn(sr, c), __fmul_rn(si, s));
    const float ai = __fsub_rn(__fmul_rn(si, c), __fmul_rn(sr, s));
    float qr, qi;
    cpow(ar, ai, 4, qr, qi);
    const long long t2 = clock_after(qr, qi);
    const float a = atan2f(-qi, -qr);
    const long long t3 = clock_after(a, a);
    const float err = __fmul_rn(a, 0.25f);
    fr = __fadd_rn(fr, __fmul_rn(beta, err));
    ph = __fadd_rn(__fadd_rn(ph, fr), __fmul_rn(alpha, err));
    const long long t4 = clock_after(ph, fr);
    p[0] += t1 - t;
    p[1] += t2 - t1;
    p[2] += t3 - t2;
    p[3] += t4 - t3;
  }
  s_out[0] = ph;
  s_out[1] = fr;
  for (int j = 0; j < 4; ++j) parts[j] = p[j];
}

// AgcStep's arithmetic, a clock read after each part.
__global__ void agc_split_kernel(const float* x, const float* s_in, int n,
                                 float target, float rate, float* s_out,
                                 long long* parts) {
  const float am = x[0], w = x[1];
  uint32_t h = 0x9e3779b9u;
  float g = s_in[0];
  long long p[4] = {0, 0, 0, 0};
#pragma unroll 1
  for (int k = 0; k < n; ++k) {
    float sr, si;
    next_input(h, am, w, sr, si);
    const long long t = clock_after(g, sr + si);
    const float ar = __fmul_rn(sr, g);
    const float ai = __fmul_rn(si, g);
    const long long t1 = clock_after(ar, ai);
    const float mag = __fadd_rn(hypotf(ar, ai), 1e-12f);
    const long long t2 = clock_after(mag, mag);
    const float err = logf(__fdiv_rn(target, mag));
    const long long t3 = clock_after(err, err);
    g = __fmul_rn(g, expf(__fmul_rn(rate, err)));
    const long long t4 = clock_after(g, g);
    p[0] += t1 - t;
    p[1] += t2 - t1;
    p[2] += t3 - t2;
    p[3] += t4 - t3;
  }
  s_out[0] = g;
  for (int j = 0; j < 4; ++j) parts[j] = p[j];
}

}  // namespace

// which: 0 Costas chain-only, 1 AGC chain-only (blocks x threads streams),
// 2 Costas split, 3 AGC split (one thread); x = (amplitude, noise); (a, b)
// are (alpha, beta) or (target, rate); s_out gets each stream's state,
// out the cycles (one int64) or the four parts' cycles.
extern "C" int probe_launch(int which, int blocks, int threads,
                            const void* x, const void* s_in, int n, float a,
                            float b, void* s_out, void* out, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  const float* sf = static_cast<const float*>(s_in);
  float* so = static_cast<float*>(s_out);
  long long* o = static_cast<long long*>(out);
  switch (which) {
    case 0:
      costas_chain_only_kernel<<<blocks, threads, 0, st>>>(xf, sf, n, a, b,
                                                           so, o);
      break;
    case 1:
      agc_chain_only_kernel<<<blocks, threads, 0, st>>>(xf, sf, n, a, b, so,
                                                        o);
      break;
    case 2: costas_split_kernel<<<1, 1, 0, st>>>(xf, sf, n, a, b, so, o);
            break;
    case 3: agc_split_kernel<<<1, 1, 0, st>>>(xf, sf, n, a, b, so, o);
            break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
"""


COSTAS_PARTS = ("sincosf", "rotation and c^4", "atan2f", "error and updates")
AGC_PARTS = ("scale", "hypotf", "division and logf", "expf and the gain")


def nvcc(src: Path) -> subprocess.Popen:
    """nvcc ``src`` into ``src.so`` with the package's flags (ptxas -v),
    started and not waited for."""
    return subprocess.Popen(
        [_build.nvcc_path(), *_build.NVCC_FLAGS, "-shared", "-o",
         str(src.with_suffix(".so")), str(src)], stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)


def finish(procs: dict) -> dict:
    """Wait for the builds; their ptxas logs, by name; raises on a failed
    build."""
    logs = {}
    for name, p in procs.items():
        _, err = p.communicate()
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}:\n{err}")
        logs[name] = err
    return logs


def start_probe(build_dir: Path):
    """Write the probe (the package's source with the probe kernels
    appended) into ``build_dir`` and start its nvcc: ``(source,
    process)`` for :func:`chain_floor`."""
    build_dir.mkdir(parents=True, exist_ok=True)
    src = build_dir / "recurrence_probe.cu"
    src.write_text((_build.CSRC_DIR / "recurrence.cu").read_text()
                   + PROBE_SOURCE)
    return src, nvcc(src)


def load_probe(so: Path):
    lib = ctypes.CDLL(str(so))
    p, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.probe_launch.restype = i32
    lib.probe_launch.argtypes = [i32, i32, i32, p, p, i32, f32, f32, p, p,
                                 p]
    return lib


def kernel_name(mangled: str):
    """The short name of a recurrence or probe kernel's mangled name, or
    None for any other function."""
    for k in ("costas_chain_only_kernel", "agc_chain_only_kernel",
              "costas_split_kernel", "agc_split_kernel", "agc_scan_kernel"):
        if k in mangled:
            return k
    m = re.search(r"costas_loop_kernelILi(\d+)E", mangled)
    return f"costas_loop_kernel<{m.group(1)}>" if m else None


def ptxas_lines(log: str) -> list:
    """``kernel: stack frame and spills`` and ``kernel: registers`` lines
    of a ptxas log for the recurrence and probe kernels."""
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?(\w+)'?", line)
        if m:
            name = kernel_name(m.group(1))
        elif name and ("stack frame" in line or "Used" in line):
            out.append(f"{name}: {line.split(':', 1)[-1].strip()}")
    return out


def _fewest(ins: list, start: int, ends, callee) -> int | None:
    """The fewest instructions on a path through ``ins`` (``(address,
    text)`` pairs) from index ``start`` to an index in ``ends``, both
    counted: an instruction 1, a call 1 plus ``callee(index of its
    target)``; None where no path reaches ``ends``."""
    at = {a: i for i, (a, _) in enumerate(ins)}

    def parse(i):
        text = ins[i][1]
        pred = text.startswith("@")
        op = text.split()[1 if pred else 0]
        m = re.search(r"(0x[0-9a-f]+)\s*$", text)
        target = at.get(int(m.group(1), 16)) if m else None
        return pred, op, target

    def cost(i):
        _, op, target = parse(i)
        return 1 + (callee(target) if op.startswith("CALL") else 0)

    def succ(i):
        pred, op, target = parse(i)
        if op.startswith(("BRX", "JMX", "JMP")):
            raise ValueError(f"indirect branch: {ins[i][1]}")
        out = [target] if op.startswith("BRA") else []
        if pred or not op.startswith(("BRA", "EXIT", "RET")):
            out.append(i + 1)
        return [j for j in out if j is not None and j < len(ins)]

    dist = {start: cost(start)}
    heap = [(dist[start], start)]
    while heap:
        d, i = heapq.heappop(heap)
        if d > dist[i]:
            continue
        if i in ends:
            return d
        for j in succ(i):
            nd = d + cost(j)
            if nd < dist.get(j, nd + 1):
                dist[j] = nd
                heapq.heappush(heap, (nd, j))
    return None


def loop_counts(body: str) -> dict:
    """The longest backward branch's loop in ``body`` (one function's
    ``cuobjdump -sass`` text): its static instructions and the fewest
    any iteration can issue (head to back edge, a call counted with its
    callee's fewest path to a return), each a step
    (:data:`STEPS_AN_ITERATION` steps an iteration)."""
    ins = [(int(a, 16), t.strip()) for a, t in
           re.findall(r"/\*([0-9a-f]{4,})\*/\s+([^;]*);", body)]
    loops = []
    for i, (addr, t) in enumerate(ins):
        m = re.search(r"\bBRA\b.*?(0x[0-9a-f]+)\s*$", t)
        if m and int(m.group(1), 16) <= addr:
            loops.append((addr - int(m.group(1), 16), int(m.group(1), 16), i))
    if not loops:
        raise RuntimeError("no loop in the SASS")
    _, lo, hi = max(loops)
    head = next(i for i, (a, _) in enumerate(ins) if a == lo)
    rets = {j for j, (_, t) in enumerate(ins)
            if re.match(r"(@\S+\s+)?RET\b", t)}
    memo: dict = {}

    def callee(i):
        if i is None:
            return 0
        if i not in memo:
            memo[i] = 0     # a recursive call counts nothing more
            memo[i] = _fewest(ins, i, rets, callee) or 0
        return memo[i]

    fewest = _fewest(ins, head, {hi}, callee)
    return {"static": (hi - head + 1) / STEPS_AN_ITERATION,
            "fewest": fewest / STEPS_AN_ITERATION}


def sass_loop(so: Path, function: str, dump: Path | None = None) -> dict:
    """:func:`loop_counts` of the kernel in ``so`` whose mangled name
    holds ``function`` (``cuobjdump -sass``; the SASS is written to
    ``dump`` when given).  Raises where cuobjdump or the kernel is
    missing."""
    tool = Path(_build.nvcc_path()).parent / "cuobjdump"
    text = subprocess.run([str(tool), "-sass", str(so)], capture_output=True,
                          text=True, check=True).stdout
    blocks = re.split(r"\n\s*Function : ", text)
    body = next((b for b in blocks[1:]
                 if b.split("\n", 1)[0].find(function) >= 0), None)
    if body is None:
        raise RuntimeError(f"{function} is not in {so}'s SASS")
    if dump is not None:
        dump.write_text(body)
    return loop_counts(body)


def chain_floor(dev, probe, sass_dir: Path | None = None) -> dict:
    """Measure, for the Costas loop (order 4) and the AGC, from the probe
    ``probe`` (:func:`start_probe`'s pair, its build waited for here):

    * the chain floor: one warp, a stream a lane, CHAIN_STEPS steps:
      ``clock64()`` cycles and CUDA-event ns a step (median of 3 after a
      first run) and the SM clock they imply;
    * the ``clock64()`` split of a step (one thread, SPLIT_STEPS steps);
    * the chain-only loop's SASS instructions a step (:func:`sass_loop`)
      and the issue term they give: the fewest a step over
      SCHEDULERS x LANES stream-steps a cycle at the measured clock, ns
      a stream-step.

    Returns ``{"costas": {...}, "agc": {...}, "ptxas": [...]}``."""
    src, proc = probe
    log = finish({"probe": proc})["probe"]
    lib = load_probe(src.with_suffix(".so"))
    out = {"ptxas": ptxas_lines(log)}
    stream = torch.cuda.current_stream(dev).cuda_stream
    cases = (("costas", 0, [1.0, 0.06], [0.01, -2e-4], (ALPHA, BETA),
              COSTAS_PARTS, "costas_chain_only"),
             ("agc", 1, [1.0, 0.3], [1.0], (AGC_TARGET, AGC_RATE),
              AGC_PARTS, "agc_chain_only"))
    for name, which, x, s, (a, b), parts, fn in cases:
        xt = torch.tensor(x, device=dev)
        st = torch.tensor(s, device=dev)
        so = torch.empty(LANES * len(s), device=dev)
        cyc = torch.zeros(4, dtype=torch.int64, device=dev)

        def run(kind, blocks, threads, n):
            e0 = torch.cuda.Event(enable_timing=True)
            e1 = torch.cuda.Event(enable_timing=True)
            e0.record()
            rc = lib.probe_launch(kind, blocks, threads, xt.data_ptr(),
                                  st.data_ptr(), n, a, b, so.data_ptr(),
                                  cyc.data_ptr(), stream)
            e1.record()
            e1.synchronize()
            if rc:
                raise RuntimeError(f"probe {name} ({kind}) launch failed: "
                                   f"{rc}")
            return int(cyc[0]), e0.elapsed_time(e1)

        lat = [run(which, 1, LANES, CHAIN_STEPS) for _ in range(4)][1:]
        cycles = sorted(c for c, _ in lat)[1]
        ms = sorted(m for _, m in lat)[1]
        run(which + 2, 1, 1, SPLIT_STEPS)
        split = {p: float(v) / SPLIT_STEPS
                 for p, v in zip(parts, cyc.tolist())}
        dump = sass_dir / f"{fn}.sass" if sass_dir is not None else None
        sass = sass_loop(src.with_suffix(".so"), fn, dump)
        ghz = cycles / (ms * 1e6)
        out[name] = {
            "cycles_a_step": cycles / CHAIN_STEPS,
            "ns_a_step": 1e6 * ms / CHAIN_STEPS,
            "ghz": ghz,
            "sass_a_step": sass["static"],
            "sass_fewest_a_step": sass["fewest"],
            "issue_ns_a_stream_step": sass["fewest"]
            / (SCHEDULERS * LANES * ghz),
            "split_cycles": split,
            "split_sum": sum(split.values()),
        }
    return out


def bound_ms(floor: dict, B: int, n: int) -> dict:
    """The three terms of the recurrence kernels' bound for B streams of n
    steps (ms): the chain floor x n, the bytes (16 a step a stream) over
    the memory rate, and the issue term x B x n; the largest and its
    name ("chain", "bytes" or "issue"), and the stream counts from which
    the bytes and the issue terms pass the chain."""
    terms = {"chain": floor["ns_a_step"] * n * 1e-6,
             "bytes": BYTES_A_STEP * B * n / HBM_BYTES_PER_S * 1e3,
             "issue": floor["issue_ns_a_stream_step"] * B * n * 1e-6}
    by = max(terms, key=terms.get)
    return {"bound_ms": terms[by], "bound_by": by,
            **{f"{k}_ms": v for k, v in terms.items()},
            "bytes_from_B": floor["ns_a_step"] * 1e-9 * HBM_BYTES_PER_S
            / BYTES_A_STEP,
            "issue_from_B": floor["ns_a_step"]
            / floor["issue_ns_a_stream_step"]}
