// The receive chain's two sequential loops, for Hopper (sm_90a): the
// decision-directed Costas loop (comms_tpu/ops/demodulation.py::
// costas_loop_block) and the per-sample log-domain AGC (comms_tpu/ops/
// agc.py::agc_scan), each over a batch of B independent streams in one
// launch.  Neither replaces a Pallas kernel: in the JAX package both are
// lax.scan loops (under jax.vmap, one loop with a [B] carry), whose carried
// value feeds the next step through a nonlinear function, so a stream has
// no parallel form.  comms_tpu_torch/kernels/recurrence.py holds the
// wrappers, the vmap rule and the plain versions.
//
// Costas loop of order M, per symbol s (complex, float32 throughout):
//   c   = s * e^{-j ph}
//   err = atan2(Im, Re)(-c^M) / M,   c^M by XLA's integer_pow (binary
//                                    powers: c^4 = (c*c)*(c*c))
//   fr  = fr + beta*err
//   ph  = (ph + fr) + alpha*err      (ph is never wrapped, as in JAX)
//   out = c
// AGC, per sample s, gain g:
//   y   = s * g
//   err = log(target / (|y| + 1e-12))
//   g   = g * exp(rate*err)
//   out = y
//
// Every product and sum is rounded as written (__fmul_rn/__fadd_rn/
// __fsub_rn/__fdiv_rn: no FMA contraction), the complex products in XLA's
// order (ar*br - ai*bi, ar*bi + ai*br), and sincosf, atan2f, hypotf, logf
// and expf are CUDA's accurate ones (no --use_fast_math), so each lane
// computes what the plain versions (one PyTorch operation a step) compute.
//
// Design: one lane a stream.  A stream's steps form one dependent chain
// (each step needs the previous step's state), so a second thread on a
// stream would only wait; the parallelism is across streams.  A block
// serves 128 streams with 4 compute warps, one a scheduler (at most one
// block an SM fits the shared memory below), so every lane keeps the
// single stream's step time up to 132 x 4 x 32 = 16,896 streams.  The
// single-stream entry is this kernel at B = 1.
//
// Staging.  At one step the 32 lanes of a compute warp read 32 different
// rows, so direct loads would be uncoalesced and on the chain.  Each
// compute warp has a staging warp on its own scheduler (warp w + 4 of the
// block's 8): it copies the compute warp's next [32 streams x 32 steps]
// tile of both input planes into shared memory, double-buffered, with
// 4-byte cp.async (row r of the tile one instruction, lane l its column
// l: coalesced whatever the strides), and stores the previous tile of
// outputs, which the compute warp wrote into shared memory a step at a
// time, to the [B, n] output planes, row by row, coalesced.  The two warps
// meet once a 32-step chunk at a named barrier.  cp.async and not a TMA
// tile: the planes come with any row and element stride (the stride-2
// re/im views of a complex tensor, the row stride 0 of a stream-invariant
// input that vmap expands), which a TMA descriptor (16-byte aligned base
// and strides) does not take.  A separate warp and not the compute warp
// itself: a warp issues in order, so its own copies and stores, spread
// over the steps or in a burst at each chunk, sat in the chain's issue
// stream and stretched it (tools/recurrence_compare.py's first variants,
// PERF.md); the scheduler issues the staging warp's instructions in the
// cycles the compute warp spends waiting on its chain.  The compute warp
// keeps one shared load and one shared store a plane a step; a tile row
// holds 33 floats, so its column reads and writes (bank (l + t) mod 32)
// and the staging warp's row copies (bank (t + l) mod 32) never conflict.
// Lanes past the last stream repeat the warp's first stream, so a partial
// warp never diverges, and store nothing.  The carried state is [B]
// float32 on the device, read and written there, so a call never
// synchronises with the host.
//
// Bound (PERF.md, "Kernels with no Pallas counterpart"): the largest of
//   (a) the dependent chain: the step's time x n, measured by a kernel of
//       the step's arithmetic on register-resident data, no loads or
//       stores, one warp (tools/recurrence_floor.py, chain-only):
//       ~404 cycles (~205 ns) a Costas step, ~315 (~160 ns) an AGC step
//       on an H100 at 1.98 GHz, atan2f's two divisions half the Costas
//       step;
//   (b) 16 bytes a step a stream (read re, im; write re, im) over the
//       card's 3.35 TB/s: 0.0048 ns a stream-step;
//   (c) the step's instructions over the card's issue rate: the fewest
//       SASS instructions an iteration of that chain-only loop can issue
//       (the shortest path through its control flow, out-of-line slow
//       paths counted where a path calls them), a step's share, over one
//       warp instruction a cycle on each of 132 x 4 schedulers, 32
//       streams a warp instruction.
// (a) holds while every stream has a lane on a scheduler of its own
// warp, up to 16,896 streams; (b) passes it from ~43,000 streams
// (Costas) and ~33,000 (AGC), (c) later still (chip_smoke.py prints
// each term and the stream counts from its own run).

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kLanes = 32;                 // streams a warp, steps a chunk
constexpr int kWarps = 4;                  // compute warps, one a scheduler
constexpr int kThreads = 2 * kLanes * kWarps;   // and a staging warp each
constexpr int kStreams = kLanes * kWarps;  // streams a block
constexpr int kPitch = kLanes + 1;         // floats a tile row (padded)
constexpr int kTile = kLanes * kPitch;     // floats of one plane's tile
// a warp pair's tiles: in[buffer][plane] at 2*buffer + plane,
// out[buffer][plane] at 4 + 2*buffer + plane
constexpr int kWarpFloats = 8 * kTile;
constexpr int kSmemBytes =
    static_cast<int>(sizeof(float)) * kWarpFloats * kWarps;  // 135,168
constexpr int kUnroll = 4;                 // steps a loop iteration

// Element (b, k) of input plane q at x[q][b * rs[q] + k * es[q]]; the
// outputs are [B, n] row-major; state j of stream b at s_in[j][b * ss[j]]
// in, s_out[j][b] out.
struct Params {
  const float* x[2];
  int rs[2];
  int es[2];
  float* y[2];
  const float* s_in[2];
  int ss[2];
  float* s_out[2];
  int B;
  int n;
};

// (ar + j ai) * (br + j bi) in XLA's order, each step rounded.
__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi,
                                     float& cr, float& ci) {
  cr = __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
  ci = __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
}

// x^m, m >= 1, as XLA's integer_pow expands it: acc takes x at each set
// bit of m (acc * x), x squares between bits.
__device__ __forceinline__ void cpow(float xr, float xi, int m, float& yr,
                                     float& yi) {
  bool have = false;
  while (m > 0) {
    if (m & 1) {
      if (have) {
        cmul(yr, yi, xr, xi, yr, yi);
      } else {
        yr = xr;
        yi = xi;
        have = true;
      }
    }
    m >>= 1;
    if (m > 0) cmul(xr, xi, xr, xi, xr, xi);
  }
}

// One Costas step.  kOrder > 0: the order is known at compile time (4,
// QPSK: the power is two squarings, and the division by the order a
// product by its exact reciprocal, which rounds identically); kOrder == 0:
// any order, from ``order``.
template <int kOrder>
struct CostasStep {
  static constexpr int kStates = 2;   // phase, frequency
  int order;
  float alpha, beta;
  __device__ __forceinline__ void operator()(float sr, float si,
                                             float (&st)[2], float& ar,
                                             float& ai) const {
    float s, c;
    sincosf(st[0], &s, &c);
    // (sr + j si) * (c - j s)
    ar = __fadd_rn(__fmul_rn(sr, c), __fmul_rn(si, s));
    ai = __fsub_rn(__fmul_rn(si, c), __fmul_rn(sr, s));
    float qr, qi;
    cpow(ar, ai, kOrder > 0 ? kOrder : order, qr, qi);
    const float a = atan2f(-qi, -qr);
    const float err = kOrder == 4
                          ? __fmul_rn(a, 0.25f)
                          : __fdiv_rn(a, static_cast<float>(order));
    st[1] = __fadd_rn(st[1], __fmul_rn(beta, err));
    st[0] = __fadd_rn(__fadd_rn(st[0], st[1]), __fmul_rn(alpha, err));
  }
};

struct AgcStep {
  static constexpr int kStates = 1;   // gain
  float target, rate;
  __device__ __forceinline__ void operator()(float sr, float si,
                                             float (&st)[1], float& ar,
                                             float& ai) const {
    ar = __fmul_rn(sr, st[0]);
    ai = __fmul_rn(si, st[0]);
    const float mag = __fadd_rn(hypotf(ar, ai), 1e-12f);
    const float err = logf(__fdiv_rn(target, mag));
    st[0] = __fmul_rn(st[0], expf(__fmul_rn(rate, err)));
  }
};

// A 4-byte global -> shared copy when ``pred`` (the copy's own
// predicate).
__device__ __forceinline__ void cp_async4(bool pred, float* dst,
                                          const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile(
      "{\n\t.reg .pred p;\n\tsetp.ne.b32 p, %2, 0;\n\t"
      "@p cp.async.ca.shared.global [%0], [%1], 4;\n\t}\n" ::"r"(d),
      "l"(src), "r"(static_cast<int>(pred)));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                   "memory");
}

// The compute warp and its staging warp (2 x 32 threads) meet.
__device__ __forceinline__ void pair_sync(int id) {
  asm volatile("barrier.sync %0, %1;\n" ::"r"(id), "r"(2 * kLanes)
               : "memory");
}

// The staging warp: chunk c's column ``lane`` of the warp's ``rows``
// streams into input buffer c & 1 ...
__device__ __forceinline__ void stage_in(const Params& p, float* tile, int c,
                                         int rows, int lane, const float* x0,
                                         const float* x1) {
  float* in_r = tile + (2 * (c & 1)) * kTile + lane;
  const int col = c * kLanes + lane;
  const bool ok = col < p.n;
  const float* g_r = x0 + static_cast<long long>(col) * p.es[0];
  const float* g_i = x1 + static_cast<long long>(col) * p.es[1];
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    cp_async4(ok, in_r + r * kPitch, g_r + static_cast<long long>(r) * p.rs[0]);
    cp_async4(ok, in_r + kTile + r * kPitch,
              g_i + static_cast<long long>(r) * p.rs[1]);
  }
}

// ... and chunk c's outputs, from output buffer c & 1, to the planes.
__device__ __forceinline__ void stage_out(const Params& p, const float* tile,
                                          int c, int rows, int lane,
                                          float* y0, float* y1) {
  const float* out_r = tile + (4 + 2 * (c & 1)) * kTile + lane;
  const int col = c * kLanes + lane;
  if (col >= p.n) return;
#pragma unroll 4
  for (int r = 0; r < rows; ++r) {
    y0[static_cast<long long>(r) * p.n + col] = out_r[r * kPitch];
    y1[static_cast<long long>(r) * p.n + col] = out_r[kTile + r * kPitch];
  }
}

// The compute warp: ``steps`` steps of chunk c, the lane's stream (row
// ``me``) from input buffer c & 1, its outputs (row ``lane``) into output
// buffer c & 1.
template <class Step>
__device__ __forceinline__ void run_chunk(const Step& step,
                                          float (&st)[Step::kStates],
                                          float* tile, int c, int steps,
                                          int lane, int me) {
  const float* in_r = tile + (2 * (c & 1)) * kTile + me * kPitch;
  const float* in_i = in_r + kTile;
  float* out_r = tile + (4 + 2 * (c & 1)) * kTile + lane * kPitch;
  float* out_i = out_r + kTile;
#pragma unroll kUnroll
  for (int t = 0; t < steps; ++t) {
    float ar, ai;
    step(in_r[t], in_i[t], st, ar, ai);
    out_r[t] = ar;
    out_i[t] = ai;
  }
}

// The body of both kernels: compute warp w (and staging warp w + 4) of
// block b serve streams [32 (4b + w), 32 (4b + w) + 32) of the batch.  The
// pair meets at barrier B_0 (chunk 0 staged) and B_{c+1} (chunk c
// computed, chunk c+1 staged, chunk c-1's outputs stored).
template <class Step>
__device__ __forceinline__ void walk(const Params& p, const Step& step) {
  extern __shared__ float smem[];
  const int warp = threadIdx.x / kLanes;
  const int pair = warp % kWarps;
  const bool stager = warp >= kWarps;
  const int lane = threadIdx.x % kLanes;
  const int row0 = (blockIdx.x * kWarps + pair) * kLanes;
  if (row0 >= p.B) return;
  const int rows = min(kLanes, p.B - row0);
  const int chunks = (p.n + kLanes - 1) / kLanes;
  const int bar = 1 + pair;
  float* const tile = smem + pair * kWarpFloats;
  if (stager) {
    const float* const x0 = p.x[0] + static_cast<long long>(row0) * p.rs[0];
    const float* const x1 = p.x[1] + static_cast<long long>(row0) * p.rs[1];
    float* const y0 = p.y[0] + static_cast<long long>(row0) * p.n;
    float* const y1 = p.y[1] + static_cast<long long>(row0) * p.n;
    if (chunks > 0) stage_in(p, tile, 0, rows, lane, x0, x1);
    cp_async_wait_all();
    pair_sync(bar);
    for (int c = 0; c < chunks; ++c) {
      if (c + 1 < chunks) stage_in(p, tile, c + 1, rows, lane, x0, x1);
      if (c > 0) stage_out(p, tile, c - 1, rows, lane, y0, y1);
      cp_async_wait_all();
      pair_sync(bar);
    }
    if (chunks > 0) stage_out(p, tile, chunks - 1, rows, lane, y0, y1);
    return;
  }
  const bool live = lane < rows;
  const int me = live ? lane : 0;   // a lane past the last stream repeats
  float st[Step::kStates];
#pragma unroll
  for (int j = 0; j < Step::kStates; ++j) {
    st[j] = p.s_in[j][static_cast<long long>(row0 + me) * p.ss[j]];
  }
  pair_sync(bar);
  for (int c = 0; c < chunks; ++c) {
    if (c + 1 < chunks) {
      run_chunk(step, st, tile, c, kLanes, lane, me);
    } else {
      run_chunk(step, st, tile, c, p.n - c * kLanes, lane, me);
    }
    pair_sync(bar);
  }
  if (live) {
#pragma unroll
    for (int j = 0; j < Step::kStates; ++j) p.s_out[j][row0 + lane] = st[j];
  }
}

template <int kOrder>
__global__ void __launch_bounds__(kThreads, 1)
    costas_loop_kernel(const __grid_constant__ Params p, int order,
                       float alpha, float beta) {
  walk(p, CostasStep<kOrder>{order, alpha, beta});
}

__global__ void __launch_bounds__(kThreads, 1)
    agc_scan_kernel(const __grid_constant__ Params p, float target,
                    float rate) {
  walk(p, AgcStep{target, rate});
}

constexpr long long kIntMax = 0x7fffffffLL;

bool fits(long long v) { return v >= 0 && v <= kIntMax; }

// Params from the C entries' arguments; false if a size or a stride does
// not fit the kernel's 32-bit fields (products are taken in 64 bits).
bool make_params(Params& p, const void* xr, const void* xi, long long xr_rs,
                 long long xr_es, long long xi_rs, long long xi_es,
                 long long B, long long n, void* yr, void* yi) {
  if (!fits(B) || !fits(n + 2 * kLanes) || !fits(xr_rs) || !fits(xr_es) ||
      !fits(xi_rs) || !fits(xi_es)) {
    return false;
  }
  p.x[0] = static_cast<const float*>(xr);
  p.x[1] = static_cast<const float*>(xi);
  p.rs[0] = static_cast<int>(xr_rs);
  p.rs[1] = static_cast<int>(xi_rs);
  p.es[0] = static_cast<int>(xr_es);
  p.es[1] = static_cast<int>(xi_es);
  p.y[0] = static_cast<float*>(yr);
  p.y[1] = static_cast<float*>(yi);
  p.B = static_cast<int>(B);
  p.n = static_cast<int>(n);
  return true;
}

// The kernels' instantiations (costas_loop_kernel<4>, <0>, agc_scan_kernel)
// and the devices whose dynamic shared-memory limit each has been raised
// on: cudaFuncSetAttribute runs once a kernel and device, not on every
// launch (host work on the launch path).
constexpr int kKernels = 3;
constexpr int kMaxDevices = 64;
std::atomic<bool> smem_set[kKernels][kMaxDevices];

template <class Kernel>
cudaError_t allow_smem(Kernel kernel, int which) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const bool known = dev >= 0 && dev < kMaxDevices;
  if (known && smem_set[which][dev].load(std::memory_order_acquire)) {
    return cudaSuccess;
  }
  err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemBytes);
  if (err == cudaSuccess && known) {
    smem_set[which][dev].store(true, std::memory_order_release);
  }
  return err;
}

template <class Kernel, class... Args>
int launch(Kernel kernel, int which, const Params& p, void* stream,
           Args... args) {
  if (p.B == 0) return static_cast<int>(cudaSuccess);
  const cudaError_t err = allow_smem(kernel, which);
  if (err != cudaSuccess) return static_cast<int>(err);
  const unsigned blocks =
      static_cast<unsigned>((static_cast<long long>(p.B) + kStreams - 1) /
                            kStreams);
  kernel<<<blocks, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      p, args...);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int costas_loop_launch(
    const void* xr, const void* xi, long long xr_rs, long long xr_es,
    long long xi_rs, long long xi_es, long long B, long long n,
    const void* ph_in, long long ph_stride, const void* fr_in,
    long long fr_stride, int order, float alpha, float beta, void* yr,
    void* yi, void* ph_out, void* fr_out, void* stream) {
  Params p = {};
  if (order < 1 || !fits(ph_stride) || !fits(fr_stride) ||
      !make_params(p, xr, xi, xr_rs, xr_es, xi_rs, xi_es, B, n, yr, yi)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.s_in[0] = static_cast<const float*>(ph_in);
  p.s_in[1] = static_cast<const float*>(fr_in);
  p.ss[0] = static_cast<int>(ph_stride);
  p.ss[1] = static_cast<int>(fr_stride);
  p.s_out[0] = static_cast<float*>(ph_out);
  p.s_out[1] = static_cast<float*>(fr_out);
  return order == 4
             ? launch(costas_loop_kernel<4>, 0, p, stream, order, alpha, beta)
             : launch(costas_loop_kernel<0>, 1, p, stream, order, alpha,
                      beta);
}

extern "C" int agc_scan_launch(
    const void* xr, const void* xi, long long xr_rs, long long xr_es,
    long long xi_rs, long long xi_es, long long B, long long n,
    const void* g_in, long long g_stride, float target, float rate,
    void* yr, void* yi, void* g_out, void* stream) {
  Params p = {};
  if (!fits(g_stride) ||
      !make_params(p, xr, xi, xr_rs, xr_es, xi_rs, xi_es, B, n, yr, yi)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  p.s_in[0] = static_cast<const float*>(g_in);
  p.ss[0] = static_cast<int>(g_stride);
  p.s_out[0] = static_cast<float*>(g_out);
  return launch(agc_scan_kernel, 2, p, stream, target, rate);
}
