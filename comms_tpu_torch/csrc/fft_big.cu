// Large-N FFT and Welch numerator by the four-step split N = n1 * n2, for
// Hopper (sm_90a).  Replaces the three pallas_calls of the TPU kernel
// comms_tpu/kernels/fft_big_pallas.py: _stageA (column FFT + twiddle),
// the stage B of psd_big_pallas_planar (row FFT, |.|^2 summed over the
// segments, optional sparse demean) and the stage B of
// fft_big_pallas_planar (row FFT, natural order);
// comms_tpu_torch/kernels/fft_big.py holds the wrappers and the plain
// versions.  With x[n], n = i1*n2 + i2, viewed as A[i1, i2]:
//
//   stage A  D[k1, i2] = W_N^{i2 k1} * sum_i1 A'[i1, i2] W_n1^{i1 k1}
//            A' = (A - mean) * window, both optional
//   stage B  X[k1 + n1 k2] = sum_i2 D[k1, i2] W_n2^{i2 k2}
//
// n1, n2 in 256..2048 (the TPU kernel's _prep admits 4096..16384, which its
// stages do not support; the wrapper raises for them).
//
// What bounds it on the H100.  About 5 log2(N) + 10 flops per sample
// against 16..24 bytes moved: memory-bound, 3.35 TB/s.  The two-pass
// split moves D through device memory once more (8 bytes written in
// stage A, 8 read in stage B per sample), so a two-launch design's floor
// is 32 bytes per sample for the FFT (0.3205 ms at 2^20 x 32) and 24 for
// the PSD (0.2404 ms).  The first port (one shared-memory Stockham core,
// fft_smem.cuh) ran at 29-36% of the memory rate: one 128 KB block per
// SM running load, ten barriered radix-4 passes and store strictly in
// turn, 4-way bank conflicts, and the PSD's stage B as 256 blocks
// walking all segments in series.  What is left (PERF.md): each block
// still loads, transforms and stores in turn, and at 64 registers a
// thread an SM holds 32 warps: each stage moves about two thirds of the
// memory rate.
//
// The design here:
// - The transforms run in registers (fft_reg.cuh): 16 points a thread,
//   radix-16/16/(2,4,8) passes, one or two padded, conflict-free float2
//   exchanges through shared memory per transform, the first pass fed
//   straight from the loads and the last pass's outputs used straight
//   from registers.  Complex values that the kernels own (D, the twiddle
//   tables, the exchanges) are float2 (re, im) pairs: one 8-byte access
//   each.
// - Stage A: one block per (tile of ct columns, segment), ct * n1 = 8192
//   points (512 threads, two blocks an SM) or 16384 (1024 threads, one
//   block): ct = max(8, 8192 / n1) (fft_big._col_tile), so every row of a
//   tile is read in runs of at least 32 bytes (one sector; shorter runs
//   were slower on the card).  Lanes run over consecutive columns (the three ingest
//   layouts by index arithmetic, no relayout copy); demean, window and
//   the raw sums are applied on the way into registers; the twiddle
//   W_N^{(i2 k1) mod N} in registers.  A tile of 32 columns of 1024..2048
//   points (256..512 KB) does not fit an SM; a tile's neighbours are read
//   by neighbouring blocks at the same time, through the L2.
// - D is written tile-blocked, [segment, n2 / ct, n1, ct]: a tile's
//   output is one contiguous run, and stage B reads each row group of a
//   tile as contiguous runs.
// - Stage B, FFT: one block per (group of rows k1, segment), rows =
//   max(8, 8192 / n2); the natural-order output X[k1 + n1 k2] goes
//   through a shared-memory transpose, so each store writes runs of
//   `rows` consecutive k1, a sector or more (half-sector runs were far
//   slower on the card).
// - Stage B, PSD: one block per (group of rows, group of segments): it
//   walks its segments in order, loads the next segment's rows while it
//   transforms this one, and sums |.|^2 in its own shared-memory slots
//   (sparse demean: subtract m * W at the window's few edge bins, by FFT
//   linearity |FFT(w (x - m))|^2 = |FFT(w x) - m FFT(w)|^2); it writes a
//   partial [n1, n2] in row order, and a second launch adds the partials
//   in order and transposes to natural order.  No float atomics: two
//   calls give bit-identical results.
// The twiddles come from float64-made tables at integer indices: W_n^k
// for the passes, and W_N^{i2 k1} as the product of two tables,
// W_N^{hi * 2048} * W_N^{lo}, so no angle is ever a float product.  The
// TPU kernel's manual DMA rings, Karatsuba bf16x3 DFT matmuls and in-VMEM
// transposes are not carried over; everything is float32 on the CUDA
// cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_reg.cuh"

namespace {

using fft_reg_detail::kPoints;
using fft_reg_detail::pad;

constexpr int kLog2L = 11;                    // low twiddle table: 2048
constexpr int kPsdThreads = 512;

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

bool factor_ok(int v) {
  return v == 256 || v == 512 || v == 1024 || v == 2048;
}

// Exchange region strides in float2 (fft_reg.cuh, "Bank conflicts").
__host__ __device__ constexpr int a_ld(int n, int ct) {
  return pad(n) + 16 / (ct < 16 ? ct : 16);
}

__host__ __device__ constexpr int b_ld(int n) { return pad(n); }

// float2 of stage B's shared memory: the exchange regions of `rows`
// transforms, or the output transpose [n2][rows + 1].
__host__ __device__ constexpr int b_plane(int n, int rows) {
  return rows * b_ld(n) > n * (rows + 1) ? rows * b_ld(n) : n * (rows + 1);
}

struct StageAArgs {
  const float* xr;
  const float* xi;
  int64_t seg_stride;
  int blocked;
  int n2;
  const float* window;
  const float* means;
  const float2* tw1;
  const float2* hi;
  const float2* lo;
  float2* d;
  float* sums;
};

template <int N1, int THREADS>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
    stage_a_kernel(const StageAArgs p) {
  constexpr int T = N1 / kPoints;             // threads per column
  constexpr int CT = THREADS / T;             // columns per tile
  constexpr int LD = a_ld(N1, CT);
  constexpr int kWarps = THREADS / 32;
  extern __shared__ float2 smem[];
  float* red = reinterpret_cast<float*>(smem + CT * LD);   // [2][kWarps]
  const int tid = threadIdx.x;
  const int c = tid % CT;
  const int t = tid / CT;
  const int tile = blockIdx.x;
  const int seg = blockIdx.y;
  const int i2 = tile * CT + c;
  const int n2 = p.n2;
  const int64_t N = static_cast<int64_t>(N1) * n2;
  const int64_t col = p.blocked
                          ? static_cast<int64_t>(i2 >> 7) * (N1 * 128) +
                                (i2 & 127)
                          : i2;
  const int rstride = p.blocked ? 128 : n2;
  const float* xr = p.xr + seg * p.seg_stride + col;
  const float* xi = p.xi + seg * p.seg_stride + col;
  const float m_r = p.means ? p.means[2 * seg] : 0.f;
  const float m_i = p.means ? p.means[2 * seg + 1] : 0.f;
  float vr[kPoints], vi[kPoints];
  float s_r = 0.f, s_i = 0.f;
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    const int i1 = t + T * q;
    float ar = xr[static_cast<int64_t>(i1) * rstride];
    float ai = xi[static_cast<int64_t>(i1) * rstride];
    s_r += ar;
    s_i += ai;
    ar -= m_r;
    ai -= m_i;
    if (p.window) {
      const float w = __ldg(p.window + i1 * n2 + i2);
      ar *= w;
      ai *= w;
    }
    vr[q] = ar;
    vi[q] = ai;
  }
  if (p.sums) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s_r += __shfl_xor_sync(0xffffffffu, s_r, o);
      s_i += __shfl_xor_sync(0xffffffffu, s_i, o);
    }
    if ((tid & 31) == 0) {
      red[tid >> 5] = s_r;
      red[kWarps + (tid >> 5)] = s_i;
    }
  }
  // fft_reg synchronises the block before its first read, so `red` is
  // complete when it returns.
  fft_reg<N1>(vr, vi, t, smem + c * LD, p.tw1);
  if (p.sums && tid == 0) {
    float t_r = 0.f, t_i = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      t_r += red[w];
      t_i += red[kWarps + w];
    }
    const int64_t o = (static_cast<int64_t>(seg) * gridDim.x + tile) * 2;
    p.sums[o] = t_r;
    p.sums[o + 1] = t_i;
  }
  // D tile-blocked: [segment, n2 / CT, n1, CT]
  const int64_t o = seg * N + static_cast<int64_t>(tile) * (N1 * CT) + c;
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    const int k1 = t + T * q;
    const int m = i2 * k1;                    // i2 * k1 < N <= 2^22
    const int hi = m >> kLog2L, lo = m & ((1 << kLog2L) - 1);
    const float2 h = __ldg(p.hi + hi), l = __ldg(p.lo + lo);
    const float w_r = h.x * l.x - h.y * l.y;
    const float w_i = h.x * l.y + h.y * l.x;
    p.d[o + k1 * CT] =
        make_float2(vr[q] * w_r - vi[q] * w_i, vr[q] * w_i + vi[q] * w_r);
  }
}

// Stage B's lanes: 16 consecutive points t of one row, then the next
// rows, then the higher t; it reads row k1 of segment base `d` of the
// tile-blocked D (tile width 2^log2ct) into registers, point t + T q in
// slot q.
template <int N2, int THREADS>
struct RowLanes {
  static constexpr int T = N2 / kPoints;
  static constexpr int ROWS = THREADS / T;
  int r, t;
  __device__ explicit RowLanes(int tid)
      : r((tid >> 4) % ROWS), t((tid & 15) + 16 * (tid / (16 * ROWS))) {}
  __device__ void load(const float2* __restrict__ d, int64_t base, int n1,
                       int log2ct, int k1, float (&vr)[kPoints],
                       float (&vi)[kPoints]) const {
    const int64_t tile = static_cast<int64_t>(n1) << log2ct;
    const int64_t row = base + (static_cast<int64_t>(k1) << log2ct);
    const int cmask = (1 << log2ct) - 1;
#pragma unroll
    for (int q = 0; q < kPoints; ++q) {
      const int i2 = t + T * q;
      const int64_t a = row + (i2 >> log2ct) * tile + (i2 & cmask);
      const float2 v = d[a];
      vr[q] = v.x;
      vi[q] = v.y;
    }
  }
};

struct StageBArgs {
  const float2* d;
  int n1;
  int log2ct;
  const float2* tw2;
  float* yr;
  float* yi;
};

template <int N2, int THREADS>
__global__ void __launch_bounds__(THREADS, 1024 / THREADS)
    stage_b_fft_kernel(const StageBArgs p) {
  using L = RowLanes<N2, THREADS>;
  constexpr int ROWS = L::ROWS;
  constexpr int LD = b_ld(N2);
  constexpr int LT = ROWS + 1;
  extern __shared__ float2 smem[];
  const L lanes(threadIdx.x);
  const int k1_0 = blockIdx.x * ROWS;
  const int64_t N = static_cast<int64_t>(p.n1) * N2;
  const int64_t base = blockIdx.y * N;
  float vr[kPoints], vi[kPoints];
  lanes.load(p.d, base, p.n1, p.log2ct, k1_0 + lanes.r, vr, vi);
  fft_reg<N2>(vr, vi, lanes.t, smem + lanes.r * LD, p.tw2);
  // transpose through shared memory: [k2][rows + 1]
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    smem[(lanes.t + L::T * q) * LT + lanes.r] = make_float2(vr[q], vi[q]);
  }
  __syncthreads();
  float* yr = p.yr + base + k1_0;
  float* yi = p.yi + base + k1_0;
#pragma unroll
  for (int k = 0; k < kPoints; ++k) {
    const int e = threadIdx.x + k * THREADS;
    const int r = e % ROWS, k2 = e / ROWS;
    const float2 v = smem[k2 * LT + r];
    yr[r + static_cast<int64_t>(p.n1) * k2] = v.x;
    yi[r + static_cast<int64_t>(p.n1) * k2] = v.y;
  }
}

struct StageBPsdArgs {
  const float2* d;
  int nseg;
  int seg_per_block;
  int n1;
  int log2n1;
  int log2ct;
  const float2* tw2;
  const int* sp_k;
  const float* sp_w;
  int nsp;
  const float* means;
  float* part;
};

template <int N2>
__global__ void __launch_bounds__(kPsdThreads, 1)
    stage_b_psd_kernel(const StageBPsdArgs p) {
  using L = RowLanes<N2, kPsdThreads>;
  constexpr int ROWS = L::ROWS;
  constexpr int LD = b_ld(N2);
  extern __shared__ float2 smem[];
  float* acc = reinterpret_cast<float*>(smem + ROWS * LD);   // own slots
  const L lanes(threadIdx.x);
  const int k1 = blockIdx.x * ROWS + lanes.r;
  const int64_t N = static_cast<int64_t>(p.n1) * N2;
  const int s0 = blockIdx.y * p.seg_per_block;
  const int s1 = min(p.nseg, s0 + p.seg_per_block);
#pragma unroll
  for (int q = 0; q < kPoints; ++q) acc[threadIdx.x + kPsdThreads * q] = 0.f;
  // the next segment's rows are loaded while this one is transformed
  float nr[kPoints], ni[kPoints];
  lanes.load(p.d, s0 * N, p.n1, p.log2ct, k1, nr, ni);
  for (int seg = s0; seg < s1; ++seg) {
    // A fresh copy of the lane map each segment: the compiler cannot hoist
    // the loads' and the exchanges' addresses out of the loop, which held
    // them all in registers and spilled.
    L ln = lanes;
    asm volatile("" : "+r"(ln.t), "+r"(ln.r));
    float vr[kPoints], vi[kPoints];
#pragma unroll
    for (int q = 0; q < kPoints; ++q) {
      vr[q] = nr[q];
      vi[q] = ni[q];
    }
    if (seg + 1 < s1) {
      ln.load(p.d, (seg + 1) * N, p.n1, p.log2ct,
              blockIdx.x * ROWS + ln.r, nr, ni);
    }
    fft_reg<N2>(vr, vi, ln.t, smem + ln.r * LD, p.tw2);
    for (int i = 0; i < p.nsp; ++i) {
      const int k = p.sp_k[i];
      if ((k & (p.n1 - 1)) != k1) continue;
      const int k2 = k >> p.log2n1;
      const float mr = p.means[2 * seg], mi = p.means[2 * seg + 1];
      const float wr = p.sp_w[2 * i], wi = p.sp_w[2 * i + 1];
      const float cr = mr * wr - mi * wi, ci = mr * wi + mi * wr;
#pragma unroll
      for (int q = 0; q < kPoints; ++q) {
        if (ln.t + L::T * q == k2) {
          vr[q] -= cr;
          vi[q] -= ci;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < kPoints; ++q) {
      acc[threadIdx.x + kPsdThreads * q] += vr[q] * vr[q] + vi[q] * vi[q];
    }
  }
  float* out = p.part + blockIdx.y * N + static_cast<int64_t>(k1) * N2;
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    out[lanes.t + L::T * q] = acc[threadIdx.x + kPsdThreads * q];
  }
}

// out[k1 + n1 k2] = sum over p in order of part[p, k1, k2]; 32 x 32
// tiles through shared memory, blocks of 32 x 8 threads.
__global__ void __launch_bounds__(256) stage_b_reduce_kernel(
    const float* __restrict__ part, int P, int n1, int n2,
    float* __restrict__ out) {
  __shared__ float tile[32][33];
  const int k2_0 = blockIdx.x * 32, k1_0 = blockIdx.y * 32;
  const int64_t N = static_cast<int64_t>(n1) * n2;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = threadIdx.y + 8 * j;
    const float* src =
        part + static_cast<int64_t>(k1_0 + r) * n2 + k2_0 + threadIdx.x;
    float s = 0.f;
    for (int q = 0; q < P; ++q) s += src[q * N];
    tile[r][threadIdx.x] = s;
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k2 = k2_0 + threadIdx.y + 8 * j;
    out[k1_0 + threadIdx.x + static_cast<int64_t>(n1) * k2] =
        tile[threadIdx.x][threadIdx.y + 8 * j];
  }
}

template <typename K>
int prepare(K kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

template <int N1, int THREADS>
int launch_a(const StageAArgs& a, int nseg, cudaStream_t s) {
  constexpr int CT = THREADS * kPoints / N1;
  const int smem = static_cast<int>(sizeof(float)) *
                   (2 * CT * a_ld(N1, CT) + 2 * (THREADS / 32));
  int err;
  if ((err = prepare(stage_a_kernel<N1, THREADS>, smem))) return err;
  stage_a_kernel<N1, THREADS>
      <<<dim3(a.n2 / CT, nseg), THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int THREADS>
int launch_a_n(int n1, const StageAArgs& a, int nseg, cudaStream_t s) {
  switch (n1) {
    case 256: return launch_a<256, THREADS>(a, nseg, s);
    case 512: return launch_a<512, THREADS>(a, nseg, s);
    case 1024: return launch_a<1024, THREADS>(a, nseg, s);
    default: return launch_a<2048, THREADS>(a, nseg, s);
  }
}

template <int N2, int THREADS>
int launch_b(const StageBArgs& a, int nseg, cudaStream_t s) {
  constexpr int ROWS = THREADS * kPoints / N2;
  const int smem =
      static_cast<int>(sizeof(float)) * 2 * b_plane(N2, ROWS);
  int err;
  if ((err = prepare(stage_b_fft_kernel<N2, THREADS>, smem))) return err;
  stage_b_fft_kernel<N2, THREADS>
      <<<dim3(a.n1 / ROWS, nseg), THREADS, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int THREADS>
int launch_b_n(int n2, const StageBArgs& a, int nseg, cudaStream_t s) {
  switch (n2) {
    case 256: return launch_b<256, THREADS>(a, nseg, s);
    case 512: return launch_b<512, THREADS>(a, nseg, s);
    case 1024: return launch_b<1024, THREADS>(a, nseg, s);
    default: return launch_b<2048, THREADS>(a, nseg, s);
  }
}

template <int N2>
int launch_psd(const StageBPsdArgs& a, int groups, cudaStream_t s) {
  constexpr int ROWS = kPsdThreads * kPoints / N2;
  const int smem = static_cast<int>(sizeof(float)) *
                   (2 * ROWS * b_ld(N2) + kPoints * kPsdThreads);   // float2
  int err;
  if ((err = prepare(stage_b_psd_kernel<N2>, smem))) return err;
  stage_b_psd_kernel<N2>
      <<<dim3(a.n1 / ROWS, groups), kPsdThreads, smem, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes: stage A.  Pointers on the current device: xr/xi
// hold nseg segments, segment s at s * seg_stride, each [n1, n2] (or, with
// `blocked`, [n2/128, n1, 128]); ct the column-tile width, ct * n1 = 8192
// (512 threads a block) or 16384 (1024); window [N] or null; means
// [nseg, 2] or null; tw1 the n1-entry table W_n1^k, hi [N / 2048] and lo
// [2048] the tables W_N^{2048 j} and W_N^j, all (re, im) pairs; d
// [nseg, n2 / ct, n1, ct] (re, im) pairs; sums [nseg, n2 / ct, 2] or null.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int fft_big_stage_a_launch(
    const void* xr, const void* xi, int nseg, int64_t seg_stride,
    int blocked, int n1, int n2, int ct, const void* window,
    const void* means, const void* tw1, const void* hi, const void* lo,
    void* d, void* sums, void* stream) {
  const int S = ct * n1;
  if (nseg < 1 || nseg > 65535 || !factor_ok(n1) || !factor_ok(n2) ||
      seg_stride < 1 || ct < 4 || ct > 64 || ct > n2 ||
      (S != 8192 && S != 16384)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto c = [](const void* p) { return static_cast<const float2*>(p); };
  const StageAArgs a{f(xr), f(xi), seg_stride, blocked, n2, f(window),
                     f(means), c(tw1), c(hi), c(lo),
                     static_cast<float2*>(d), static_cast<float*>(sums)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return S == 8192 ? launch_a_n<512>(n1, a, nseg, s)
                   : launch_a_n<1024>(n1, a, nseg, s);
}

// C entry for ctypes: stage B of the PSD, two launches.  d the
// tile-blocked D from stage A (tile width ct); seg_per_block segments per
// block, so P = ceil(nseg / seg_per_block) partial sums; tw2 the n2-entry
// table W_n2^k; sp_k [nsp] bins and sp_w [nsp, 2] the window's spectrum
// there, with means [nseg, 2], for sparse demean (nsp = 0 and nulls
// otherwise); part [P, n1, n2] scratch; out [N], natural order.
extern "C" int fft_big_stage_b_psd_launch(
    const void* d, int nseg, int n1, int n2, int ct, int seg_per_block,
    const void* tw2, const void* sp_k, const void* sp_w, int nsp,
    const void* means, void* part, void* out, void* stream) {
  if (nseg < 1 || !factor_ok(n1) || !factor_ok(n2) || nsp < 0 ||
      nsp > 32 || (nsp && (!sp_k || !sp_w || !means)) || ct < 4 ||
      ct > 64 || (ct & (ct - 1)) || seg_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int groups = (nseg + seg_per_block - 1) / seg_per_block;
  if (groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const StageBPsdArgs a{static_cast<const float2*>(d), nseg, seg_per_block,
                        n1, ilog2(n1), ilog2(ct),
                        static_cast<const float2*>(tw2),
                        static_cast<const int*>(sp_k), f(sp_w), nsp,
                        f(means), static_cast<float*>(part)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  int err;
  switch (n2) {
    case 256: err = launch_psd<256>(a, groups, s); break;
    case 512: err = launch_psd<512>(a, groups, s); break;
    case 1024: err = launch_psd<1024>(a, groups, s); break;
    default: err = launch_psd<2048>(a, groups, s); break;
  }
  if (err) return err;
  stage_b_reduce_kernel<<<dim3(n2 / 32, n1 / 32), dim3(32, 8), 0, s>>>(
      static_cast<const float*>(part), groups, n1, n2,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}

// C entry for ctypes: stage B of the FFT.  d the tile-blocked D from stage
// A (tile width ct); rows * n2 = 8192 (512 threads a block) or 16384
// (1024); tw2 the n2-entry table; yr/yi [nseg, N], natural order.
extern "C" int fft_big_stage_b_fft_launch(const void* d, int nseg, int n1,
                                          int n2, int ct, int rows,
                                          const void* tw2, void* yr,
                                          void* yi, void* stream) {
  const int S = rows * n2;
  if (nseg < 1 || nseg > 65535 || !factor_ok(n1) || !factor_ok(n2) ||
      ct < 4 || ct > 64 || (ct & (ct - 1)) || rows > n1 ||
      (S != 8192 && S != 16384)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const StageBArgs a{static_cast<const float2*>(d), n1, ilog2(ct),
                     static_cast<const float2*>(tw2),
                     static_cast<float*>(yr), static_cast<float*>(yi)};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return S == 8192 ? launch_b_n<512>(n2, a, nseg, s)
                   : launch_b_n<1024>(n2, a, nseg, s);
}
