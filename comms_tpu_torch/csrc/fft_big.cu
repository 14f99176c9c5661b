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
// Bound on the H100: the PSD reads each input sample once (8 bytes) plus
// the window, and the FFT also writes 8 bytes per sample; both are
// memory-bound (about 5 log2(N) + 8 flops per sample).  The four-step
// split adds D's round trip through device memory (8 bytes written in
// stage A, 8 read in stage B per sample).  Design:
// - Stage A: one thread block of 512 threads per (column tile of ct = 32
//   columns up to n1 = 512, 16 at 1024, 8 at 2048; segment).  It reads
//   the tile's rows coalesced (rows of [n1, n2] are contiguous along n2;
//   the pre-blocked [n2/128, n1, 128] layout is read by index arithmetic,
//   no relayout copy), subtracts the means and applies the window on the
//   way into shared memory, transposed so that each column is one
//   transform (padded rows: conflict-free), runs the shared-memory FFT of
//   fft_smem.cuh, multiplies by W_N^{(i2 k1) mod N} and writes D as
//   [segment, k1, n2], so that stage B reads contiguous rows.  The
//   twiddle's index i2 * k1 < N is an integer; its value is the product
//   of two float64-made tables, W_N^{hi * 2048} * W_N^{lo}, so no angle
//   is ever a float product.  With sparse demean it also writes the
//   tile's raw sums (the means' numerators).
// - Stage B, PSD: one block per group of k1 rows; it loops over all
//   segments in order and keeps its bins' sums in registers, so the sum
//   over segments is deterministic without a second pass.  Sparse
//   demean subtracts m * W at the window's few edge bins (FFT linearity:
//   |FFT(w (x - m))|^2 = |FFT(w x) - m FFT(w)|^2).
// - Stage B, FFT: one block per (group of k1 rows, segment); it writes
//   X[k1 + n1 k2] in natural order.
// The TPU kernel's manual DMA rings, k1-tile-blocked D layout, Karatsuba
// bf16x3 DFT matmuls and in-VMEM transposes are not carried over;
// everything is float32 on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_smem.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kLog2L = 11;                    // low twiddle table: 2048

int ilog2(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

bool factor_ok(int v) {
  return v == 256 || v == 512 || v == 1024 || v == 2048;
}

int rows_psd(int n2) { return n2 >= 1024 ? 4 : 4096 / n2; }

int rows_fft(int n2) { return n2 >= 512 ? 8 : 4096 / n2; }

template <int KPT>
__global__ void __launch_bounds__(kThreads) stage_a_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    int64_t seg_stride, int blocked, int n1, int log2n1, int n2,
    int log2ct, const float* __restrict__ window,
    const float* __restrict__ means, const float* __restrict__ tw1r,
    const float* __restrict__ tw1i, const float* __restrict__ hir,
    const float* __restrict__ hii, const float* __restrict__ lor,
    const float* __restrict__ loi, float* __restrict__ dr,
    float* __restrict__ di, float* __restrict__ sums) {
  extern __shared__ float smem[];
  const int ct = 1 << log2ct;
  const int ld = n1 + 32 / ct;                // padded column stride
  float* sr = smem;
  float* si = smem + ct * ld;
  float* red = si + ct * ld;                  // [2][kWarps]
  const int tile = blockIdx.x;
  const int seg = blockIdx.y;
  const int col0 = tile * ct;
  const int64_t N = static_cast<int64_t>(n1) * n2;
  const int64_t base = seg * seg_stride;
  const float m_r = means ? means[2 * seg] : 0.f;
  const float m_i = means ? means[2 * seg + 1] : 0.f;
  float s_r = 0.f, s_i = 0.f;
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int c = e & (ct - 1);
    const int i1 = e >> log2ct;
    const int i2 = col0 + c;
    const int64_t a =
        blocked ? base + static_cast<int64_t>(i2 >> 7) * (n1 * 128) +
                      i1 * 128 + (i2 & 127)
                : base + static_cast<int64_t>(i1) * n2 + i2;
    float vr = xr[a], vi = xi[a];
    s_r += vr;
    s_i += vi;
    vr -= m_r;
    vi -= m_i;
    if (window) {
      const float w = window[static_cast<int64_t>(i1) * n2 + i2];
      vr *= w;
      vi *= w;
    }
    sr[c * ld + i1] = vr;
    si[c * ld + i1] = vi;
  }
  if (sums) {
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      s_r += __shfl_xor_sync(0xffffffffu, s_r, o);
      s_i += __shfl_xor_sync(0xffffffffu, s_i, o);
    }
    if ((threadIdx.x & 31) == 0) {
      red[threadIdx.x >> 5] = s_r;
      red[kWarps + (threadIdx.x >> 5)] = s_i;
    }
  }
  __syncthreads();
  if (sums && threadIdx.x == 0) {
    float t_r = 0.f, t_i = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      t_r += red[w];
      t_i += red[kWarps + w];
    }
    const int64_t o = (static_cast<int64_t>(seg) * gridDim.x + tile) * 2;
    sums[o] = t_r;
    sums[o + 1] = t_i;
  }
  fft_smem<KPT>(sr, si, n1, log2n1, ld, tw1r, tw1i, 1.f);
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int c = e & (ct - 1);
    const int k1 = e >> log2ct;
    const int m = (col0 + c) * k1;            // i2 * k1 < N <= 2^22
    const int hi = m >> kLog2L, lo = m & ((1 << kLog2L) - 1);
    const float h_r = __ldg(hir + hi), h_i = __ldg(hii + hi);
    const float l_r = __ldg(lor + lo), l_i = __ldg(loi + lo);
    const float w_r = h_r * l_r - h_i * l_i;
    const float w_i = h_r * l_i + h_i * l_r;
    const float v_r = sr[c * ld + k1], v_i = si[c * ld + k1];
    const int64_t o = seg * N + static_cast<int64_t>(k1) * n2 + col0 + c;
    dr[o] = v_r * w_r - v_i * w_i;
    di[o] = v_r * w_i + v_i * w_r;
  }
}

// Loads `rows` rows of D (k1 = k1_0 ..) of segment `seg` into shared
// memory, padded row stride ld, and transforms them.
template <int KPT>
__device__ __forceinline__ void stage_b_rows(
    const float* __restrict__ dr, const float* __restrict__ di, int64_t N,
    int seg, int k1_0, int n2, int log2n2, int ld,
    const float* __restrict__ tw2r, const float* __restrict__ tw2i,
    float* sr, float* si) {
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int r = e >> log2n2, i2 = e & (n2 - 1);
    const int64_t a = seg * N + static_cast<int64_t>(k1_0 + r) * n2 + i2;
    sr[r * ld + i2] = dr[a];
    si[r * ld + i2] = di[a];
  }
  __syncthreads();
  fft_smem<KPT>(sr, si, n2, log2n2, ld, tw2r, tw2i, 1.f);
}

template <int KPT>
__global__ void __launch_bounds__(kThreads) stage_b_psd_kernel(
    const float* __restrict__ dr, const float* __restrict__ di, int nseg,
    int n1, int log2n1, int n2, int log2n2, int log2rows,
    const float* __restrict__ tw2r, const float* __restrict__ tw2i,
    const int* __restrict__ sp_k, const float* __restrict__ sp_w, int nsp,
    const float* __restrict__ means, float* __restrict__ out) {
  extern __shared__ float smem[];
  const int rows = 1 << log2rows;
  const int ld = n2 + 32 / rows;
  float* sr = smem;
  float* si = smem + rows * ld;
  const int k1_0 = blockIdx.x * rows;
  const int64_t N = static_cast<int64_t>(n1) * n2;
  float acc[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) acc[k] = 0.f;
  for (int seg = 0; seg < nseg; ++seg) {
    stage_b_rows<KPT>(dr, di, N, seg, k1_0, n2, log2n2, ld, tw2r, tw2i, sr,
                      si);
    if (nsp) {
      if (threadIdx.x < nsp) {
        const int k = sp_k[threadIdx.x];
        const int r = (k & (n1 - 1)) - k1_0;
        if (r >= 0 && r < rows) {
          const int idx = r * ld + (k >> log2n1);
          const float mr = means[2 * seg], mi = means[2 * seg + 1];
          const float wr = sp_w[2 * threadIdx.x];
          const float wi = sp_w[2 * threadIdx.x + 1];
          sr[idx] -= mr * wr - mi * wi;
          si[idx] -= mr * wi + mi * wr;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int p = (e >> log2n2) * ld + (e & (n2 - 1));
      acc[k] += sr[p] * sr[p] + si[p] * si[p];
    }
    __syncthreads();
  }
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int e = threadIdx.x + k * kThreads;
    sr[(e >> log2n2) * ld + (e & (n2 - 1))] = acc[k];
  }
  __syncthreads();
  // Natural order k = k1 + n1 k2: consecutive threads take consecutive k1.
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int r = e & (rows - 1), k2 = e >> log2rows;
    out[k1_0 + r + static_cast<int64_t>(n1) * k2] = sr[r * ld + k2];
  }
}

template <int KPT>
__global__ void __launch_bounds__(kThreads) stage_b_fft_kernel(
    const float* __restrict__ dr, const float* __restrict__ di, int n1,
    int n2, int log2n2, int log2rows, const float* __restrict__ tw2r,
    const float* __restrict__ tw2i, float* __restrict__ yr,
    float* __restrict__ yi) {
  extern __shared__ float smem[];
  const int rows = 1 << log2rows;
  const int ld = n2 + 32 / rows;
  float* sr = smem;
  float* si = smem + rows * ld;
  const int k1_0 = blockIdx.x * rows;
  const int seg = blockIdx.y;
  const int64_t N = static_cast<int64_t>(n1) * n2;
  stage_b_rows<KPT>(dr, di, N, seg, k1_0, n2, log2n2, ld, tw2r, tw2i, sr,
                    si);
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const int r = e & (rows - 1), k2 = e >> log2rows;
    const int64_t o = seg * N + k1_0 + r + static_cast<int64_t>(n1) * k2;
    yr[o] = sr[r * ld + k2];
    yi[o] = si[r * ld + k2];
  }
}

template <typename K>
int prepare(K kernel, int smem) {
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem));
}

}  // namespace

// C entry for ctypes: stage A.  Pointers on the current device: xr/xi
// hold nseg segments, segment s at s * seg_stride, each [n1, n2] (or, with
// `blocked`, [n2/128, n1, 128]); ct the column-tile width (32 up to
// n1 = 512, 16 at 1024, 8 at 2048); window [N] or null; means [nseg, 2] or
// null; tw1r/tw1i the n1-entry table W_n1^k; hir/hii [N / 2048] and
// lor/loi [2048] the tables W_N^{2048 j} and W_N^j; dr/di [nseg, n1, n2];
// sums [nseg, n2 / ct, 2] or null.  Launches on `stream` without
// synchronising; returns cudaGetLastError().
extern "C" int fft_big_stage_a_launch(
    const void* xr, const void* xi, int nseg, int64_t seg_stride,
    int blocked, int n1, int n2, int ct, const void* window,
    const void* means,
    const void* tw1r, const void* tw1i, const void* hir, const void* hii,
    const void* lor, const void* loi, void* dr, void* di, void* sums,
    void* stream) {
  const int S = ct * n1;
  if (nseg < 1 || nseg > 65535 || !factor_ok(n1) || !factor_ok(n2) ||
      seg_stride < 1 || (ct != 8 && ct != 16 && ct != 32) ||
      (S != 8192 && S != 16384)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = static_cast<int>(sizeof(float)) *
                   (2 * ct * (n1 + 32 / ct) + 2 * kWarps);
  const dim3 grid(n2 / ct, nseg);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
#define STAGE_A_ARGS                                                        \
  f(xr), f(xi), seg_stride, blocked, n1, ilog2(n1), n2, ilog2(ct),          \
      f(window), f(means), f(tw1r), f(tw1i), f(hir), f(hii), f(lor),        \
      f(loi), static_cast<float*>(dr), static_cast<float*>(di),             \
      static_cast<float*>(sums)
  int err;
  if (S == 8192) {
    if ((err = prepare(stage_a_kernel<16>, smem))) return err;
    stage_a_kernel<16><<<grid, kThreads, smem, s>>>(STAGE_A_ARGS);
  } else {
    if ((err = prepare(stage_a_kernel<32>, smem))) return err;
    stage_a_kernel<32><<<grid, kThreads, smem, s>>>(STAGE_A_ARGS);
  }
#undef STAGE_A_ARGS
  return static_cast<int>(cudaGetLastError());
}

// C entry for ctypes: stage B of the PSD.  dr/di [nseg, n1, n2] from stage
// A; tw2r/tw2i the n2-entry table W_n2^k; sp_k [nsp] bins and sp_w
// [nsp, 2] the window's spectrum there, with means [nseg, 2], for sparse
// demean (nsp = 0 and nulls otherwise); out [N], natural order.
extern "C" int fft_big_stage_b_psd_launch(
    const void* dr, const void* di, int nseg, int n1, int n2,
    const void* tw2r, const void* tw2i, const void* sp_k, const void* sp_w,
    int nsp, const void* means, void* out, void* stream) {
  if (nseg < 1 || !factor_ok(n1) || !factor_ok(n2) || nsp < 0 ||
      nsp > 32 || (nsp && (!sp_k || !sp_w || !means))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = rows_psd(n2);
  const int S = rows * n2;
  const int smem = static_cast<int>(sizeof(float)) * 2 * rows *
                   (n2 + 32 / rows);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
#define STAGE_B_PSD_ARGS                                                    \
  f(dr), f(di), nseg, n1, ilog2(n1), n2, ilog2(n2), ilog2(rows), f(tw2r),   \
      f(tw2i), static_cast<const int*>(sp_k), f(sp_w), nsp, f(means),       \
      static_cast<float*>(out)
  int err;
  if (S == 4096) {
    if ((err = prepare(stage_b_psd_kernel<8>, smem))) return err;
    stage_b_psd_kernel<8><<<n1 / rows, kThreads, smem, s>>>(
        STAGE_B_PSD_ARGS);
  } else {
    if ((err = prepare(stage_b_psd_kernel<16>, smem))) return err;
    stage_b_psd_kernel<16><<<n1 / rows, kThreads, smem, s>>>(
        STAGE_B_PSD_ARGS);
  }
#undef STAGE_B_PSD_ARGS
  return static_cast<int>(cudaGetLastError());
}

// C entry for ctypes: stage B of the FFT.  dr/di [nseg, n1, n2] from
// stage A; yr/yi [nseg, N], natural order.
extern "C" int fft_big_stage_b_fft_launch(const void* dr, const void* di,
                                          int nseg, int n1, int n2,
                                          const void* tw2r,
                                          const void* tw2i, void* yr,
                                          void* yi, void* stream) {
  if (nseg < 1 || nseg > 65535 || !factor_ok(n1) || !factor_ok(n2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int rows = rows_fft(n2);
  const int S = rows * n2;
  const int smem = static_cast<int>(sizeof(float)) * 2 * rows *
                   (n2 + 32 / rows);
  const dim3 grid(n1 / rows, nseg);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
#define STAGE_B_FFT_ARGS                                                    \
  f(dr), f(di), n1, n2, ilog2(n2), ilog2(rows), f(tw2r), f(tw2i),           \
      static_cast<float*>(yr), static_cast<float*>(yi)
  int err;
  if (S == 4096) {
    if ((err = prepare(stage_b_fft_kernel<8>, smem))) return err;
    stage_b_fft_kernel<8><<<grid, kThreads, smem, s>>>(STAGE_B_FFT_ARGS);
  } else if (S == 8192) {
    if ((err = prepare(stage_b_fft_kernel<16>, smem))) return err;
    stage_b_fft_kernel<16><<<grid, kThreads, smem, s>>>(STAGE_B_FFT_ARGS);
  } else {
    if ((err = prepare(stage_b_fft_kernel<32>, smem))) return err;
    stage_b_fft_kernel<32><<<grid, kThreads, smem, s>>>(STAGE_B_FFT_ARGS);
  }
#undef STAGE_B_FFT_ARGS
  return static_cast<int>(cudaGetLastError());
}
