// Welch accumulation over segments of float32 re/im planes, for Hopper
// (sm_90a).  Replaces the two PSD entries of the TPU kernel
// comms_tpu/kernels/fft_pallas.py: psd_pallas_planar (explicit segment
// rows, optional row weights) and psd_stream_pallas_planar (50%-overlap
// segments of a flat stream); comms_tpu_torch/kernels/fft.py holds the
// wrappers and the plain versions.
//
//   acc[k] = sum_r | sum_t (w_r x[r, t] - m_r) win[t] e^{-2 pi i t k / n} |^2
//
// with segment r at x + r * row_stride (row_stride = n for segment rows,
// n / 2 for the stream), w_r the row weight (1 without weights) and m_r
// the mean of w_r x[r, :] when demeaning (0 otherwise).
//
// Bound on the H100: the stream entry reads each sample once (8 bytes)
// and does two FFTs per sample (about 10 log2(n) + 16 flops), so device
// memory bounds it (0.04 ms for 16,777,216 samples at 3.35 TB/s; the
// FFTs are about 1.7 GFLOP at n = 1024, under the CUDA cores' rate).
// Design: a thread block of 512 threads owns a fixed run of tiles of
// S = max(n, 4096) / n segments.  Per tile it loads the segments into
// shared memory (consecutive segments of the stream overlap by half, so
// the second read of a sample comes from L1/L2, not device memory),
// takes each segment's mean (per-thread chunk sums, warp shuffles, a
// fixed tree), demeans and windows in place, runs the shared-memory FFT
// of fft_smem.cuh, and adds |X|^2 into registers.  After its run it sums
// its tiles' rows per bin into a partial row; psd_reduce_kernel adds the
// partial rows bin by bin in a fixed order.  No float atomics: two runs
// give bit-identical sums.  The TPU kernel's Z-order accumulator, its
// DMA ring over 8-row halos and its zero-weighted final odd segment are
// not carried over (the stream entry simply runs 2N/n - 1 segments).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_smem.cuh"

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kReduceGroups = 16;

template <int KPT>
__global__ void __launch_bounds__(kThreads)
    psd_partial_kernel(const float* __restrict__ xr,
                       const float* __restrict__ xi, int64_t rows,
                       int64_t row_stride, int n, int log2n,
                       const float* __restrict__ win,
                       const float* __restrict__ row_w, int demean,
                       const float* __restrict__ twr,
                       const float* __restrict__ twi, int64_t tiles,
                       int tiles_per_block, float* __restrict__ part) {
  extern __shared__ float smem[];
  constexpr int S = kThreads * KPT;
  float* sr = smem;
  float* si = smem + S;
  float* red_r = si + S;                      // [kWarps]
  float* red_i = red_r + kWarps;
  float* mean_r = red_i + kWarps;             // [S / 256]
  float* mean_i = mean_r + S / 256;
  const int B = S >> log2n;                   // segments per tile
  const int P = n / KPT;                      // threads per segment, >= 32
  float acc[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) acc[k] = 0.f;

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * tiles_per_block;
  const int64_t t1 = t0 + tiles_per_block < tiles ? t0 + tiles_per_block
                                                  : tiles;
  for (int64_t t = t0; t < t1; ++t) {
    const int64_t row0 = t * B;
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const int64_t r = row0 + (e >> log2n);
      float vr = 0.f, vi = 0.f;
      if (r < rows) {
        const int64_t a = r * row_stride + (e & (n - 1));
        const float w = row_w ? row_w[r] : 1.f;
        vr = xr[a] * w;
        vi = xi[a] * w;
      }
      sr[e] = vr;
      si[e] = vi;
    }
    __syncthreads();
    if (demean) {
      // Thread tid sums KPT consecutive samples of segment tid / P,
      // starting at a rotated offset to spread the shared-memory banks.
      const int seg = threadIdx.x / P;
      const int c0 = seg * n + (threadIdx.x % P) * KPT;
      float s_r = 0.f, s_i = 0.f;
#pragma unroll
      for (int k = 0; k < KPT; ++k) {
        const int c = c0 + ((k + threadIdx.x) & (KPT - 1));
        s_r += sr[c];
        s_i += si[c];
      }
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        s_r += __shfl_xor_sync(0xffffffffu, s_r, o);
        s_i += __shfl_xor_sync(0xffffffffu, s_i, o);
      }
      if ((threadIdx.x & 31) == 0) {
        red_r[threadIdx.x >> 5] = s_r;
        red_i[threadIdx.x >> 5] = s_i;
      }
      __syncthreads();
      if (threadIdx.x < B) {
        const int W = P / 32;                 // warps per segment
        float m_r = 0.f, m_i = 0.f;
        for (int w = 0; w < W; ++w) {
          m_r += red_r[threadIdx.x * W + w];
          m_i += red_i[threadIdx.x * W + w];
        }
        mean_r[threadIdx.x] = m_r / static_cast<float>(n);
        mean_i[threadIdx.x] = m_i / static_cast<float>(n);
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int e = threadIdx.x + k * kThreads;
      const float w = win[e & (n - 1)];
      const float m_r = demean ? mean_r[e >> log2n] : 0.f;
      const float m_i = demean ? mean_i[e >> log2n] : 0.f;
      sr[e] = (sr[e] - m_r) * w;
      si[e] = (si[e] - m_i) * w;
    }
    __syncthreads();
    fft_smem<KPT>(sr, si, n, log2n, n, twr, twi, 1.f);
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      const int e = threadIdx.x + k * kThreads;
      acc[k] += sr[e] * sr[e] + si[e] * si[e];
    }
    __syncthreads();
  }
  // Rows of the tile -> one partial row, bin by bin in row order.
#pragma unroll
  for (int k = 0; k < KPT; ++k) sr[threadIdx.x + k * kThreads] = acc[k];
  __syncthreads();
  for (int c = threadIdx.x; c < n; c += kThreads) {
    float s = 0.f;
    for (int b = 0; b < B; ++b) s += sr[b * n + c];
    part[static_cast<int64_t>(blockIdx.x) * n + c] = s;
  }
}

// out[c] = sum over the G partial rows of part[:, c]: kReduceGroups
// threads per bin each add a fixed contiguous range of rows in order,
// then the first adds the groups' sums in order.
__global__ void psd_reduce_kernel(const float* __restrict__ part, int G,
                                  int n, float* __restrict__ out) {
  __shared__ float red[kReduceGroups][32];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int per = (G + kReduceGroups - 1) / kReduceGroups;
  const int g0 = threadIdx.y * per;
  const int g1 = g0 + per < G ? g0 + per : G;
  float s = 0.f;
  for (int g = g0; g < g1; ++g) s += part[static_cast<int64_t>(g) * n + c];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0) {
    float t = 0.f;
    for (int y = 0; y < kReduceGroups; ++y) t += red[y][threadIdx.x];
    out[c] = t;
  }
}

template <int KPT>
int launch(const float* xr, const float* xi, int64_t rows,
           int64_t row_stride, int n, int log2n, const float* win,
           const float* row_w, int demean, const float* twr,
           const float* twi, float* part, int G, int tiles_per_block,
           float* out, cudaStream_t s) {
  constexpr int S = kThreads * KPT;
  const int smem = static_cast<int>(sizeof(float)) *
                   (2 * S + 2 * kWarps + 2 * (S / 256));
  cudaError_t err = cudaFuncSetAttribute(
      psd_partial_kernel<KPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t B = S / n;
  const int64_t tiles = (rows + B - 1) / B;
  if (static_cast<int64_t>(G - 1) * tiles_per_block >= tiles ||
      static_cast<int64_t>(G) * tiles_per_block < tiles) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  psd_partial_kernel<KPT><<<G, kThreads, smem, s>>>(
      xr, xi, rows, row_stride, n, log2n, win, row_w, demean, twr, twi,
      tiles, tiles_per_block, part);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  psd_reduce_kernel<<<n / 32, dim3(32, kReduceGroups), 0, s>>>(part, G, n,
                                                               out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  Pointers on the current device: xr/xi hold `rows`
// segments of n samples, segment r at r * row_stride; win [n]; row_w
// [rows] or null; twr/twi the n-entry table W_n^k; part [G, n] scratch;
// out [n].  The wrapper picks tiles_per_block and G = ceil(tiles /
// tiles_per_block) with tiles = ceil(rows / (max(n, 4096) / n)).  n a power
// of two in 256..16384.  Launches on `stream` without synchronising;
// returns cudaGetLastError() (or the error that stopped the launch).
extern "C" int psd_launch(const void* xr, const void* xi, int64_t rows,
                          int64_t row_stride, int n, const void* win,
                          const void* row_w, int demean, const void* twr,
                          const void* twi, void* part, int G,
                          int tiles_per_block, void* out, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if (rows < 1 || row_stride < 1 || n < 256 || n > 16384 ||
      (1 << log2n) != n || G < 1 || tiles_per_block < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* a = static_cast<const float*>(xr);
  const auto* b = static_cast<const float*>(xi);
  const auto* w = static_cast<const float*>(win);
  const auto* rw = static_cast<const float*>(row_w);
  const auto* t_r = static_cast<const float*>(twr);
  const auto* t_i = static_cast<const float*>(twi);
  auto* p = static_cast<float*>(part);
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (n <= 4096) {
    return launch<8>(a, b, rows, row_stride, n, log2n, w, rw, demean, t_r,
                     t_i, p, G, tiles_per_block, o, s);
  }
  if (n == 8192) {
    return launch<16>(a, b, rows, row_stride, n, log2n, w, rw, demean, t_r,
                      t_i, p, G, tiles_per_block, o, s);
  }
  return launch<32>(a, b, rows, row_stride, n, log2n, w, rw, demean, t_r,
                    t_i, p, G, tiles_per_block, o, s);
}
