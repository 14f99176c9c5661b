// Batched natural-order complex FFT of float32 re/im rows, for Hopper
// (sm_90a).  Replaces the TPU kernel
// comms_tpu/kernels/fft_pallas.py::fft_pallas_planar (and, through the
// wrapper, fft_pallas); comms_tpu_torch/kernels/fft.py holds the wrapper
// and the plain version.
//
//   y[r, k] = scale * sum_t x[r, t] * e^{-2 pi i t k / n},  n = 256..16384
//
// Bound on the H100: it reads 8 and writes 8 bytes per complex sample and
// does about 5 n log2(n) flops per row, so device memory bounds it at
// every size (0.08 ms for 16,777,216 samples at 3.35 TB/s).  Design: one
// thread block of 512 threads owns S = max(n, 4096) samples, that is
// S / n whole rows; it loads them coalesced into shared memory, runs the
// shared-memory Stockham FFT of fft_smem.cuh on them (scale folded into
// the last pass) and stores them coalesced.  A row is one transform: the
// TPU kernel's row tiles, 128-lane four-step split, bf16x3 DFT matmuls
// and natural-order unshuffle are not carried over; everything is
// float32 on the CUDA cores.  n = 16384 takes 128 KB of shared memory per
// block, hence the opt-in attribute below.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_smem.cuh"

namespace {

constexpr int kThreads = 512;

template <int KPT>
__global__ void __launch_bounds__(kThreads)
    fft_rows_kernel(const float* __restrict__ xr, const float* __restrict__ xi,
                    int64_t rows, int n, int log2n,
                    const float* __restrict__ twr,
                    const float* __restrict__ twi, float scale,
                    float* __restrict__ yr, float* __restrict__ yi) {
  extern __shared__ float smem[];
  constexpr int S = kThreads * KPT;
  float* sr = smem;
  float* si = smem + S;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * (S >> log2n);
  const int64_t off = row0 << log2n;
  const int64_t total = rows << log2n;
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int e = threadIdx.x + k * kThreads;
    const bool ok = off + e < total;
    sr[e] = ok ? xr[off + e] : 0.f;
    si[e] = ok ? xi[off + e] : 0.f;
  }
  __syncthreads();
  fft_smem<KPT>(sr, si, n, log2n, n, twr, twi, scale);
#pragma unroll
  for (int k = 0; k < KPT; ++k) {
    const int e = threadIdx.x + k * kThreads;
    if (off + e < total) {
      yr[off + e] = sr[e];
      yi[off + e] = si[e];
    }
  }
}

template <int KPT>
int launch(const float* xr, const float* xi, int64_t rows, int n, int log2n,
           const float* twr, const float* twi, float scale, float* yr,
           float* yi, cudaStream_t s) {
  constexpr int S = kThreads * KPT;
  const int smem = 2 * S * static_cast<int>(sizeof(float));
  cudaError_t err = cudaFuncSetAttribute(
      fft_rows_kernel<KPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t per = S / n;
  const unsigned grid = static_cast<unsigned>((rows + per - 1) / per);
  fft_rows_kernel<KPT><<<grid, kThreads, smem, s>>>(
      xr, xi, rows, n, log2n, twr, twi, scale, yr, yi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  Pointers on the current device: xr/xi and yr/yi
// [rows, n] contiguous; twr/twi the n-entry table W_n^k.  n a power of two
// in 256..16384, rows >= 1.  Launches on `stream` without synchronising;
// returns cudaGetLastError() (or the error that stopped the launch).
extern "C" int fft_launch(const void* xr, const void* xi, int64_t rows,
                          int n, const void* twr, const void* twi,
                          float scale, void* yr, void* yi, void* stream) {
  int log2n = 0;
  while ((1 << log2n) < n) ++log2n;
  if (rows < 1 || n < 256 || n > 16384 || (1 << log2n) != n) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto* a = static_cast<const float*>(xr);
  const auto* b = static_cast<const float*>(xi);
  const auto* wr = static_cast<const float*>(twr);
  const auto* wi = static_cast<const float*>(twi);
  auto* c = static_cast<float*>(yr);
  auto* d = static_cast<float*>(yi);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  // S = max(n, 4096) samples per block, 512 threads.
  if (n <= 4096) {
    return launch<8>(a, b, rows, n, log2n, wr, wi, scale, c, d, s);
  }
  if (n == 8192) {
    return launch<16>(a, b, rows, n, log2n, wr, wi, scale, c, d, s);
  }
  return launch<32>(a, b, rows, n, log2n, wr, wi, scale, c, d, s);
}
