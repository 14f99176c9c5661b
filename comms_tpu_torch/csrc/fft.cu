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
// every size (0.08 ms for 16,777,216 samples at 3.35 TB/s).
//
// Design: every transform runs in registers on the register FFT of
// fft_reg.cuh, 16 points a thread, T = n / 16 threads a row.  Thread t of
// row r loads the points t + T q (q < 16) straight from the planes into
// registers (consecutive lanes on consecutive points: a warp reads 128
// contiguous bytes a plane, two 64-byte runs at n = 256), runs the passes
// (radix 16/16/(n / 256) up to 2048 points, 16/16/16/(n / 4096) above,
// with one to three padded, conflict-free float2 exchanges through shared
// memory, and one table twiddle a butterfly whose powers are products:
// the core's kPowers), and stores its outputs X[t + T q], which the core
// leaves in natural order, the same way, times `scale`.  Nothing is
// staged in shared memory for the load or the store.  A block is
// max(128, T) threads: 2048 / n rows up to 2048 points, one row above.
// At the cap of 64 registers that __launch_bounds__ sets an SM holds 1024
// threads (8 blocks of 128 .. one of 1024); their shared memory, pad(n)
// float2 a row, fits beside (139,264 bytes an SM at every size).  A
// row-strided input is read in place; the output is contiguous.  The TPU
// kernel's row tiles, 128-lane four-step split, bf16x3 DFT matmuls and
// natural-order unshuffle are not carried over: everything is float32 on
// the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_reg.cuh"

namespace {

using fft_reg_detail::kPoints;
using fft_reg_detail::pad;

constexpr int kMinThreads = 128;

__host__ __device__ constexpr int block_threads(int n) {
  return n / kPoints > kMinThreads ? n / kPoints : kMinThreads;
}

template <int N>
__global__ void __launch_bounds__(block_threads(N), 1024 / block_threads(N))
    fft_rows_kernel(const float* __restrict__ xr,
                    const float* __restrict__ xi, int64_t rows,
                    int64_t stride, const float2* __restrict__ tw,
                    float scale, float* __restrict__ yr,
                    float* __restrict__ yi) {
  constexpr int T = N / kPoints;
  constexpr int ROWS = block_threads(N) / T;
  extern __shared__ float2 smem[];
  const int t = threadIdx.x % T;
  const int r = threadIdx.x / T;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * ROWS + r;
  // A tail block's missing rows transform zeros: every thread takes part
  // in the exchanges' barriers.
  const bool ok = row < rows;
  const float* a = xr + row * stride + t;
  const float* b = xi + row * stride + t;
  float vr[kPoints], vi[kPoints];
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    vr[q] = ok ? __ldg(a + T * q) : 0.f;
    vi[q] = ok ? __ldg(b + T * q) : 0.f;
  }
  fft_reg<N, true>(vr, vi, t, smem + r * pad(N), tw);
  if (!ok) return;
  float* c = yr + row * N + t;
  float* d = yi + row * N + t;
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    c[T * q] = vr[q] * scale;
    d[T * q] = vi[q] * scale;
  }
}

template <int N>
int launch(const float* xr, const float* xi, int64_t rows, int64_t stride,
           const float2* tw, float scale, float* yr, float* yi,
           cudaStream_t s) {
  constexpr int THREADS = block_threads(N);
  constexpr int ROWS = THREADS * kPoints / N;
  const int smem = ROWS * pad(N) * static_cast<int>(sizeof(float2));
  cudaError_t err = cudaFuncSetAttribute(
      fft_rows_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t grid = (rows + ROWS - 1) / ROWS;
  if (grid > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  fft_rows_kernel<N><<<static_cast<unsigned>(grid), THREADS, smem, s>>>(
      xr, xi, rows, stride, tw, scale, yr, yi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  Pointers on the current device: xr/xi [rows, n]
// at row stride `stride` floats (unit sample stride, the same for both),
// yr/yi [rows, n] contiguous; tw the n-entry table W_n^k as (re, im)
// pairs.  n a power of two in 256..16384, rows >= 1, stride >= 1 (rows
// may overlap, as unfold's views do).
// Launches on `stream` without synchronising; returns cudaGetLastError()
// (or the error that stopped the launch).
extern "C" int fft_launch(const void* xr, const void* xi, int64_t rows,
                          int64_t stride, int n, const void* tw,
                          float scale, void* yr, void* yi, void* stream) {
  if (rows < 1 || stride < 1) return static_cast<int>(cudaErrorInvalidValue);
  const auto* a = static_cast<const float*>(xr);
  const auto* b = static_cast<const float*>(xi);
  const auto* w = static_cast<const float2*>(tw);
  auto* c = static_cast<float*>(yr);
  auto* d = static_cast<float*>(yi);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 256: return launch<256>(a, b, rows, stride, w, scale, c, d, s);
    case 512: return launch<512>(a, b, rows, stride, w, scale, c, d, s);
    case 1024: return launch<1024>(a, b, rows, stride, w, scale, c, d, s);
    case 2048: return launch<2048>(a, b, rows, stride, w, scale, c, d, s);
    case 4096: return launch<4096>(a, b, rows, stride, w, scale, c, d, s);
    case 8192: return launch<8192>(a, b, rows, stride, w, scale, c, d, s);
    case 16384: return launch<16384>(a, b, rows, stride, w, scale, c, d, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
