// Dense streaming FIR on float32 re/im planes, for Hopper (sm_90a).
//
//   y[n] = sum_{k < T} taps[k] * x[n - k]          (real or complex taps)
//
// with x[n < 0] read from the carried context, the 1024 samples before
// the block (ctx[1024 + n]; only the last T - 1 count).  Replaces the TPU
// kernel comms_tpu/kernels/fir_pallas.py::fir_planar_pallas (and, through
// the wrapper, fir_block_pallas); comms_tpu_torch/kernels/fir.py holds the
// wrapper and the plain version.
//
// Bound on the H100: it reads 8 bytes and writes 8 per complex sample and
// does 2T (real taps) or 4T (complex taps) FMAs per sample: 64 at the
// QPSK matched filter's 32 real taps, so device memory bounds it there
// (about 0.16 ms for 33.5M samples at 3.35 TB/s); long complex filters
// (the 257- and 1025-tap limits) move the bound to the CUDA cores and the
// shared-memory loads that feed them.  Design: one thread block owns
// kOut = 1024 consecutive outputs and stages their window (kOut plus the
// taps' look-back, rounded up to a multiple of 4) of both planes in
// shared memory, phase-major (window sample i at [i % 4][i / 4]).  Each
// thread computes 4 consecutive outputs and keeps their 4 input samples
// in registers, sliding them down by one per tap, so a tap costs one
// shared-memory load per plane (conflict-free: all threads read one phase
// at consecutive words) and one broadcast tap load for 8 (16) FMAs.  Each
// output is one FMA chain over k = 0..T-1 in that order, the same wherever
// the stream was cut into blocks, so chopping a stream reproduces the
// one-shot output bit for bit.  The TPU kernel's [rows, 128] views, 8-row
// halo DMAs, aligned band matrix and bf16x3 split products are not
// carried over: everything is float32 on the CUDA cores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPer = 4;                       // outputs per thread
constexpr int kOut = kThreads * kPer;         // outputs per block
constexpr int kCtx = 1024;                    // carried context samples

template <bool kComplex>
__global__ void fir_kernel(const float* __restrict__ xr,
                           const float* __restrict__ xi,
                           const float* __restrict__ ctx_r,
                           const float* __restrict__ ctx_i,
                           const float* __restrict__ taps_r,
                           const float* __restrict__ taps_i, int T,
                           int64_t n, float* __restrict__ yr,
                           float* __restrict__ yi) {
  extern __shared__ float smem[];
  const int H = (T - 1 + 3) & ~3;             // look-back, multiple of 4
  const int Q = (kOut + H) / 4;               // window words per phase
  float* s_hr = smem;
  float* s_hi = s_hr + T;
  float* s_xr = s_hi + (kComplex ? T : 0);
  float* s_xi = s_xr + 4 * Q;

  for (int k = threadIdx.x; k < T; k += kThreads) {
    s_hr[k] = taps_r[k];
    if (kComplex) s_hi[k] = taps_i[k];
  }
  const int64_t out0 = static_cast<int64_t>(blockIdx.x) * kOut;
  const int64_t n0 = out0 - H;                // window sample 0
  for (int i = threadIdx.x; i < 4 * Q; i += kThreads) {
    const int64_t m = n0 + i;
    float vr = 0.f, vi = 0.f;
    if (m >= 0) {
      if (m < n) {
        vr = xr[m];
        vi = xi[m];
      }
    } else if (m >= -kCtx) {
      vr = ctx_r[kCtx + m];
      vi = ctx_i[kCtx + m];
    }
    s_xr[(i & 3) * Q + (i >> 2)] = vr;
    s_xi[(i & 3) * Q + (i >> 2)] = vi;
  }
  __syncthreads();

  // Output out0 + 4t + j reads window sample 4t + j + H - k.  Registers
  // r[j] hold sample 4t + j + H - k for the current tap k.
  const int t = threadIdx.x;
  float rr[kPer], ri[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = 4 * t + j + H;
    rr[j] = s_xr[(i & 3) * Q + (i >> 2)];
    ri[j] = s_xi[(i & 3) * Q + (i >> 2)];
  }
  float ar[kPer], ai[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) ar[j] = ai[j] = 0.f;
  for (int k = 0; k < T; ++k) {
    const float hr = s_hr[k];
    if (kComplex) {
      const float hi = s_hi[k];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        ar[j] = fmaf(hr, rr[j], ar[j]);
        ar[j] = fmaf(-hi, ri[j], ar[j]);
        ai[j] = fmaf(hr, ri[j], ai[j]);
        ai[j] = fmaf(hi, rr[j], ai[j]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        ar[j] = fmaf(hr, rr[j], ar[j]);
        ai[j] = fmaf(hr, ri[j], ai[j]);
      }
    }
    // slide: sample 4t + j + H - (k + 1)
#pragma unroll
    for (int j = kPer - 1; j > 0; --j) {
      rr[j] = rr[j - 1];
      ri[j] = ri[j - 1];
    }
    const int i = 4 * t + H - k - 1;          // >= 4t + H - T >= -1
    if (i >= 0) {
      rr[0] = s_xr[(i & 3) * Q + (i >> 2)];
      ri[0] = s_xi[(i & 3) * Q + (i >> 2)];
    }
  }
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int64_t o = out0 + 4 * t + j;
    if (o < n) {
      yr[o] = ar[j];
      yi[o] = ai[j];
    }
  }
}

}  // namespace

// Dynamic shared memory of one launch, in bytes.
extern "C" int64_t fir_smem_bytes(int T, int complex_taps) {
  const int64_t H = (T - 1 + 3) & ~3;
  return static_cast<int64_t>(sizeof(float)) *
         (T * (complex_taps ? 2 : 1) + 2 * (kOut + H));
}

// C entry for ctypes.  Pointers on the current device: xr/xi [n],
// ctx_r/ctx_i [1024] (the samples before the block), taps_r (and taps_i
// when complex) [T], yr/yi [n].  1 <= T <= 1025.  Launches on `stream`
// without synchronising; returns cudaGetLastError() (or the error that
// stopped the launch).
extern "C" int fir_launch(const void* xr, const void* xi, const void* ctx_r,
                          const void* ctx_i, const void* taps_r,
                          const void* taps_i, int T, int complex_taps,
                          int64_t n, void* yr, void* yi, void* stream) {
  if (T < 1 || T > kCtx + 1 || n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = fir_smem_bytes(T, complex_taps);
  const unsigned grid = static_cast<unsigned>((n + kOut - 1) / kOut);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (complex_taps) {
    err = cudaFuncSetAttribute(fir_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fir_kernel<true><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(xr), static_cast<const float*>(xi),
        static_cast<const float*>(ctx_r), static_cast<const float*>(ctx_i),
        static_cast<const float*>(taps_r), static_cast<const float*>(taps_i),
        T, n, static_cast<float*>(yr), static_cast<float*>(yi));
  } else {
    err = cudaFuncSetAttribute(fir_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    fir_kernel<false><<<grid, kThreads, smem, s>>>(
        static_cast<const float*>(xr), static_cast<const float*>(xi),
        static_cast<const float*>(ctx_r), static_cast<const float*>(ctx_i),
        static_cast<const float*>(taps_r), nullptr, T, n,
        static_cast<float*>(yr), static_cast<float*>(yi));
  }
  return static_cast<int>(cudaGetLastError());
}
