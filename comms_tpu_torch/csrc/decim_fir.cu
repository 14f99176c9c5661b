// Decimating FIR on float32 re/im planes, for Hopper (sm_90a).
//
//   y[f] = sum_{t < MD} taps[t] * x[f*D - t]        (real or complex taps)
//
// with the taps zero-padded to MD = D*ceil(T/D), as
// comms_tpu_torch/ops/fir.py::decimating_branch_taps pads them, and
// x[n < 0] read from the carried context, ctx[ctx_len + n].  One kernel
// serves two TPU kernels' entries (comms_tpu_torch/kernels/decim_fir.py):
// comms_tpu/kernels/decim_fir_pallas.py::fir_decimate_planar_pallas
// (context one row of D*128 samples) and comms_tpu/kernels/
// poly_fir_pallas.py::poly_fir_pallas_planar (context 8*D*128 samples).
// Rows of a batch (blockIdx.y) are independent streams: the band
// monitor's channels run in one launch.
//
// Bound on the H100: per input sample it reads 8 bytes and writes 8/D;
// it does MD/D FMAs per plane and output sample (2*MD/D per input
// sample for real taps, twice that for complex ones): 16 per input
// sample for the band monitor's 32 taps at D = 4, so device memory
// bounds it there; long filters (the K3 entry's 641 taps) move the bound
// to the CUDA cores and the shared-memory loads feeding them.  The design
// reads each input sample from device memory about once: one thread block
// owns kOut consecutive outputs, stages their window of (kOut-1)*D + MD
// samples in shared memory, stored phase-major (sample i at
// [i % D][i / D]) so that consecutive threads read consecutive words for
// every tap, conflict-free, with no division in the tap loop.  Each
// output is one thread's FMA chain over t = 0..MD-1, in that order and
// independent of where the stream was cut into blocks, so chopping a
// stream reproduces the one-shot output bit for bit.  The TPU kernel's
// wide-row layout, 8-row halo alignment and bf16x3 split products are
// not carried over; complex taps are a plain complex MAC.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <bool kComplex>
__global__ void decim_fir_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ ctx_r, const float* __restrict__ ctx_i,
    int ctx_len, const float* __restrict__ taps_r,
    const float* __restrict__ taps_i, int MD, int D, int64_t n_in,
    int64_t n_out, float* __restrict__ yr, float* __restrict__ yi) {
  extern __shared__ float smem[];
  const int k_out = blockDim.x;
  const int M = MD / D;
  const int L = k_out - 1 + M;      // window words per phase
  float* s_hr = smem;
  float* s_hi = s_hr + MD;
  float* s_xr = s_hi + (kComplex ? MD : 0);
  float* s_xi = s_xr + D * L;

  const int64_t row = blockIdx.y;
  xr += row * n_in;
  xi += row * n_in;
  ctx_r += row * ctx_len;
  ctx_i += row * ctx_len;
  yr += row * n_out;
  yi += row * n_out;

  for (int t = threadIdx.x; t < MD; t += k_out) {
    s_hr[t] = taps_r[t];
    if (kComplex) s_hi[t] = taps_i[t];
  }
  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * k_out;
  const int64_t n0 = f0 * D - (MD - 1);
  // Window sample i = (q, p) with i = q*D + p goes to [p][q].
  for (int q = threadIdx.x; q < L; q += k_out) {
    for (int p = 0; p < D; ++p) {
      const int64_t n = n0 + static_cast<int64_t>(q) * D + p;
      float vr = 0.f, vi = 0.f;
      if (n >= 0) {
        if (n < n_in) {
          vr = xr[n];
          vi = xi[n];
        }
      } else {
        vr = ctx_r[ctx_len + n];
        vi = ctx_i[ctx_len + n];
      }
      s_xr[p * L + q] = vr;
      s_xi[p * L + q] = vi;
    }
  }
  __syncthreads();

  const int f = threadIdx.x;
  if (f0 + f >= n_out) return;
  // Output f0 + f reads window sample f*D + MD-1 - t = (f + q)*D + p
  // with MD-1 - t = q*D + p: t = 0..MD-1 runs q and p downwards.
  float ar = 0.f, ai = 0.f;
  int t = 0;
  for (int q = M - 1; q >= 0; --q) {
    for (int p = D - 1; p >= 0; --p, ++t) {
      const float x_r = s_xr[p * L + f + q];
      const float x_i = s_xi[p * L + f + q];
      const float hr = s_hr[t];
      if (kComplex) {
        const float hi = s_hi[t];
        ar = fmaf(hr, x_r, ar);
        ar = fmaf(-hi, x_i, ar);
        ai = fmaf(hr, x_i, ai);
        ai = fmaf(hi, x_r, ai);
      } else {
        ar = fmaf(hr, x_r, ar);
        ai = fmaf(hr, x_i, ai);
      }
    }
  }
  yr[f0 + f] = ar;
  yi[f0 + f] = ai;
}

}  // namespace

// Dynamic shared memory of one launch, in bytes (the wrapper picks k_out
// so that it fits the card's 227 KB).
extern "C" int64_t decim_fir_smem_bytes(int MD, int D, int k_out,
                                        int complex_taps) {
  const int64_t M = MD / D;
  return static_cast<int64_t>(sizeof(float)) *
         (MD * (complex_taps ? 2 : 1) + 2 * D * (k_out - 1 + M));
}

// C entry for ctypes.  Pointers on the current device: xr/xi [rows][n_in],
// ctx_r/ctx_i [rows][ctx_len] (only the trailing MD - 1 samples are read),
// taps_r (and taps_i when complex) [MD], yr/yi [rows][n_in / D].  k_out
// outputs (and threads) per block, a multiple of 32 up to 1024.
// Launches on `stream` without synchronising; returns cudaGetLastError()
// (or the error that stopped the launch).
extern "C" int decim_fir_launch(const void* xr, const void* xi,
                                const void* ctx_r, const void* ctx_i,
                                int ctx_len, const void* taps_r,
                                const void* taps_i, int MD, int D,
                                int complex_taps, int64_t n_in, int rows,
                                int k_out, void* yr, void* yi,
                                void* stream) {
  if (D < 1 || MD < D || MD % D != 0 || MD - 1 > ctx_len || n_in <= 0 ||
      n_in % D != 0 || rows < 1 || k_out < 32 || k_out > 1024 ||
      k_out % 32 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t n_out = n_in / D;
  const int64_t smem = decim_fir_smem_bytes(MD, D, k_out, complex_taps);
  const dim3 grid(static_cast<unsigned>((n_out + k_out - 1) / k_out),
                  static_cast<unsigned>(rows));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (complex_taps) {
    err = cudaFuncSetAttribute(decim_fir_kernel<true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    decim_fir_kernel<true><<<grid, k_out, smem, s>>>(
        static_cast<const float*>(xr), static_cast<const float*>(xi),
        static_cast<const float*>(ctx_r), static_cast<const float*>(ctx_i),
        ctx_len, static_cast<const float*>(taps_r),
        static_cast<const float*>(taps_i), MD, D, n_in, n_out,
        static_cast<float*>(yr), static_cast<float*>(yi));
  } else {
    err = cudaFuncSetAttribute(decim_fir_kernel<false>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    decim_fir_kernel<false><<<grid, k_out, smem, s>>>(
        static_cast<const float*>(xr), static_cast<const float*>(xi),
        static_cast<const float*>(ctx_r), static_cast<const float*>(ctx_i),
        ctx_len, static_cast<const float*>(taps_r), nullptr, MD, D, n_in,
        n_out, static_cast<float*>(yr), static_cast<float*>(yi));
  }
  return static_cast<int>(cudaGetLastError());
}
