// K-channel polyphase DFT channelizer, for Hopper (sm_90a).
//
//   f32 re/im planes [N] -> branch sums V [N/K, K] -> K-point DFT with the
//   branch-reversal phase folded in -> yr, yi [N/K, K] (frames-major)
//
// Replaces the TPU kernel comms_tpu/kernels/channelizer_pallas.py::
// channelize_pallas_planar (its pl.pallas_call); the Python wrapper is
// comms_tpu_torch/kernels/channelizer.py, the plain PyTorch version of the
// same function is channelize_plain beside it.  The formulas are in
// channelize_tile.cuh.
//
// Bound on the H100: per complex input sample it moves 16 bytes (8 in,
// 8 out; 268 MB at N = 16.8M, ~80 us at 3.35 TB/s) and does M*2 branch
// FMAs plus 4K DFT FMAs (K = 64, M = 8: 272 per sample, 4.6 G FMA at
// N = 16.8M, ~140 us at the card's ~33 T FMA/s of float32).  So the
// CUDA cores bound it, and in this simple form the shared-memory loads
// feeding them (two 8-byte loads per four FMAs of the DFT) bind first.
// The design keeps V out of device memory: one thread block owns a tile
// of 4096/K frames, stages its input window plus (M-1)*K samples of
// look-back in shared memory (the first tile's look-back comes from the
// trailing T-1 samples of the 1024-sample context), forms the branch sums
// there and runs the DFT from them, writing only the spectrum.  The TPU
// kernel's 128-lane packing, roll+select relayouts and bf16x3 split
// dots are not carried over: the sums are plain float32 FMAs.  The DFT
// is the direct O(K^2) sum against a K-entry root table, no sincosf per
// term; a tensor-core DFT (the block-diagonal product as wgmma) or an
// FFT over the branch axis is later work.  Tiles share nothing and run
// in any order.

#include <cuda_runtime.h>
#include <stdint.h>

#include "channelize_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileSamples = 4096;   // frames per tile = kTileSamples / K

template <int K>
__global__ void __launch_bounds__(kThreads)
channelize_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  const float* __restrict__ ctx_re,
                  const float* __restrict__ ctx_im, int ctx_len,
                  const float* __restrict__ C,
                  const float2* __restrict__ roots, int M,
                  float* __restrict__ yr, float* __restrict__ yi) {
  constexpr int kFrames = kTileSamples / K;
  extern __shared__ float4 smem4[];
  float2* s_root = reinterpret_cast<float2*>(smem4);
  float* s_C = reinterpret_cast<float*>(s_root + K);
  const int win = (kFrames + M - 1) * K;
  float* s_xr = s_C + M * K;
  float* s_xi = s_xr + win;
  float* s_vr = s_xi + win;
  float* s_vi = s_vr + kFrames * K;

  const int64_t j0 = static_cast<int64_t>(blockIdx.x) * kFrames;
  stage_consts<K>(C, roots, M, s_C, s_root);
  stage_window(re, im, ctx_re, ctx_im, ctx_len, (j0 - M) * K + 1, win,
               s_xr, s_xi);
  __syncthreads();
  branch_sums<K>(s_xr, s_xi, s_C, M, kFrames, s_vr, s_vi);
  __syncthreads();
  for (int i = threadIdx.x; i < kFrames * K; i += kThreads) {
    const int mm = i / K;
    float ar, ai;
    dft_frame<K>(s_vr + mm * K, s_vi + mm * K, s_root, i % K, ar, ai);
    yr[j0 * K + i] = ar;
    yi[j0 * K + i] = ai;
  }
}

template <int K>
int launch(const void* re, const void* im, const void* ctx_re,
           const void* ctx_im, int ctx_len, const void* C, const void* roots,
           int M, int64_t n_frames, void* yr, void* yi, cudaStream_t stream) {
  constexpr int kFrames = kTileSamples / K;
  if (n_frames <= 0 || n_frames % kFrames != 0 || M < 1 ||
      M * K - 1 > ctx_len) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const size_t smem =
      sizeof(float) * (2 * K + M * K + 2 * (kFrames + M - 1) * K +
                       2 * kFrames * K);
  cudaError_t err = cudaFuncSetAttribute(
      channelize_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(n_frames / kFrames));
  channelize_kernel<K><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(ctx_re), static_cast<const float*>(ctx_im),
      ctx_len, static_cast<const float*>(C),
      static_cast<const float2*>(roots), M, static_cast<float*>(yr),
      static_cast<float*>(yi));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  Pointers on the current device: re/im [N], ctx
// [ctx_len] (only the trailing M*K - 1 samples are read), C [M][K] f32,
// roots [K] (re, im) f32 pairs, yr/yi [n_frames][K].  K divides 128;
// n_frames = N/K is a multiple of 4096/K.  Launches on `stream` without
// synchronising; returns cudaGetLastError() (or the error that stopped
// the launch).
extern "C" int channelize_launch(const void* re, const void* im,
                                 const void* ctx_re, const void* ctx_im,
                                 int ctx_len, const void* C,
                                 const void* roots, int K, int M,
                                 int64_t n_frames, void* yr, void* yi,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (K) {
    case 2: return launch<2>(re, im, ctx_re, ctx_im, ctx_len, C, roots, M,
                             n_frames, yr, yi, s);
    case 4: return launch<4>(re, im, ctx_re, ctx_im, ctx_len, C, roots, M,
                             n_frames, yr, yi, s);
    case 8: return launch<8>(re, im, ctx_re, ctx_im, ctx_len, C, roots, M,
                             n_frames, yr, yi, s);
    case 16: return launch<16>(re, im, ctx_re, ctx_im, ctx_len, C, roots, M,
                               n_frames, yr, yi, s);
    case 32: return launch<32>(re, im, ctx_re, ctx_im, ctx_len, C, roots, M,
                               n_frames, yr, yi, s);
    case 64: return launch<64>(re, im, ctx_re, ctx_im, ctx_len, C, roots, M,
                               n_frames, yr, yi, s);
    case 128: return launch<128>(re, im, ctx_re, ctx_im, ctx_len, C, roots,
                                 M, n_frames, yr, yi, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
