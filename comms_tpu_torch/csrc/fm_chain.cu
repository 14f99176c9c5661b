// The whole FM broadcast receive chain in one kernel, for Hopper (sm_90a).
//
//   planar u8 IQ -> (x - 127.5) / 127.5 -> 63-tap FIR, keep every 5th
//                -> quadrature demod (degree-15 polynomial atan2)
//                -> 63-tap FIR, keep every 5th -> f32 audio [N/25]
//
// Replaces the TPU kernel comms_tpu/kernels/fm_chain_pallas.py::
// fm_chain_fused (its pl.pallas_call); the Python wrapper is
// comms_tpu_torch/kernels/fm_chain.py, the plain PyTorch version of the
// same function is fm_chain_plain beside it.
//
// What it computes, with x, mid, d the input, mid-rate and demodulated
// streams (negative indices are the carried stream context):
//   mid[m]   = sum_t h1[t] * x[5m - t]                  (re and im planes)
//   d[j]     = atan2_poly(zim, zre),  zre = mr*lr + mi*li,
//              zim = mi*lr - mr*li,   (mr, mi) = mid[j], (lr, li) = mid[j-1]
//   audio[f] = sum_t h2[t] * d[5f - t]
// Context: x[n < 0] = ctx_x[20480 + n] (raw u8 scale, converted like the
// data), mid[-1] = ctx_prev, d[j < 0] = ctx_d[5120 + j].
//
// Bound on the H100: per input sample it reads 2 bytes (two u8 planes)
// and does ~25 multiply-adds (63 taps x 2 planes / 5) on the CUDA
// cores; 3.35 TB/s against ~33 T FMA/s of float32 puts the two limits
// within 2x of each other, and the shared-memory loads feeding each FMA
// (one 4-byte load per FMA) are the tighter limit of this simple form.
// The design keeps every intermediate out of device memory: one thread
// block owns a tile of kAudio audio outputs and stages u8 -> x -> mid ->
// d in shared memory, so device memory sees the u8 planes once (plus the
// ~10% halo each tile re-reads) and the audio once.  Tiles share nothing
// and run in any order: each reloads its own halo from device memory
// instead of carrying it from a neighbour (the TPU kernel's sequential
// grid carried it in VMEM).  Shared-memory strides are 5 words across a
// warp, which is conflict-free.  The taps travel by value in the launch's
// parameter block, which the card serves from its constant memory, so
// every tap read is a broadcast and no separate upload (with its
// cross-stream ordering hazard) exists.  Tensor-core forms (s8 mma on a
// byte split of the taps, or wgmma) are later work.
//
// Built without --use_fast_math: the conversion's division and atan2's
// r = num / (den + 1e-30f) are IEEE-rounded, denormals are kept.  atan2_poly
// is shared with band_monitor.cu (atan2_poly.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "atan2_poly.cuh"

namespace {

constexpr int kTaps = 63;
constexpr int kDec = 5;
constexpr int kHalo = kTaps - 1;                 // 62
constexpr int kAudio = 128;                      // audio outputs per block
constexpr int kThreads = 128;
// d indices a tile reads: [5*f0 - 62, 5*(f0 + kAudio - 1)]
constexpr int kD = kDec * (kAudio - 1) + kTaps;  // 698
// mid indices: one more on the left (d[j] needs mid[j-1])
constexpr int kMid = kD + 1;                     // 699
// x indices: [5*m_first - 62, 5*m_last]
constexpr int kX = kDec * (kMid - 1) + kTaps;    // 3553
constexpr int kCtxX = 20480;                     // ctx xre/xim length
constexpr int kCtxD = 5120;                      // ctx d length

struct Taps {
  float h1[kTaps];
  float h2[kTaps];
};

__device__ __forceinline__ float convert(float raw) {
  return (raw - 127.5f) / 127.5f;
}

__global__ void __launch_bounds__(kThreads)
fm_chain_kernel(const uint8_t* __restrict__ re,
                const uint8_t* __restrict__ im,
                const float* __restrict__ ctx_xre,
                const float* __restrict__ ctx_xim,
                const float* __restrict__ ctx_d,
                const float* __restrict__ ctx_prev,
                const Taps taps,
                float* __restrict__ audio) {
  __shared__ float s_xre[kX];
  __shared__ float s_xim[kX];
  __shared__ float s_mre[kMid];
  __shared__ float s_mim[kMid];
  __shared__ float s_d[kD];

  const int64_t f0 = static_cast<int64_t>(blockIdx.x) * kAudio;
  const int64_t d0 = kDec * f0 - kHalo;   // first d index of the tile
  const int64_t m0 = d0 - 1;              // first mid index
  const int64_t x0 = kDec * m0 - kHalo;   // first x index

  // u8 (or raw-scale context) -> converted x, both planes.
  for (int i = threadIdx.x; i < kX; i += kThreads) {
    const int64_t n = x0 + i;
    float vr, vi;
    if (n >= 0) {
      vr = static_cast<float>(re[n]);
      vi = static_cast<float>(im[n]);
    } else {
      vr = ctx_xre[kCtxX + n];
      vi = ctx_xim[kCtxX + n];
    }
    s_xre[i] = convert(vr);
    s_xim[i] = convert(vi);
  }
  __syncthreads();

  // Stage 1: mid[m] = sum_t h1[t] x[5m - t]; x[5m - t] sits at shared
  // index 5*i + 62 - t for m = m0 + i.  mid[-1] is the carried sample;
  // mid[m < -1] only feed d[j < 0], which come from the context.
  for (int i = threadIdx.x; i < kMid; i += kThreads) {
    const int64_t m = m0 + i;
    float ar = 0.f, ai = 0.f;
    if (m >= 0) {
      const float* xr = s_xre + kDec * i + kHalo;
      const float* xi = s_xim + kDec * i + kHalo;
#pragma unroll
      for (int t = 0; t < kTaps; ++t) {
        ar = fmaf(taps.h1[t], xr[-t], ar);
        ai = fmaf(taps.h1[t], xi[-t], ai);
      }
    } else if (m == -1) {
      ar = ctx_prev[0];
      ai = ctx_prev[1];
    }
    s_mre[i] = ar;
    s_mim[i] = ai;
  }
  __syncthreads();

  // Demod: d[j] from mid[j] (shared index i + 1) and mid[j - 1] (i).
  // Products and sums rounded one by one (no contraction), in the TPU
  // kernel's order, so the signs of zero products match it exactly.
  for (int i = threadIdx.x; i < kD; i += kThreads) {
    const int64_t j = d0 + i;
    float d;
    if (j >= 0) {
      const float mr = s_mre[i + 1], mi = s_mim[i + 1];
      const float lr = s_mre[i], li = s_mim[i];
      const float zre = __fadd_rn(__fmul_rn(mr, lr), __fmul_rn(mi, li));
      const float zim = __fsub_rn(__fmul_rn(mi, lr), __fmul_rn(mr, li));
      d = atan2_poly(zim, zre);
    } else {
      d = ctx_d[kCtxD + j];
    }
    s_d[i] = d;
  }
  __syncthreads();

  // Stage 2: audio[f0 + i] = sum_t h2[t] d[5(f0 + i) - t], at shared
  // index 5*i + 62 - t.
  for (int i = threadIdx.x; i < kAudio; i += kThreads) {
    const float* dd = s_d + kDec * i + kHalo;
    float acc = 0.f;
#pragma unroll
    for (int t = 0; t < kTaps; ++t) acc = fmaf(taps.h2[t], dd[-t], acc);
    audio[f0 + i] = acc;
  }
}

}  // namespace

// C entry for ctypes.  Pointers: re/im/ctx/audio on the current device,
// taps1/taps2 in host memory (63 floats each, copied into the launch's
// parameters).  n_audio = N / 25 must be a positive multiple of kAudio.
// Launches on `stream` without synchronising; returns cudaGetLastError().
extern "C" int fm_chain_launch(const void* re, const void* im,
                               const void* ctx_xre, const void* ctx_xim,
                               const void* ctx_d, const void* ctx_prev,
                               const void* taps1, const void* taps2,
                               void* audio, int64_t n_audio, void* stream) {
  if (n_audio <= 0 || n_audio % kAudio != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  for (int t = 0; t < kTaps; ++t) {
    taps.h1[t] = static_cast<const float*>(taps1)[t];
    taps.h2[t] = static_cast<const float*>(taps2)[t];
  }
  const dim3 grid(static_cast<unsigned>(n_audio / kAudio));
  fm_chain_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(re), static_cast<const uint8_t*>(im),
      static_cast<const float*>(ctx_xre), static_cast<const float*>(ctx_xim),
      static_cast<const float*>(ctx_d), static_cast<const float*>(ctx_prev),
      taps, static_cast<float*>(audio));
  return static_cast<int>(cudaGetLastError());
}
