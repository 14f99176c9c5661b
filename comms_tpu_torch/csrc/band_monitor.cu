// The wideband FM band monitor in one kernel, for Hopper (sm_90a):
//
//   f32 re/im planes [N] -> K-channel polyphase DFT channelizer
//     -> lag-1 FM demod per channel (polynomial atan2)
//     -> decimating audio FIR per channel -> audio [K][N/K/dec]
//
// Replaces the TPU kernel comms_tpu/kernels/band_monitor_pallas.py::
// band_monitor_pallas_planar (its pl.pallas_call); the Python wrapper is
// comms_tpu_torch/kernels/band_monitor.py, the plain PyTorch version of
// the same function is band_monitor_plain beside it.
//
// What it computes, with Y the spectrum (channelize_tile.cuh) and Y[j < 0]
// the carried spectrum tail (halo_in[hframes + j], frames-major [K]):
//   d[j, c] = atan2_poly(cross, dotp),  dotp = yr*pr + yi*pi,
//             cross = yi*pr - yr*pi,  (yr, yi) = Y[j, c], (pr, pi) = Y[j-1, c]
//   a[t, c] = sum_{m < Ta} h[m] * d[t*dec - m, c]
// The products and sums of d are rounded one by one (no FMA contraction),
// in the TPU kernel's order (band_monitor_pallas.py:165-166): at stream
// start the carried tail is zero and atan2 of the signed-zero products
// gives 0 or +-pi, so a different order would move the first audio
// samples.  The kernel also writes the block's new carried state: the
// last hframes spectrum frames (frames-major, the memory of the JAX
// package's packed [halo_rows, 128]) and the last ctx_len input samples.
//
// Bound on the H100: per complex input sample it reads 8 bytes and
// writes 4/dec; it does 2M branch FMAs and 4K DFT FMAs per sample, plus
// the recomputed halo frames (Ta of every A*dec = 4096/K frames) and
// Ta/dec audio FMAs per frame and channel: ~92 FMAs per sample at K = 16
// (1.5 G FMA at N = 16.8M, ~50 us at ~33 T FMA/s), ~390 at K = 64.  So
// the CUDA cores, and before them the shared-memory loads feeding the
// DFT, bound it; device memory (~40 us at 16.8M samples) does not.  The
// design keeps every intermediate out of device memory: one thread block
// owns A audio outputs of all K channels, stages the input window of the
// A*dec + Ta spectrum frames they need in shared memory, and computes
// branch sums -> spectrum -> phase differences -> audio there, so device
// memory sees the input planes and the audio once.  Tiles share nothing
// and run in any order: each recomputes the Ta spectrum frames before its
// own (the TPU kernel's sequential grid carried them in VMEM); the first
// tiles take the frames before the block from the carried spectrum tail,
// which the 1024-sample input context alone could not rebuild.  Not
// carried over: the 128-lane packing, roll+select relayouts, composite
// audio views (_audio_mats), the 8-row halo alignment and the bf16x3
// split products.  Two shared buffers are reused: input window, then
// spectrum; branch sums, then phase differences.

#include <cuda_runtime.h>
#include <stdint.h>

#include "atan2_poly.cuh"
#include "channelize_tile.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileSamples = 4096;   // A*dec*K: own frames x channels

struct Shape {
  int M;            // taps per branch
  int dec;          // audio decimation
  int Ta;           // audio taps
  int A;            // audio outputs per tile
  int hframes;      // carried spectrum frames
  int ctx_len;      // input context samples
  int64_t n_frames; // N / K
  int64_t n_audio;  // n_frames / dec
};

__host__ __device__ inline int tile_frames(const Shape& s) {
  return s.A * s.dec + s.Ta;        // S: spectrum frames a tile holds
}

template <int K>
__host__ __device__ inline int64_t smem_floats(const Shape& s) {
  const int S = tile_frames(s);
  return 2 * K + s.M * K + s.Ta + 2 * (S + s.M - 1) * K + 2 * S * K +
         K * (s.A + 1);
}

template <int K>
__global__ void __launch_bounds__(kThreads)
band_monitor_kernel(const float* __restrict__ re,
                    const float* __restrict__ im,
                    const float* __restrict__ ctx_re,
                    const float* __restrict__ ctx_im,
                    const float* __restrict__ halo_r,
                    const float* __restrict__ halo_i,
                    const float* __restrict__ C,
                    const float2* __restrict__ roots,
                    const float* __restrict__ h, const Shape s,
                    float* __restrict__ audio,
                    float* __restrict__ halo_out_r,
                    float* __restrict__ halo_out_i,
                    float* __restrict__ ctx_out_r,
                    float* __restrict__ ctx_out_i) {
  extern __shared__ float4 smem4[];
  const int S = tile_frames(s);
  const int M = s.M;
  float2* s_root = reinterpret_cast<float2*>(smem4);
  float* s_C = reinterpret_cast<float*>(s_root + K);
  float* s_h = s_C + M * K;
  float* buf1 = s_h + s.Ta;                  // window, then spectrum
  float* buf2 = buf1 + 2 * (S + M - 1) * K;  // branch sums, then d
  float* s_out = buf2 + 2 * S * K;           // audio [K][A + 1]

  const int64_t t0 = static_cast<int64_t>(blockIdx.x) * s.A;
  const int64_t own0 = t0 * s.dec;           // first frame of this tile
  const int64_t j_lo = own0 - s.Ta;          // first frame held (s = 0)
  const int64_t jc0 = j_lo > 0 ? j_lo : 0;   // first frame computed
  const int off = static_cast<int>(jc0 - j_lo);
  const int nf = S - off;
  const int64_t halo0 = s.n_frames - s.hframes;

  stage_consts<K>(C, roots, M, s_C, s_root);
  for (int i = threadIdx.x; i < s.Ta; i += kThreads) s_h[i] = h[i];
  const int win = (nf + M - 1) * K;
  stage_window(re, im, ctx_re, ctx_im, s.ctx_len, (jc0 - M) * K + 1, win,
               buf1, buf1 + (S + M - 1) * K);
  __syncthreads();
  float* s_vr = buf2;
  float* s_vi = buf2 + S * K;
  branch_sums<K>(buf1, buf1 + (S + M - 1) * K, s_C, M, nf, s_vr, s_vi);
  __syncthreads();

  // Spectrum of frames j_lo .. j_lo + S - 1 at Y[(j - j_lo)*K + ch].
  float* Yr = buf1;
  float* Yi = buf1 + S * K;
  for (int i = threadIdx.x; i < nf * K; i += kThreads) {
    const int mm = i / K;
    float ar, ai;
    dft_frame<K>(s_vr + mm * K, s_vi + mm * K, s_root, i % K, ar, ai);
    Yr[off * K + i] = ar;
    Yi[off * K + i] = ai;
    const int64_t j = jc0 + mm;
    if (j >= own0 && j >= halo0) {
      const int64_t o = (j - halo0) * K + i % K;
      halo_out_r[o] = ar;
      halo_out_i[o] = ai;
    }
  }
  for (int i = threadIdx.x; i < off * K; i += kThreads) {
    const int64_t src = (s.hframes + j_lo) * K + i;   // frame j_lo + i/K
    Yr[i] = halo_r[src];
    Yi[i] = halo_i[src];
  }
  __syncthreads();

  // d[j] for held frames s = 1 .. S-1 (frame j_lo + s) into buf2.
  float* dd = buf2;
  for (int i = K + threadIdx.x; i < S * K; i += kThreads) {
    const float yr = Yr[i], yi = Yi[i];
    const float pr = Yr[i - K], pi = Yi[i - K];
    const float dotp = __fadd_rn(__fmul_rn(yr, pr), __fmul_rn(yi, pi));
    const float cross = __fsub_rn(__fmul_rn(yi, pr), __fmul_rn(yr, pi));
    dd[i] = atan2_poly(cross, dotp);
  }
  __syncthreads();

  // a[t0 + t, c] = sum_m h[m] d[(t0 + t)*dec - m, c]; that frame is held
  // at s = t*dec + Ta - m (>= 1).
  for (int i = threadIdx.x; i < s.A * K; i += kThreads) {
    const int t = i / K, c = i % K;
    const float* dc = dd + (t * s.dec + s.Ta) * K + c;
    float acc = 0.f;
    for (int m = 0; m < s.Ta; ++m) acc = fmaf(s_h[m], dc[-m * K], acc);
    s_out[c * (s.A + 1) + t] = acc;
  }
  __syncthreads();
  for (int i = threadIdx.x; i < s.A * K; i += kThreads) {
    const int c = i / s.A, t = i % s.A;
    audio[c * s.n_audio + t0 + t] = s_out[c * (s.A + 1) + t];
  }
  if (blockIdx.x == gridDim.x - 1) {
    const int64_t n = s.n_frames * K;
    for (int i = threadIdx.x; i < s.ctx_len; i += kThreads) {
      ctx_out_r[i] = re[n - s.ctx_len + i];
      ctx_out_i[i] = im[n - s.ctx_len + i];
    }
  }
}

template <int K>
int launch(const void* re, const void* im, const void* ctx_re,
           const void* ctx_im, const void* halo_r, const void* halo_i,
           const void* C, const void* roots, const void* h, Shape s,
           void* audio, void* halo_out_r, void* halo_out_i, void* ctx_out_r,
           void* ctx_out_i, cudaStream_t stream) {
  if (s.dec < 1 || (kTileSamples / K) % s.dec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  s.A = kTileSamples / K / s.dec;
  if (s.M < 1 || s.Ta < 1 || s.hframes < s.Ta ||
      s.M * K - 1 > s.ctx_len || s.n_frames <= 0 ||
      s.n_frames % (s.A * s.dec) != 0 || s.hframes > s.n_frames ||
      s.ctx_len > s.n_frames * K) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  s.n_audio = s.n_frames / s.dec;
  const size_t smem = sizeof(float) * smem_floats<K>(s);
  cudaError_t err = cudaFuncSetAttribute(
      band_monitor_kernel<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>(s.n_audio / s.A));
  band_monitor_kernel<K><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(re), static_cast<const float*>(im),
      static_cast<const float*>(ctx_re), static_cast<const float*>(ctx_im),
      static_cast<const float*>(halo_r), static_cast<const float*>(halo_i),
      static_cast<const float*>(C), static_cast<const float2*>(roots),
      static_cast<const float*>(h), s, static_cast<float*>(audio),
      static_cast<float*>(halo_out_r), static_cast<float*>(halo_out_i),
      static_cast<float*>(ctx_out_r), static_cast<float*>(ctx_out_i));
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  Pointers on the current device: re/im [N], ctx
// [ctx_len] (only the trailing M*K - 1 samples are read), halo [hframes][K]
// (carried spectrum tail), C [M][K], roots [K] (re, im) f32 pairs, h [Ta]
// audio taps; outputs audio [K][N/K/dec] (channel-major), halo_out
// [hframes][K] and ctx_out [ctx_len].  K divides 128, dec divides 4096/K,
// N/K a multiple of 4096/K, hframes >= Ta.  Launches on `stream` without
// synchronising; returns cudaGetLastError() (or the error that stopped
// the launch).
extern "C" int band_monitor_launch(
    const void* re, const void* im, const void* ctx_re, const void* ctx_im,
    int ctx_len, const void* halo_r, const void* halo_i, int hframes,
    const void* C, const void* roots, int K, int M, const void* h, int Ta,
    int dec, int64_t n_frames, void* audio, void* halo_out_r,
    void* halo_out_i, void* ctx_out_r, void* ctx_out_i, void* stream) {
  Shape s{M, dec, Ta, 0, hframes, ctx_len, n_frames, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define COMMS_BM_CASE(KK)                                                    \
  case KK:                                                                   \
    return launch<KK>(re, im, ctx_re, ctx_im, halo_r, halo_i, C, roots, h,   \
                      s, audio, halo_out_r, halo_out_i, ctx_out_r, ctx_out_i, \
                      st);
  switch (K) {
    COMMS_BM_CASE(2)
    COMMS_BM_CASE(4)
    COMMS_BM_CASE(8)
    COMMS_BM_CASE(16)
    COMMS_BM_CASE(32)
    COMMS_BM_CASE(64)
    COMMS_BM_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef COMMS_BM_CASE
}
