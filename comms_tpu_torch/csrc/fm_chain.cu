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
// data), mid[-1] = ctx_prev, d[j < 0] = ctx_d[5120 + j].  Every sum is
// the chain acc = fmaf(h[t], v[5k - t], acc) for t = 0..62 from acc = 0,
// so the output is bit-identical to the first (one output a thread)
// form of this kernel.
//
// Bound on the H100: per input sample it reads 2 bytes and does ~28
// float32 multiply-adds (63 taps x 2 planes / 5 in the first FIR, a
// tenth of that in the second): 0.025 ms of operations at 67 TFLOP/s
// against 0.017 ms of bytes at 3.35 TB/s for N = 26,214,400.  A warp's
// float32 FMA takes a whole issue slot of its SM sub-partition, so every
// other instruction (shared-memory loads, the conversion, the demod)
// adds to the FMA time; the design cuts those:
// - Persistent blocks walk tiles of A audio outputs (blockIdx.x,
//   blockIdx.x + gridDim.x, ...) and stage u8 -> x -> mid -> d in shared
//   memory, so device memory sees the u8 planes once (plus the halo each
//   tile re-reads: 6% at A = 256) and the audio once.  The next tile's u8
//   window is copied into shared memory (cp.async, 16 bytes a copy) while
//   the current tile computes.
// - Register-blocked FIR windows: a thread computes R consecutive
//   outputs of one plane.  Output r reads v[5(k0 + r) - t] at tap t; at
//   tap t + 5 it reads what output r - 1 read at tap t.  So the thread
//   keeps five rotating windows of R values, one per phase t mod 5: the
//   first five taps load 5R values, every later tap one, 5R + 58 shared
//   loads for 63R FMAs instead of 63R.  The FMAs of each output keep
//   their order, and so their bits.  R is odd: a warp's lanes then read
//   5R words apart, which is free of bank conflicts.  Stage 1 runs one
//   plane a thread (R = 7), stage 2 R = 3.
// - A byte becomes a sample without the division (convert_byte), exact
//   for all 256 values; the raw context samples keep the division.
// - The mids are written over x once stage 1 has read it, which keeps a
//   256-output tile at 73.4 KB of shared memory: 3 blocks of 384 threads
//   an SM.  Calls with fewer big tiles than the H100 has SMs take tiles
//   of 64 outputs (256 threads), which spread them over more SMs.
// The taps travel by value in the launch's parameter block, which the
// card serves from its constant memory as FMA operands.
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
constexpr int kCtxX = 20480;                     // ctx xre/xim length
constexpr int kCtxD = 5120;                      // ctx d length
constexpr int kLag = (kTaps - 1) / kDec;         // 12: window reach back
constexpr int kSmallTilesBelow = 132;            // tiles of kBig.A

struct Taps {
  float h1[kTaps];
  float h2[kTaps];
};

// One tile shape: A audio outputs, stage-1 windows of R1 mids, stage-2
// windows of R2 audio outputs, at least kMinBlocks blocks an SM.
template <int A_, int R1_, int R2_, int kMinBlocks_>
struct Tile {
  static constexpr int A = A_, R1 = R1_, R2 = R2_, kMinBlocks = kMinBlocks_;
  // d indices the tile reads: [5 f0 - 62, 5 (f0 + A - 1)]
  static constexpr int kD = kDec * (A - 1) + kTaps;
  static constexpr int kMid = kD + 1;            // mid[j - 1] too
  static constexpr int kG1 = (kMid + R1 - 1) / R1;     // stage-1 windows
  static constexpr int kMidP = kG1 * R1;
  // stage 1 runs one plane a thread: warps [0, kHalf/32) take the re
  // plane, the next as many the im plane.
  static constexpr int kHalf = (kG1 + 31) / 32 * 32;
  static constexpr int kThreads = 2 * kHalf;
  // x[n] sits at shared index n - xa, xa = x0 - 7 with x0 = 5 m0 - 62
  // the first x index and xa 16-byte aligned; the last index read is
  // 5 (kMidP - 1) + 62 + 7.
  static constexpr int kXs = kDec * kMidP + 65;
  static constexpr int kXL = (kXs + 15) / 16 * 16;   // whole 16-byte copies
  static constexpr int kChunks = kXL / 4;            // 4-sample chunks a plane
  static constexpr int kCopies = 2 * kXL / 16;       // 16-byte copies, both
  static constexpr int kG2 = (A + R2 - 1) / R2;      // stage-2 windows
  static constexpr int kDP = kDec * kG2 * R2 + kHalo - kDec + 1;
  static constexpr int kDL = (kDP + 3) / 4 * 4;      // keeps 16-byte rows
  // shared bytes: x (2 planes of kXL floats; the mids over their start
  // once stage 1 has read x), d (kDL floats), the u8 planes' next window
  static constexpr int kSmem = 8 * kXL + 4 * kDL + 2 * kXL;
  static_assert(A % 16 == 0, "xa must be 16-byte aligned");
  static_assert(R1 % 2 == 1 && R2 % 2 == 1, "odd windows: no conflicts");
  static_assert(kG2 <= kThreads, "one stage-2 window a thread");
  static_assert(kMidP <= kXL, "the mids fit over x");
};

using kBig = Tile<256, 7, 3, 3>;
using kSmall = Tile<64, 3, 3, 1>;

__device__ __forceinline__ float convert(float raw) {
  return (raw - 127.5f) / 127.5f;
}

// convert(u) for a byte u, without the division, from a2 = 2u - 255
// (an odd integer, exact in float32) and c = rn(1/127.5): q0 = a2 c/2 is
// rn(a c) with a = u - 127.5, and one correction step with the exact
// residual a2 - 255 q0 = 2(a - 127.5 q0) gives the IEEE quotient a / 127.5
// for all 256 bytes (checked exhaustively in tests/test_torch_fm_chain.py).
// Three float32 operations; the integer work and the I2F run on other
// pipes than the FIRs' FMAs.
__device__ __forceinline__ float convert_byte(uint32_t u) {
  constexpr float kHalfInv = 0x1.010102p-8f;       // rn(1 / 127.5) / 2
  const float a2 = static_cast<float>(static_cast<int>(2 * u) - 255);
  const float q0 = __fmul_rn(a2, kHalfInv);
  return __fmaf_rn(__fmaf_rn(-q0, 255.f, a2), kHalfInv, q0);
}

__device__ __forceinline__ float4 convert4(uint32_t b) {
  return make_float4(convert_byte(b & 255), convert_byte((b >> 8) & 255),
                     convert_byte((b >> 16) & 255), convert_byte(b >> 24));
}

// acc[r] = sum_t h[t] * v[5 r - t] for t = 0..62 in order, from
// v = B (B[5k - p] is phase p's window entry k, k = -12..R-1).
template <int R, bool kStage1>
__device__ __forceinline__ void fir_window(const float* __restrict__ B,
                                           const Taps& taps, float (&acc)[R]) {
  float w[kDec][R + kLag];   // w[p][kLag + k]: window entry k of phase p
#pragma unroll
  for (int r = 0; r < R; ++r) acc[r] = 0.f;
#pragma unroll
  for (int t = 0; t < kTaps; ++t) {
    const int q = t / kDec, p = t % kDec;
    if (q == 0) {
#pragma unroll
      for (int k = 0; k < R; ++k) w[p][kLag + k] = B[kDec * k - p];
    } else {
      w[p][kLag - q] = B[-kDec * q - p];
    }
    const float h = kStage1 ? taps.h1[t] : taps.h2[t];
#pragma unroll
    for (int r = 0; r < R; ++r) acc[r] = fmaf(h, w[p][kLag + r - q], acc[r]);
  }
}

// Four bytes of a plane from sample n, a byte at a time (the tiles
// that are not copied ahead: the first, the last, and every tile of
// planes that are not 16-byte aligned).
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ p,
                                          int64_t n) {
  return static_cast<uint32_t>(__ldg(p + n)) |
         static_cast<uint32_t>(__ldg(p + n + 1)) << 8 |
         static_cast<uint32_t>(__ldg(p + n + 2)) << 16 |
         static_cast<uint32_t>(__ldg(p + n + 3)) << 24;
}

// d at the tile's index i from mid (shared index i + 1) and the one
// before it (i): products and sums rounded one by one (no contraction),
// in the TPU kernel's order, so the signs of zero products match it.
template <class T>
__device__ __forceinline__ float demod(const float* s_m, int i) {
  const float mr = s_m[i + 1], mi = s_m[T::kMidP + i + 1];
  const float lr = s_m[i], li = s_m[T::kMidP + i];
  const float zre = __fadd_rn(__fmul_rn(mr, lr), __fmul_rn(mi, li));
  const float zim = __fsub_rn(__fmul_rn(mi, lr), __fmul_rn(mr, li));
  return atan2_poly(zim, zre);
}

// x at shared index 0 of tile `tile`: x0 - 7, where x0 = 5 m0 - 62 is the
// first x index the tile reads (m0 = 5 f0 - 63).
template <class T>
__device__ __forceinline__ int64_t window_start(int64_t tile) {
  return kDec * (kDec * tile * T::A - kHalo - 1) - kHalo - 7;
}

// Whether the tile's u8 window is copied ahead: it lies wholly inside
// [0, n_in) and the planes are 16-byte aligned.
template <class T>
__device__ __forceinline__ bool staged(int64_t xa, int64_t n_in,
                                       bool aligned) {
  return aligned && xa >= 0 && xa + T::kXL <= n_in;
}

// Start the copies of a tile's u8 window (both planes) into shared
// memory, 16 bytes a copy, as one cp.async group of each thread.
template <class T>
__device__ __forceinline__ void stage_window(
    uint8_t* s_u8, const uint8_t* __restrict__ re,
    const uint8_t* __restrict__ im, int64_t xa) {
  for (int c = threadIdx.x; c < T::kCopies; c += T::kThreads) {
    const int plane = c >= T::kCopies / 2;
    const uint8_t* src =
        (plane ? im : re) + xa + 16 * (c - plane * T::kCopies / 2);
    const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(
        s_u8 + 16 * c));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(src));
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// Each block walks the tiles blockIdx.x, blockIdx.x + gridDim.x, ...;
// the next tile's u8 window is copied into shared memory (cp.async)
// while the current tile computes.
template <class T>
__global__ void __launch_bounds__(T::kThreads, T::kMinBlocks)
fm_chain_kernel(const uint8_t* __restrict__ re,
                const uint8_t* __restrict__ im,
                const float* __restrict__ ctx_xre,
                const float* __restrict__ ctx_xim,
                const float* __restrict__ ctx_d,
                const float* __restrict__ ctx_prev,
                const Taps taps, int64_t n_in, bool aligned,
                float* __restrict__ audio) {
  extern __shared__ float4 smem4[];
  float* const s_x = reinterpret_cast<float*>(smem4);   // [2][kXL]
  float* const s_m = s_x;                                // [2][kMidP]
  float* const s_d = s_x + 2 * T::kXL;                   // [kDP]
  uint8_t* const s_u8 = reinterpret_cast<uint8_t*>(s_d + T::kDL);  // [2][kXL]
  const int tid = threadIdx.x;
  const int64_t tiles = n_in / (kDec * kDec * T::A);

  // The stage-2 windows' spare entries past kD stay zero.
  for (int i = T::kD + tid; i < T::kDP; i += T::kThreads) s_d[i] = 0.f;
  int64_t tile = blockIdx.x;
  if (staged<T>(window_start<T>(tile), n_in, aligned)) {
    stage_window<T>(s_u8, re, im, window_start<T>(tile));
  }
  for (; tile < tiles; tile += gridDim.x) {
    const int64_t f0 = tile * T::A;
    const int64_t d0 = kDec * f0 - kHalo;   // first d index of the tile
    const int64_t m0 = d0 - 1;              // first mid index
    const int64_t xa = window_start<T>(tile);

    // u8 (or raw-scale context) -> converted x, both planes, in chunks
    // of 4 samples (the planes' windows are contiguous: chunk c is float4
    // c of s_x).  A chunk lies wholly inside [0, n_in) or wholly outside;
    // only the first and the last tile have chunks outside.
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
    __syncthreads();
    if (staged<T>(xa, n_in, aligned)) {
      for (int c = tid; c < 2 * T::kChunks; c += T::kThreads) {
        const uint32_t b = reinterpret_cast<const uint32_t*>(s_u8)[c];
        reinterpret_cast<float4*>(s_x)[c] = convert4(b);
      }
    } else {
      for (int c = tid; c < 2 * T::kChunks; c += T::kThreads) {
        const int plane = c >= T::kChunks;
        const int64_t n = xa + 4 * (c - plane * T::kChunks);
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (n >= 0 && n < n_in) {
          v = convert4(load4(plane ? im : re, n));
        } else if (n < 0) {
          const float* ctx = (plane ? ctx_xim : ctx_xre) + kCtxX + n;
          v = make_float4(convert(ctx[0]), convert(ctx[1]), convert(ctx[2]),
                          convert(ctx[3]));
        }
        reinterpret_cast<float4*>(s_x)[c] = v;
      }
    }
    __syncthreads();
    const int64_t next = tile + gridDim.x;
    if (next < tiles && staged<T>(window_start<T>(next), n_in, aligned)) {
      stage_window<T>(s_u8, re, im, window_start<T>(next));
    }

    // Stage 1: mid[m0 + i] = sum_t h1[t] x[5(m0 + i) - t], x[5(m0 + i) - t]
    // at shared index 5 i + 69 - t; window g holds mids R1 g .. R1 g + R1 - 1.
    // The mids are written over x once every thread has read it.
    // mid[-1] is the carried sample; mid[m < -1] only feed d[j < 0], which
    // come from the context.
    const int plane = tid >= T::kHalf;
    const int g = tid - plane * T::kHalf;
    float acc1[T::R1];
    if (g < T::kG1) {
      fir_window<T::R1, true>(s_x + plane * T::kXL + kDec * T::R1 * g + 69,
                              taps, acc1);
    }
    __syncthreads();
    if (g < T::kG1) {
      float* const out = s_m + plane * T::kMidP + T::R1 * g;
      if (m0 >= 0) {               // every tile but the first
#pragma unroll
        for (int r = 0; r < T::R1; ++r) out[r] = acc1[r];
      } else {
#pragma unroll
        for (int r = 0; r < T::R1; ++r) {
          const int64_t m = m0 + T::R1 * g + r;
          out[r] = m >= 0 ? acc1[r] : m == -1 ? ctx_prev[plane] : 0.f;
        }
      }
    }
    __syncthreads();

    // Demod: d[j] from mid[j] and mid[j - 1]; d[j < 0] is the context.
    if (d0 >= 0) {                 // every tile but the first
      for (int i = tid; i < T::kD; i += T::kThreads) {
        s_d[i] = demod<T>(s_m, i);
      }
    } else {
      for (int i = tid; i < T::kD; i += T::kThreads) {
        const int64_t j = d0 + i;
        s_d[i] = j >= 0 ? demod<T>(s_m, i) : ctx_d[kCtxD + j];
      }
    }
    __syncthreads();

    // Stage 2: audio[f0 + a] = sum_t h2[t] d[5(f0 + a) - t], at shared
    // index 5 a + 62 - t; window g holds outputs R2 g .. R2 g + R2 - 1.
    if (tid < T::kG2) {
      float acc[T::R2];
      fir_window<T::R2, false>(s_d + kDec * T::R2 * tid + kHalo, taps, acc);
#pragma unroll
      for (int r = 0; r < T::R2; ++r) {
        const int a = T::R2 * tid + r;
        if (a < T::A) audio[f0 + a] = acc[r];
      }
    }
  }
}

// Blocks of one tile shape an SM, and SMs, of the current device (read
// once per device: the launch's grid is their product, capped by the
// tiles).
struct Residency {
  bool set = false;
  int blocks = 0;
};

template <class T>
int launch(const uint8_t* re, const uint8_t* im, const float* ctx_xre,
           const float* ctx_xim, const float* ctx_d, const float* ctx_prev,
           const Taps& taps, int64_t n_audio, float* audio,
           cudaStream_t stream) {
  // The shared-memory limit and the residency are set once per device:
  // doing so on every call costs host time on the served path.
  constexpr int smem = T::kSmem;
  static Residency res[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!res[dev].set) {
    err = cudaFuncSetAttribute(fm_chain_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    int per_sm = 0, sms = 0;
    if (err == cudaSuccess) {
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, fm_chain_kernel<T>, T::kThreads, smem);
    }
    if (err == cudaSuccess) {
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    }
    if (err != cudaSuccess) return static_cast<int>(err);
    if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
    res[dev].blocks = per_sm * sms;
    res[dev].set = true;
  }
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(re) | reinterpret_cast<uintptr_t>(im)) &
       15) == 0;
  const int64_t tiles = n_audio / T::A;
  const dim3 grid(static_cast<unsigned>(
      tiles < res[dev].blocks ? tiles : res[dev].blocks));
  fm_chain_kernel<T><<<grid, T::kThreads, smem, stream>>>(
      re, im, ctx_xre, ctx_xim, ctx_d, ctx_prev, taps, n_audio * 25, aligned,
      audio);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  Pointers: re/im/ctx/audio on the current device,
// taps1/taps2 in host memory (63 floats each, copied into the launch's
// parameters).  n_audio = N / 25 must be a positive multiple of 256
// (N a multiple of 102,400).  One launch, on `stream`, without
// synchronising; returns cudaGetLastError().
extern "C" int fm_chain_launch(const void* re, const void* im,
                               const void* ctx_xre, const void* ctx_xim,
                               const void* ctx_d, const void* ctx_prev,
                               const void* taps1, const void* taps2,
                               void* audio, int64_t n_audio, void* stream) {
  if (n_audio <= 0 || n_audio % kBig::A != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Taps taps;
  for (int t = 0; t < kTaps; ++t) {
    taps.h1[t] = static_cast<const float*>(taps1)[t];
    taps.h2[t] = static_cast<const float*>(taps2)[t];
  }
  const auto r = static_cast<const uint8_t*>(re);
  const auto i = static_cast<const uint8_t*>(im);
  const auto xr = static_cast<const float*>(ctx_xre);
  const auto xi = static_cast<const float*>(ctx_xim);
  const auto d = static_cast<const float*>(ctx_d);
  const auto p = static_cast<const float*>(ctx_prev);
  const auto out = static_cast<float*>(audio);
  const auto s = static_cast<cudaStream_t>(stream);
  if (n_audio / kBig::A < kSmallTilesBelow) {
    return launch<kSmall>(r, i, xr, xi, d, p, taps, n_audio, out, s);
  }
  return launch<kBig>(r, i, xr, xi, d, p, taps, n_audio, out, s);
}
