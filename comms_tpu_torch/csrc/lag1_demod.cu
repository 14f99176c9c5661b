// Lag-1 FM demodulation of the staged band monitor, for Hopper (sm_90a).
//
//   d[k][j] = atan2(Im z, Re z),  z = y[j][k] * conj(y[j-1][k]),  y[-1] = prev
//
// over the channelizer's frame-major float32 planes yr, yi [F][K] (K8's
// output), written channel-major as d [K][F], the layout the audio FIR reads
// (its one launch takes d[:K/2] and d[K/2:] as the re and im planes of K/2
// rows, no copy); the same launch writes the next call's prev [K][2] (frame
// F - 1).  It replaces no TPU kernel: the JAX package's staged band monitor
// (comms_tpu/models/fm_band_monitor.py::_planar_core) demodulates with plain
// jnp, and the port ran the same as some 70 eager PyTorch passes a block
// (two transposes, the products on strided slices, the polynomial atan2's
// passes twice, a cat and a stack), each over a full plane.
//
// Bound on the H100: per sample it reads 8 bytes and writes 4, and does
// about 30 float32 operations (the two products, the octant reduction, one
// division and the degree-15 polynomial): bytes bound it (26,214,400 samples
// in 0.094 ms at 3.35 TB/s).  The design moves each byte once:
// - one block a tile of kTile = 4096 samples: TF = 4096 / K consecutive
//   frames x all K channels, which is one contiguous run of both planes;
//   frame j0 - 1 (or prev, for the first tile) is read beside it as the halo;
// - the tile comes in with 16-byte loads, consecutive threads on consecutive
//   quads (scalar loads for planes not 16-byte aligned and for a last quad
//   that the planes' end cuts);
// - each thread computes 16 samples in the input's order (consecutive
//   channels across a warp), the products as the tensor path rounds them
//   (Im = c*b - a*d, Re = a*b + c*d, each product and sum rounded apart, so
//   the signs of zero products at stream start are the tensor path's), then
//   atan2_poly (atan2_poly.cuh, as K1 and K9 use it) or, with poly = 0,
//   CUDA's atan2f;
// - the results go through a shared [K][TF + 1] transpose (an odd row
//   stride: conflict-free at K >= 32) over the tile's buffer, and leave a
//   channel row at a time, consecutive threads on consecutive frames (a warp
//   stores 128 contiguous bytes);
// - a ragged last tile is masked; tiles are blocks, 6 a SM (33.8 KB of
//   shared memory each).
// nvcc contracts the polynomial's Horner steps to FMAs, which PyTorch's
// eager passes round apart: d differs from the tensor path by a few ulp of
// pi at most (the products are rounded alike).

#include <cuda_runtime.h>
#include <stdint.h>

#include "atan2_poly.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 4096;                 // samples a tile (a block)
constexpr int kPer = kTile / kThreads;      // samples a thread
constexpr int kQuads = kTile / 4 / kThreads;
constexpr int kLog2Tile = 12;
constexpr int kMaxK = 128;

template <bool kPoly>
__global__ void __launch_bounds__(kThreads) lag1_demod_kernel(
    const float* __restrict__ yr, const float* __restrict__ yi,
    const float* __restrict__ prev, int64_t frames, int log2k, int aligned,
    float* __restrict__ d, float* __restrict__ prev_out) {
  __shared__ __align__(16) float body[2 * kTile];  // re run, then im run
  __shared__ float halo[2 * kMaxK];                // frame j0 - 1: re, im
  const int K = 1 << log2k;
  const int log2tf = kLog2Tile - log2k;
  const int TF = 1 << log2tf;
  const int t = threadIdx.x;
  const int64_t j0 = static_cast<int64_t>(blockIdx.x) << log2tf;
  const int nf = static_cast<int>(frames - j0 < TF ? frames - j0 : TF);
  const int n = nf << log2k;                       // samples in this tile
  const int64_t base = j0 << log2k;

  if (t < K) {
    if (j0 == 0) {
      halo[t] = prev[2 * t];
      halo[kMaxK + t] = prev[2 * t + 1];
    } else {
      halo[t] = yr[base - K + t];
      halo[kMaxK + t] = yi[base - K + t];
    }
  }
#pragma unroll
  for (int q = 0; q < kQuads; ++q) {
    const int v = 4 * (t + q * kThreads);
    if (aligned && v + 4 <= n) {
      *reinterpret_cast<float4*>(body + v) =
          __ldg(reinterpret_cast<const float4*>(yr + base + v));
      *reinterpret_cast<float4*>(body + kTile + v) =
          __ldg(reinterpret_cast<const float4*>(yi + base + v));
    } else {
      for (int e = v; e < v + 4 && e < n; ++e) {
        body[e] = yr[base + e];
        body[kTile + e] = yi[base + e];
      }
    }
  }
  __syncthreads();

  const bool last = j0 + nf == frames;
  float out[kPer];
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = t + q * kThreads;
    out[q] = 0.0f;
    if (e < n) {
      const int k = e & (K - 1);
      const float a = body[e];
      const float c = body[kTile + e];
      const float b = e >= K ? body[e - K] : halo[k];
      const float dd = e >= K ? body[kTile + e - K] : halo[kMaxK + k];
      const float im = __fsub_rn(__fmul_rn(c, b), __fmul_rn(a, dd));
      const float re = __fadd_rn(__fmul_rn(a, b), __fmul_rn(c, dd));
      out[q] = kPoly ? atan2_poly(im, re) : atan2f(im, re);
      if (last && e >= n - K) {
        prev_out[2 * k] = a;
        prev_out[2 * k + 1] = c;
      }
    }
  }
  __syncthreads();                                 // the tile is read

  float* ds = body;                                // [K][TF + 1]
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int e = t + q * kThreads;
    if (e < n) ds[(e & (K - 1)) * (TF + 1) + (e >> log2k)] = out[q];
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPer; ++q) {
    const int o = t + q * kThreads;
    const int k = o >> log2tf;
    const int j = o & (TF - 1);
    if (j < nf) d[k * frames + j0 + j] = ds[k * (TF + 1) + j];
  }
}

}  // namespace

// C entry for ctypes.  Pointers on the current device: yr, yi [frames][K]
// and prev [K][2] in, d [K][frames] and prev_out [K][2] out (prev_out must
// not alias prev).  K a power of two up to 128; poly selects atan2_poly
// (else atan2f).  Launches on `stream` without synchronising; returns
// cudaGetLastError() (or cudaErrorInvalidValue for arguments it refuses).
extern "C" int lag1_demod_launch(const void* yr, const void* yi,
                                 const void* prev, int64_t frames, int K,
                                 int poly, void* d, void* prev_out,
                                 void* stream) {
  int log2k = -1;
  for (int s = 0; (1 << s) <= kMaxK; ++s) {
    if (K == (1 << s)) log2k = s;
  }
  if (log2k < 0 || frames < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t tf = kTile >> log2k;
  const int64_t tiles = (frames + tf - 1) / tf;
  if (tiles > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  auto a16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  const int aligned = a16(yr) && a16(yi);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pr = static_cast<const float*>(yr);
  const float* pi = static_cast<const float*>(yi);
  const float* pp = static_cast<const float*>(prev);
  float* pd = static_cast<float*>(d);
  float* po = static_cast<float*>(prev_out);
  const dim3 grid(static_cast<unsigned>(tiles));
  if (poly) {
    lag1_demod_kernel<true><<<grid, kThreads, 0, st>>>(
        pr, pi, pp, frames, log2k, aligned, pd, po);
  } else {
    lag1_demod_kernel<false><<<grid, kThreads, 0, st>>>(
        pr, pi, pp, frames, log2k, aligned, pd, po);
  }
  return static_cast<int>(cudaGetLastError());
}
