// Device pieces of the polyphase DFT channelizer shared by channelizer.cu
// (the channelizer alone) and band_monitor.cu (channelizer + FM demod +
// audio FIR).  Each works on one thread block's tile of frames held in
// shared memory.
//
// Conventions (comms_tpu/kernels/channelizer_pallas.py:13-14, :156-161):
// with K channels, M taps per branch and C[k-1, c] = h[k*K - 1 - c],
//   V[m, c]  = sum_{k=1..M} C[k-1, c] * x[(m - k)*K + c + 1]
//   Y[m, ch] = sum_c V[m, c] * root[((c + 1)*ch) mod K],
//   root[n]  = exp(-2j*pi*n/K)   (made on the host in f64, rounded to f32)
// x[n < 0] is the carried context: ctx[ctx_len + n].
//
// Frames jc0 .. jc0+nf-1 read x[(jc0 - M)*K + 1 .. (jc0 + nf - 1)*K], a
// window of (nf + M - 1)*K samples; xw[i] below is x[(jc0 - M)*K + 1 + i],
// so term k of V[jc0 + mm, c] reads xw[(mm + M - k)*K + c].

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// The input window of both planes into shared memory.
static __device__ __forceinline__ void stage_window(
    const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ ctx_re, const float* __restrict__ ctx_im,
    int ctx_len, int64_t n0, int count, float* s_r, float* s_i) {
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    const int64_t n = n0 + i;
    if (n >= 0) {
      s_r[i] = re[n];
      s_i[i] = im[n];
    } else {
      s_r[i] = ctx_re[ctx_len + n];
      s_i[i] = ctx_im[ctx_len + n];
    }
  }
}

// Branch sums V[mm, c] for mm < nf into s_vr/s_vi ([nf][K]), terms in the
// order k = 1..M.  Consecutive threads take consecutive branches c, so the
// window reads are conflict-free.
template <int K>
__device__ __forceinline__ void branch_sums(
    const float* s_xr, const float* s_xi, const float* s_C, int M, int nf,
    float* s_vr, float* s_vi) {
  for (int i = threadIdx.x; i < nf * K; i += blockDim.x) {
    const int c = i % K;
    int idx = i + (M - 1) * K;      // term k = 1
    float vr = 0.f, vi = 0.f;
    for (int k = 0; k < M; ++k) {
      const float ck = s_C[k * K + c];
      vr = fmaf(ck, s_xr[idx], vr);
      vi = fmaf(ck, s_xi[idx], vi);
      idx -= K;
    }
    s_vr[i] = vr;
    s_vi[i] = vi;
  }
}

// Y[ch] of one frame from its branch sums vr/vi[K]: a direct K-point DFT
// against the root table (index (c+1)*ch mod K, advanced by ch per term).
// Threads of a warp share the frame, so the V reads are broadcasts.
template <int K>
__device__ __forceinline__ void dft_frame(const float* vr, const float* vi,
                                          const float2* s_root, int ch,
                                          float& yr, float& yi) {
  float ar = 0.f, ai = 0.f;
  int idx = ch;
#pragma unroll 16
  for (int c = 0; c < K; ++c) {
    const float2 w = s_root[idx];
    const float xr = vr[c];
    const float xi = vi[c];
    ar = fmaf(xr, w.x, ar);
    ar = fmaf(-xi, w.y, ar);
    ai = fmaf(xr, w.y, ai);
    ai = fmaf(xi, w.x, ai);
    idx = (idx + ch) & (K - 1);
  }
  yr = ar;
  yi = ai;
}

// Branch matrix C [M][K] and roots [K] (float2) into shared memory.
template <int K>
__device__ __forceinline__ void stage_consts(const float* __restrict__ C,
                                             const float2* __restrict__ roots,
                                             int M, float* s_C,
                                             float2* s_root) {
  for (int i = threadIdx.x; i < M * K; i += blockDim.x) s_C[i] = C[i];
  for (int i = threadIdx.x; i < K; i += blockDim.x) s_root[i] = roots[i];
}
