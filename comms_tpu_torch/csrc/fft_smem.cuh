// The shared-memory FFT of the Welch kernel (psd.cu: K7).  K6 (fft.cu)
// and K10 (fft_big.cu) run on the register FFT of fft_reg.cuh.
//
// fft_smem<KPT>() computes B forward complex FFTs of n points each
// (n = 2^log2n, 4 <= n <= 16384) on planar float32 data in shared memory:
// transform b occupies sr[b*ld .. b*ld + n) and si[...], in natural order
// before and after.  Every thread of the block takes part, and
// blockDim.x * KPT == B * n: each thread holds KPT complex values per pass.
//
// Stockham autosort passes, radix 4 while four or more points remain per
// sub-transform, one radix-2 pass last when log2n is odd.  A pass with
// sub-transform size Ns (the product of the earlier radices) reads
// butterfly j's inputs at j + r*n/R, multiplies input r by
// W_{Ns*R}^{(j mod Ns)*r}, and writes output r at
// (j/Ns)*Ns*R + (j mod Ns) + r*Ns (Govindaraju et al., "High performance
// discrete Fourier transforms on graphics processors", SC 2008).  The
// pass works in place, with one buffer: every thread loads all of its
// butterflies' inputs into registers, the block synchronises, and only
// then are the outputs written.  That is what lets n = 16384 (128 KB of
// planar float32) fit one block's shared memory, where a ping-pong pair
// of buffers would not.
//
// Twiddles: W_n^k = e^{-2 pi i k / n} for k < n, a host table computed
// in float64 from the integer index k and rounded to float32 (twr, twi;
// the wrapper keeps it on the card with _build.device_constant).  The
// kernel only ever forms integer indices (j mod Ns) * r * n / (Ns * R)
// < n into it, never an angle as a float product.  `scale` multiplies
// the outputs of the last pass.
//
// Bank conflicts: the reads of a pass are conflict-free; the writes of
// the passes with Ns < 32 are strided by R and conflict up to 4-way.
// Padding those strides is later work (PERF.md).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fft_smem_detail {

__device__ __forceinline__ void cmul(float& ar, float& ai, float wr,
                                     float wi) {
  const float tr = ar * wr - ai * wi;
  ai = ar * wi + ai * wr;
  ar = tr;
}

}  // namespace fft_smem_detail

template <int KPT>
__device__ __forceinline__ void fft_smem(float* sr, float* si, int n,
                                         int log2n, int ld,
                                         const float* __restrict__ twr,
                                         const float* __restrict__ twi,
                                         float scale) {
  using fft_smem_detail::cmul;
  const int T = blockDim.x;
  int l2Ns = 0;
  while (l2Ns < log2n) {
    const int l2R = (log2n - l2Ns >= 2) ? 2 : 1;
    const int Ns = 1 << l2Ns;
    const int l2q = log2n - l2R;             // log2(n / R)
    const int qmask = (1 << l2q) - 1;
    const int tshift = log2n - l2Ns - l2R;   // twiddle index unit n/(Ns*R)
    const float s = (l2Ns + l2R == log2n) ? scale : 1.f;
    float vr[KPT], vi[KPT];
    if (l2R == 2) {
#pragma unroll
      for (int k = 0; k < KPT / 4; ++k) {
        const int g = threadIdx.x + k * T;
        const int j = g & qmask;
        const int base = (g >> l2q) * ld + j;
        const int e = (j & (Ns - 1)) << tshift;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float ar = sr[base + (r << l2q)];
          float ai = si[base + (r << l2q)];
          if (r) cmul(ar, ai, __ldg(twr + r * e), __ldg(twi + r * e));
          vr[4 * k + r] = ar;
          vi[4 * k + r] = ai;
        }
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KPT / 4; ++k) {
        const int g = threadIdx.x + k * T;
        const int j = g & qmask;
        const int out = (g >> l2q) * ld + ((j >> l2Ns) << (l2Ns + 2)) +
                        (j & (Ns - 1));
        const int q = 4 * k;
        const float t0r = vr[q] + vr[q + 2], t0i = vi[q] + vi[q + 2];
        const float t1r = vr[q] - vr[q + 2], t1i = vi[q] - vi[q + 2];
        const float t2r = vr[q + 1] + vr[q + 3];
        const float t2i = vi[q + 1] + vi[q + 3];
        const float t3r = vr[q + 1] - vr[q + 3];
        const float t3i = vi[q + 1] - vi[q + 3];
        // y0 = t0 + t2, y1 = t1 - i t3, y2 = t0 - t2, y3 = t1 + i t3
        sr[out] = (t0r + t2r) * s;
        si[out] = (t0i + t2i) * s;
        sr[out + Ns] = (t1r + t3i) * s;
        si[out + Ns] = (t1i - t3r) * s;
        sr[out + 2 * Ns] = (t0r - t2r) * s;
        si[out + 2 * Ns] = (t0i - t2i) * s;
        sr[out + 3 * Ns] = (t1r - t3i) * s;
        si[out + 3 * Ns] = (t1i + t3r) * s;
      }
    } else {
#pragma unroll
      for (int k = 0; k < KPT / 2; ++k) {
        const int g = threadIdx.x + k * T;
        const int j = g & qmask;
        const int base = (g >> l2q) * ld + j;
        const int e = (j & (Ns - 1)) << tshift;
        float br = sr[base + (1 << l2q)];
        float bi = si[base + (1 << l2q)];
        cmul(br, bi, __ldg(twr + e), __ldg(twi + e));
        vr[2 * k] = sr[base];
        vi[2 * k] = si[base];
        vr[2 * k + 1] = br;
        vi[2 * k + 1] = bi;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < KPT / 2; ++k) {
        const int g = threadIdx.x + k * T;
        const int j = g & qmask;
        const int out = (g >> l2q) * ld + ((j >> l2Ns) << (l2Ns + 1)) +
                        (j & (Ns - 1));
        sr[out] = (vr[2 * k] + vr[2 * k + 1]) * s;
        si[out] = (vi[2 * k] + vi[2 * k + 1]) * s;
        sr[out + Ns] = (vr[2 * k] - vr[2 * k + 1]) * s;
        si[out + Ns] = (vi[2 * k] - vi[2 * k + 1]) * s;
      }
    }
    __syncthreads();
    l2Ns += l2R;
  }
}
