// The register-resident FFT that K6 (fft.cu, batched rows) and K10
// (fft_big.cu, the four-step stages) share: forward complex FFTs of
// n = 256 .. 16384 points (powers of two), float32, each thread holding 16
// points of one transform in registers.
//
// fft_reg<N, kPowers>(vr, vi, t, x, tw) transforms one N-point sequence
// held by the T = N / 16 threads t = 0 .. T-1 that call it with the same
// exchange region x (complex points as float2); kPowers picks the twiddle
// scheme (see "Twiddles").  Every thread of the block calls it (it holds
// __syncthreads), possibly for many transforms at once, each with its own
// region.
//
// Which thread holds which point.  Before the call thread t holds, in
// vr[q], vi[q] (q = 0 .. 15), the input points x[t + T q]; after it,
// the outputs X[t + T q].  So a caller loads and stores points at
// stride T with consecutive threads on consecutive points.
//
// Passes (Stockham autosort, Govindaraju et al., SC 2008): radix 16 while
// 16 or more points remain per sub-transform, then the rest:
//   N = 256            16, 16                 (one exchange)
//   N = 512 .. 2048    16, 16, N / 256        (two)
//   N = 4096           16, 16, 16             (two)
//   N = 8192, 16384    16, 16, 16, N / 4096   (three)
// A pass with sub-transform size Ns (the product of the earlier radices)
// and radix R has N / R butterflies j; butterfly j takes its inputs at
// j + r N / R (r < R), multiplies input r by W_{Ns R}^{(j mod Ns) r}, and
// puts output r at (j / Ns) Ns R + (j mod Ns) + r Ns.  Thread t does the
// 16 / R butterflies j = t + m T (m < 16 / R): their inputs j + r N / R =
// t + T (m + r 16 / R) are exactly its points x[t + T q], in every pass.
// So a pass reads only the thread's own registers.  Between passes the
// outputs go through shared memory once: each thread writes its
// outputs at the Stockham positions, the block synchronises, each
// thread reads back the points t + T q, and the block synchronises again.
// The last pass has Ns R = N, so its output r of butterfly m is
// X[t + T (m + r 16 / R)]: it stays in the registers, in natural order,
// with no exchange.
//
// Inside a pass the R-point DFT runs in registers: radix 16 as 4 x 4,
// radix 8 as 2 x 4 (decimation in frequency), radix 4 and 2 directly,
// with the 16th roots of unity as float literals (float64 values,
// rounded once).
//
// Twiddles: W_N^k = e^{-2 pi i k / N}, k < N, a host table computed in
// float64 at the integer index k and rounded to float32 (tw, float2 (re,
// im) pairs, so that each twiddle is one 8-byte load).  The pass twiddle
// W_{Ns R}^{(j mod Ns) r} is W_N^{e r}, e = (j mod Ns) N / (Ns R): an
// integer index, never an angle formed as a float product.  By default
// (K10) each is the table entry e r < N.  With kPowers (K6) a thread
// loads one entry per butterfly, w = W_N^e, and forms w^2 .. w^15 by
// running products (w^r is r - 1 float32 products of one rounded entry),
// and the last pass loads W_N^{t r} (r < R) and multiplies it by the
// exact 16th root W_16^{m r}.  That saves loads where they cost: the
// Ns = 16 pass's 15 loads a thread each touch 16 cache lines a warp, and
// above 2048 points the tables (32..128 KB) do not stay in L1.  On the
// H100 K6's outputs stay within 6e-7 of a float64 FFT, relative to their
// largest magnitude, the order of a table entry per twiddle
// (chip_smoke.py).
//
// Bank conflicts.  The exchanges move each point as one 8-byte float2,
// which a warp serves as two half-warps of 16 lanes; a half-warp is
// conflict-free when its 16 addresses differ mod 16 (in float2 units).
// Point a of a transform sits at pad(a) = a + a / 16 of its region;
// regions lie ld float2 apart, and the caller chooses ld so that no
// half-warp's store or load of an exchange hits one bank twice:
// ld = pad(N) + 16 / min(columns, 16) when consecutive lanes hold
// consecutive transforms (K10's stage A: columns of the tile), and ld =
// pad(N) when 16 consecutive lanes hold 16 consecutive t, a multiple of
// 16 first, of one transform (K10's stage B, K6).
// tests/test_torch_fft_big.py keeps a host copy of the plan, the padding,
// both twiddle schemes and the three lane maps, and replays them on the
// CPU; a change here is made there too.

#pragma once

#include <cuda_runtime.h>

namespace fft_reg_detail {

constexpr int kPoints = 16;      // points per thread
constexpr int kPadShift = 4;     // one padding word per 16 points

__host__ __device__ constexpr int pad(int a) { return a + (a >> kPadShift); }

// cos(2 pi k / 16) for k = 0..4, and the 16th roots of unity
// W_16^k = cos(2 pi k / 16) - i sin(2 pi k / 16); k is a constant after
// unrolling, so every call folds to a literal.
__device__ __forceinline__ constexpr float c16(int k) {
  return k == 0   ? 1.0f
         : k == 1 ? 0.92387953251128674f
         : k == 2 ? 0.70710678118654752f
         : k == 3 ? 0.38268343236508978f
                  : 0.0f;
}

__device__ __forceinline__ constexpr float w16r(int k) {
  return (k & 15) <= 4    ? c16(k & 15)
         : (k & 15) <= 8  ? -c16(8 - (k & 15))
         : (k & 15) <= 12 ? -c16((k & 15) - 8)
                          : c16(16 - (k & 15));
}

// -sin(x) = -cos(x - pi / 2)
__device__ __forceinline__ constexpr float w16i(int k) {
  return -w16r(k + 12);
}

__device__ __forceinline__ void cmul(float& ar, float& ai, float wr,
                                     float wi) {
  const float tr = ar * wr - ai * wi;
  ai = ar * wi + ai * wr;
  ar = tr;
}

// Radix 4 in place on v[B + S r]; outputs in natural order at the same
// positions.
template <int B, int S>
__device__ __forceinline__ void dft4(float (&vr)[kPoints],
                                     float (&vi)[kPoints]) {
  const float t0r = vr[B] + vr[B + 2 * S], t0i = vi[B] + vi[B + 2 * S];
  const float t1r = vr[B] - vr[B + 2 * S], t1i = vi[B] - vi[B + 2 * S];
  const float t2r = vr[B + S] + vr[B + 3 * S];
  const float t2i = vi[B + S] + vi[B + 3 * S];
  const float t3r = vr[B + S] - vr[B + 3 * S];
  const float t3i = vi[B + S] - vi[B + 3 * S];
  // y0 = t0 + t2, y1 = t1 - i t3, y2 = t0 - t2, y3 = t1 + i t3
  vr[B] = t0r + t2r;
  vi[B] = t0i + t2i;
  vr[B + S] = t1r + t3i;
  vi[B + S] = t1i - t3r;
  vr[B + 2 * S] = t0r - t2r;
  vi[B + 2 * S] = t0i - t2i;
  vr[B + 3 * S] = t1r - t3i;
  vi[B + 3 * S] = t1i + t3r;
}

// Radix 8 on v[B + S r]: a[n] = x[n] + x[n+4], b[n] = (x[n] - x[n+4])
// W_8^n, then DFT4 of each; X[2k] ends at position k, X[2k+1] at 4 + k.
template <int B, int S>
__device__ __forceinline__ void dft8(float (&vr)[kPoints],
                                     float (&vi)[kPoints]) {
#pragma unroll
  for (int n = 0; n < 4; ++n) {
    const int p = B + S * n, q = B + S * (n + 4);
    float dr = vr[p] - vr[q], di = vi[p] - vi[q];
    vr[p] += vr[q];
    vi[p] += vi[q];
    if (n) cmul(dr, di, w16r(2 * n), w16i(2 * n));
    vr[q] = dr;
    vi[q] = di;
  }
  dft4<B, S>(vr, vi);
  dft4<B + 4 * S, S>(vr, vi);
}

// Radix 16 on v[B + r] (S = 1): with n = 4 i1 + i2 and k = k1 + 4 k2,
// the DFT4 over i1 for each i2, the twiddle W_16^{i2 k1}, the DFT4 over
// i2 for each k1; X[k1 + 4 k2] ends at position 4 k1 + k2.
template <int B>
__device__ __forceinline__ void dft16(float (&vr)[kPoints],
                                      float (&vi)[kPoints]) {
  dft4<B + 0, 4>(vr, vi);
  dft4<B + 1, 4>(vr, vi);
  dft4<B + 2, 4>(vr, vi);
  dft4<B + 3, 4>(vr, vi);
  // position i2 + 4 k1 now holds Y[k1][i2]: twiddle it
#pragma unroll
  for (int k1 = 1; k1 < 4; ++k1) {
#pragma unroll
    for (int i2 = 1; i2 < 4; ++i2) {
      cmul(vr[B + i2 + 4 * k1], vi[B + i2 + 4 * k1], w16r(i2 * k1),
           w16i(i2 * k1));
    }
  }
  dft4<B + 0, 1>(vr, vi);
  dft4<B + 4, 1>(vr, vi);
  dft4<B + 8, 1>(vr, vi);
  dft4<B + 12, 1>(vr, vi);
}

// Register position of output r of a radix-R DFT run by the functions
// above (on positions B + S * pos).
template <int R>
__device__ __forceinline__ constexpr int out_pos(int r) {
  return R == 16 ? 4 * (r & 3) + (r >> 2)
                 : (R == 8 ? 4 * (r & 1) + (r >> 1) : r);
}

// Radix-R butterflies of one pass on the thread's 16 points: butterfly m
// (m < 16 / R) holds inputs r at v[m + r 16 / R].  Multiplies input r
// by W_N^{e r}, e = (j mod Ns) N / (Ns R), j = t + m T, then runs the DFT
// in place.  The twiddles (see "Twiddles" above): with kPowers false, the
// table entry e r for each; with kPowers true, a pass of one butterfly a
// thread (R = 16) loads w = W_N^e and takes w^r by running products, and
// the last pass (Ns R = N, so j = t + m T < Ns) loads W_N^{t r} and
// multiplies it by the constant W_16^{m r} = W_N^{m T r}.
template <int N, int R, int NS, bool kPowers>
__device__ __forceinline__ void pass(float (&vr)[kPoints],
                                     float (&vi)[kPoints], int t,
                                     const float2* __restrict__ tw) {
  constexpr int T = N / kPoints;
  constexpr int M = kPoints / R;
  constexpr int unit = N / (NS * R);
  if constexpr (NS > 1 && kPowers && M == 1) {
    const float2 w = __ldg(tw + (t & (NS - 1)) * unit);
    float pr = w.x, pi = w.y;
#pragma unroll
    for (int r = 1; r < R; ++r) {
      cmul(vr[r], vi[r], pr, pi);
      if (r + 1 < R) cmul(pr, pi, w.x, w.y);
    }
  } else if constexpr (NS > 1 && kPowers) {
    static_assert(NS * R == N, "M > 1 only in the last pass");
#pragma unroll
    for (int r = 1; r < R; ++r) {
      const float2 a = __ldg(tw + t * r);
#pragma unroll
      for (int m = 0; m < M; ++m) {
        float wr = a.x, wi = a.y;
        if ((m * r) % 16) cmul(wr, wi, w16r(m * r), w16i(m * r));
        cmul(vr[m + r * M], vi[m + r * M], wr, wi);
      }
    }
  } else if constexpr (NS > 1) {
#pragma unroll
    for (int m = 0; m < M; ++m) {
      const int e = ((t + m * T) & (NS - 1)) * unit;
#pragma unroll
      for (int r = 1; r < R; ++r) {
        const float2 w = __ldg(tw + r * e);
        cmul(vr[m + r * M], vi[m + r * M], w.x, w.y);
      }
    }
  }
  if constexpr (R == 16) {
    dft16<0>(vr, vi);
  } else if constexpr (R == 8) {
    dft8<0, 2>(vr, vi);
    dft8<1, 2>(vr, vi);
  } else if constexpr (R == 4) {
    dft4<0, 4>(vr, vi);
    dft4<1, 4>(vr, vi);
    dft4<2, 4>(vr, vi);
    dft4<3, 4>(vr, vi);
  } else {
#pragma unroll
    for (int m = 0; m < 8; ++m) {
      const float ar = vr[m], ai = vi[m];
      vr[m] = ar + vr[m + 8];
      vi[m] = ai + vi[m + 8];
      vr[m + 8] = ar - vr[m + 8];
      vi[m + 8] = ai - vi[m + 8];
    }
  }
}

// Writes the pass's outputs at their Stockham positions, synchronises,
// reads back the points t + T q, synchronises.
template <int N, int R, int NS>
__device__ __forceinline__ void exchange(float (&vr)[kPoints],
                                         float (&vi)[kPoints], int t,
                                         float2* x) {
  constexpr int T = N / kPoints;
  constexpr int M = kPoints / R;
#pragma unroll
  for (int m = 0; m < M; ++m) {
    const int j = t + m * T;
    const int o = (j / NS) * NS * R + (j & (NS - 1));
#pragma unroll
    for (int r = 0; r < R; ++r) {
      x[pad(o + r * NS)] =
          make_float2(vr[m + out_pos<R>(r) * M], vi[m + out_pos<R>(r) * M]);
    }
  }
  __syncthreads();
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    const float2 v = x[pad(t + T * q)];
    vr[q] = v.x;
    vi[q] = v.y;
  }
  __syncthreads();
}

// The last pass leaves output r of butterfly m at v[m + out_pos(r) M];
// X[t + T (m + r M)] belongs at v[m + r M].
template <int R>
__device__ __forceinline__ void natural(float (&vr)[kPoints],
                                        float (&vi)[kPoints]) {
  if constexpr (R == 16 || R == 8) {
    constexpr int M = kPoints / R;
    float tr[kPoints], ti[kPoints];
#pragma unroll
    for (int q = 0; q < kPoints; ++q) {
      tr[q] = vr[q];
      ti[q] = vi[q];
    }
#pragma unroll
    for (int m = 0; m < M; ++m) {
#pragma unroll
      for (int r = 0; r < R; ++r) {
        vr[m + r * M] = tr[m + out_pos<R>(r) * M];
        vi[m + r * M] = ti[m + out_pos<R>(r) * M];
      }
    }
  }
}

}  // namespace fft_reg_detail

template <int N, bool kPowers = false>
__device__ __forceinline__ void fft_reg(float (&vr)[fft_reg_detail::kPoints],
                                        float (&vi)[fft_reg_detail::kPoints],
                                        int t, float2* x,
                                        const float2* __restrict__ tw) {
  using namespace fft_reg_detail;
  static_assert(N >= 256 && N <= 16384 && (N & (N - 1)) == 0,
                "fft_reg: 256..16384 points");
  pass<N, 16, 1, kPowers>(vr, vi, t, tw);
  exchange<N, 16, 1>(vr, vi, t, x);
  pass<N, 16, 16, kPowers>(vr, vi, t, tw);
  if constexpr (N == 256) {
    natural<16>(vr, vi);
  } else if constexpr (N <= 2048) {
    exchange<N, 16, 16>(vr, vi, t, x);
    pass<N, N / 256, 256, kPowers>(vr, vi, t, tw);
    natural<N / 256>(vr, vi);
  } else {
    exchange<N, 16, 16>(vr, vi, t, x);
    pass<N, 16, 256, kPowers>(vr, vi, t, tw);
    if constexpr (N == 4096) {
      natural<16>(vr, vi);
    } else {
      exchange<N, 16, 256>(vr, vi, t, x);
      pass<N, N / 4096, 4096, kPowers>(vr, vi, t, tw);
      natural<N / 4096>(vr, vi);
    }
  }
}
