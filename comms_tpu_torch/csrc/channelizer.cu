// K-channel polyphase DFT channelizer, for Hopper (sm_90a).
//
//   f32 re/im planes [N] -> branch sums -> K-point FFT -> yr, yi [N/K, K]
//   (frames-major)
//
// Replaces the TPU kernel comms_tpu/kernels/channelizer_pallas.py::
// channelize_pallas_planar (its pl.pallas_call); the Python wrapper is
// comms_tpu_torch/kernels/channelizer.py, the plain PyTorch version of the
// same function is channelize_plain beside it.
//
// What it computes (comms_tpu/kernels/channelizer_pallas.py:13-14,
// :156-161), with K channels, M taps per branch, C[k-1, c] = h[k*K - 1 - c]
// and x[n < 0] the carried context ctx[ctx_len + n]:
//   V[m, c]  = sum_{k=1..M} C[k-1, c] * x[(m - k)*K + c + 1]
//   Y[m, ch] = sum_{c<K} V[m, c] * W^((c + 1)*ch),   W = exp(-2j*pi/K).
// The branch-reversal phase is a relabelling: with U[m, n] = V[m, (n - 1)
// mod K], and W^(K*ch) = 1,
//   Y[m, ch] = sum_{n<K} U[m, n] * W^(n*ch) = DFT_K(U[m, .])[ch],
// so Y is a plain forward DFT of U, with no post-twiddle.  U[m, n] reads
// x[(m - k)*K + n] for n >= 1 and x[(m - k + 1)*K] for n = 0 (branch K-1's
// sample K is the next frame row's sample 0).
//
// Bound on the H100: per complex input sample it moves 16 bytes (8 in,
// 8 out; 268 MB at N = 16.8M, ~80 us at 3.35 TB/s) and does 2M branch
// FMAs plus ~5 log2(K) FFT flops a frame point (K = 64, M = 8: ~16 FMAs
// and ~30 flops a sample, ~25 us of issue on the CUDA cores).  So device
// memory bounds it, provided the instructions around the arithmetic stay
// few and the copies stay in flight.  The design:
// - Tiles of F = 4096/K frames; block b of 256 threads walks tiles b,
//   b + B, b + 2B, ... (B blocks, up to 8 for each block the card holds at
//   once, from the wrapper, fixed by the shape).  The window of a tile,
//   rows tile*F - M .. tile*F + F - 1 of K samples, lies in one of two
//   shared buffers; the block's next window is copied with cp.async into
//   the other buffer while this tile computes.  The blocks in flight
//   cover consecutive tiles, so a window's M rows of look-back were just
//   read by the block of the tile before and come from L2: device memory
//   sees each input sample about once.  (Runs of consecutive tiles with
//   the look-back copied from buffer to buffer ran slower on the H100,
//   and one wave of blocks slower still: tools/k8_compare.py, variant
//   "runs", "blocks_264", "runs_264".)
// - Branch sums register-blocked: thread (run r, index n) takes the M taps
//   of branch (n - 1) mod K into registers (from a shared table: held
//   across the tile they spilled) and slides over 16 consecutive
//   frames, loading each of the 16 + M - 1 window samples it needs once
//   and adding it into the frames it reaches (16 M FMAs a plane).  Lanes
//   on consecutive n read consecutive words; below K = 32, where a warp
//   spans 32/K runs 16 rows apart, the window rows are skewed by one row
//   every 16 rows, so those runs fall on other banks.
// - U goes back over the same buffer (the window is dead by then) in
//   chunks of 16 points, one chunk a DFT thread, laid out so that the DFT
//   threads' 128-bit loads and exchanges are free of bank conflicts, and
//   the branch threads' stores too from K = 32 (K <= 16: chunks 20 words
//   apart, stores 2-way at K = 16; K >= 32: a padded frame of K/16 chunks
//   with a swizzle of the 16-byte units; tests/test_torch_channelizer_
//   replay.py replays every pattern).
// - The DFT in registers, 16 points a thread, with the radix-16, -8 and -4
//   DFTs of fft_reg.cuh (float64 roots rounded once, as literals).  K <= 16:
//   a thread holds 16/K whole frames and runs dft16, dft8, dft4 or a
//   butterfly on each: no exchange, no twiddle.  K = 16 P (P = 2, 4, 8): P
//   lanes of one warp share a frame; lane t holds U[t + P q], q < 16, runs
//   dft16 over q, multiplies output p by W_K^(t p) (t p < K: an exact index
//   into the float64-made root table, kept in shared memory as [p][t]:
//   the index depends on the lane, so a constant-bank operand would
//   serialise P ways), writes its 16 points back into its chunk, and after
//   a __syncwarp reads the 16/P outputs p of every lane that it finishes
//   with a radix-P DFT over t: Y[p + 16 s], s < P.
// - Output straight from registers in full 32-byte sectors: above K = 16
//   the P lanes of a frame hold adjacent pieces of each 16-channel group;
//   at K <= 16 each thread's 16 outputs are contiguous, so the lanes of a
//   pair swap halves through their own chunks (a __syncwarp) before the
//   128-bit stores.
// - Three barriers a tile (window in; window read; U in), 256 threads,
//   at most 128 registers and no spills: two blocks an SM, with at most
//   108 KB of shared memory a block (K = 128, M = 16).
// On the H100 at N = 16.8M it runs at ~0.78 of its bytes bound at K = 16,
// 64 and 128 alike; cutting the FFT or all taps but one does not move it
// (tools/k8_compare.py), so the copies in flight set its time.
// Not carried over from the TPU kernel: the 128-lane packing, roll+select
// relayouts and the bf16x3 split DFT products (float32 FFT here).

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_reg.cuh"

namespace {

using fft_reg_detail::cmul;
using fft_reg_detail::dft16;
using fft_reg_detail::dft4;
using fft_reg_detail::dft8;
using fft_reg_detail::kPoints;
using fft_reg_detail::out_pos;

constexpr int kThreads = 256;
constexpr int kTileSamples = 4096;   // frames x channels of a tile
constexpr int kRun = 16;             // frames a branch thread slides over
constexpr int kMaxTaps = 16;

template <int K>
struct Geo {
  static constexpr int F = kTileSamples / K;       // frames a tile
  static constexpr int P = K < 16 ? 1 : K / 16;    // DFT lanes a frame
  static constexpr int FPT = K < 16 ? 16 / K : 1;  // frames a DFT thread
  static constexpr bool kSkew = K < 32;            // window row skew
  static constexpr int kCopy = K < 4 ? 2 : 4;      // floats a cp.async
  // U: K <= 16 chunks of 20 words; K >= 32 frames of 4P + 4 units.
  static constexpr int kUWords = K <= 16 ? 20 * 256 : 4 * (4 * P + 4) * (F);
  static_assert(F * K / kPoints == kThreads, "16 points a DFT thread");
  static_assert(K * (F / kRun) == kThreads, "one branch run a thread");
};

// Word offset of window row q (rows of K samples; below K = 32 every 16
// rows are followed by one row of skew).
template <int K>
__device__ __forceinline__ int row_word(int q) {
  return Geo<K>::kSkew ? (q + (q >> 4)) * K : q * K;
}

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

// Words of one plane of one buffer: the larger of the window (F + M rows)
// and U.
template <int K>
__host__ __device__ constexpr int buffer_words(int M) {
  using G = Geo<K>;
  const int rows = G::F + M;
  const int win = G::kSkew ? (rows + (rows + 15) / 16) * K : rows * K;
  return round4(win > G::kUWords ? win : G::kUWords);
}

// Swizzle of the 16-byte units of frame m's chunk t (K >= 32).
template <int K>
__device__ __forceinline__ int swz(int m, int t) {
  if constexpr (K == 32) {
    return m & 3;
  } else if constexpr (K == 64) {
    return (((t >> 1) & 1) << 1) | (m & 1);
  } else {
    return (((t >> 1) & 1) << 1) | ((t >> 2) & 1);
  }
}

// Word of unit u (of 4) of chunk (m, t), K >= 32.
template <int K>
__device__ __forceinline__ int unit_word(int m, int t, int u) {
  constexpr int P = Geo<K>::P;
  return 4 * ((4 * P + 4) * m + 4 * t + (u ^ swz<K>(m, t)));
}

// Stores of the spectrum to device memory.
__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void st2(float* p, float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

template <int kFloats>
__device__ __forceinline__ void cp_async(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if constexpr (kFloats == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
                 "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d),
                 "l"(src));
  }
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

struct Shape {
  int M;            // taps per branch
  int ctx_len;      // input context samples
  int tiles;        // n_frames / F
  int buf;          // words of one plane of one buffer
  int aligned;      // planes aligned for the cp.async copies
};

// Rows q0 .. q0 + count - 1 of the window of `tile` (global frame row
// tile*F - M + q) into buffer w (re plane, then im at w + s.buf).
// cp.async when the rows lie in the planes and they are aligned, else
// loads, with the context for x < 0.
template <int K>
__device__ __forceinline__ void load_rows(
    float* w, const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ ctx_re, const float* __restrict__ ctx_im,
    const Shape& s, int tile, int q0, int count) {
  using G = Geo<K>;
  const int64_t r0 = static_cast<int64_t>(tile) * G::F - s.M + q0;
  if (s.aligned && r0 >= 0) {
    constexpr int cpr = K / G::kCopy;
    const int n = count * cpr;
#pragma unroll 1
    for (int plane = 0; plane < 2; ++plane) {
      const float* src = (plane ? im : re) + r0 * K;
      float* dst = w + plane * s.buf;
      for (int c = threadIdx.x; c < n; c += kThreads) {
        const int q = c / cpr;
        const int e = (c - q * cpr) * G::kCopy;
        cp_async<G::kCopy>(dst + row_word<K>(q0 + q) + e, src + q * K + e);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    const int n = count * K;
#pragma unroll 1
    for (int plane = 0; plane < 2; ++plane) {
      const float* src = plane ? im : re;
      const float* ctx = plane ? ctx_im : ctx_re;
      float* dst = w + plane * s.buf;
      for (int c = threadIdx.x; c < n; c += kThreads) {
        const int q = c / K;
        const int e = c - q * K;
        const int64_t x = (r0 + q) * K + e;
        float v = 0.f;
        if (x >= 0) {
          v = src[x];
        } else if (x >= -s.ctx_len) {
          v = ctx[s.ctx_len + x];
        }
        dst[row_word<K>(q0 + q) + e] = v;
      }
    }
  }
}

// Branch sums of one plane: acc[j] = U[16 r + j, n] of the tile, terms in
// the order k = M .. 1 (d[i] is the tap of term k = M - i).  x[s] is
// window row 16 r + s (+1 for n = 0), element n.
template <int K>
__device__ __forceinline__ void branch_plane(const float* w, int r, int n,
                                             int M, const float* d,
                                             float (&acc)[kRun]) {
  const int dl = n == 0;
  const float* b = w + (Geo<K>::kSkew ? (17 * r + dl) * K : (16 * r + dl) * K)
                   + n;
  float x[kRun + kMaxTaps - 1];
#pragma unroll
  for (int s = 0; s < kRun + kMaxTaps - 1; ++s) {
    if (s < kRun - 1 + M) {
      if constexpr (Geo<K>::kSkew) {
        // (16 r + dl + s) >> 4 = r + (dl + s) >> 4: 0 below s = 15, 1 above.
        const int g = s < 15 ? 0 : (s > 15 ? 1 : dl);
        x[s] = b[(s + g) * K];
      } else {
        x[s] = b[s * K];
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kRun; ++j) acc[j] = 0.f;
#pragma unroll
  for (int i = 0; i < kMaxTaps; ++i) {
    if (i < M) {
#pragma unroll
      for (int j = 0; j < kRun; ++j) acc[j] = fmaf(d[i], x[j + i], acc[j]);
    }
  }
}

// U of this branch thread's 16 frames into the chunks of the DFT threads.
template <int K>
__device__ __forceinline__ void put_u(float* w, int r, int n,
                                      const float (&a)[kRun]) {
  using G = Geo<K>;
  if constexpr (K <= 16) {
    // frame 16 r + j is point (j % FPT) K + n of chunk r K + j / FPT
    float* b = w + 20 * r * K + n;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      b[20 * (j / G::FPT) + (j % G::FPT) * K] = a[j];
    }
  } else {
    constexpr int P = G::P;
    const int t = n % P, q = n / P;
#pragma unroll
    for (int j = 0; j < kRun; ++j) {
      const int m = kRun * r + j;
      w[unit_word<K>(m, t, q >> 2) + (q & 3)] = a[j];
    }
  }
}

// v[a .. a + 3] as a float4 (a a constant after unrolling).
template <int N>
__device__ __forceinline__ float4 f4(const float (&v)[N], int a = 0) {
  return make_float4(v[a], v[a + 1], v[a + 2], v[a + 3]);
}

// K <= 16: the thread's 16 points (16/K frames, point n of local frame f
// in v[f K + n]) -> their DFTs; output ch of local frame f ends at
// v[f K + out_pos<K>(ch)].
template <int K>
__device__ __forceinline__ void frame_dfts(float (&vr)[kPoints],
                                           float (&vi)[kPoints]) {
  if constexpr (K == 16) {
    dft16<0>(vr, vi);
  } else if constexpr (K == 8) {
    dft8<0, 1>(vr, vi);
    dft8<8, 1>(vr, vi);
  } else if constexpr (K == 4) {
    dft4<0, 1>(vr, vi);
    dft4<4, 1>(vr, vi);
    dft4<8, 1>(vr, vi);
    dft4<12, 1>(vr, vi);
  } else {
#pragma unroll
    for (int f = 0; f < 8; ++f) {
      const float ar = vr[2 * f], ai = vi[2 * f];
      vr[2 * f] = ar + vr[2 * f + 1];
      vi[2 * f] = ai + vi[2 * f + 1];
      vr[2 * f + 1] = ar - vr[2 * f + 1];
      vi[2 * f + 1] = ai - vi[2 * f + 1];
    }
  }
}

template <int K>
__device__ __forceinline__ constexpr int frame_pos(int ch) {
  return K == 16 ? out_pos<16>(ch) : (K == 8 ? out_pos<8>(ch) : ch);
}

// K <= 16: DFT thread tau, its chunk at w + 20 tau (both planes), output
// floats 16 tau .. 16 tau + 15 of the tile at y (+ the plane's offset).
template <int K>
__device__ __forceinline__ void dft_small(float* w, int buf, float* yr,
                                          float* yi) {
  const int tau = threadIdx.x;
  float vr[kPoints], vi[kPoints];
  float* cr = w + 20 * tau;
  float* ci = cr + buf;
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const float4 a = *reinterpret_cast<const float4*>(cr + 4 * u);
    const float4 b = *reinterpret_cast<const float4*>(ci + 4 * u);
    vr[4 * u] = a.x; vr[4 * u + 1] = a.y; vr[4 * u + 2] = a.z;
    vr[4 * u + 3] = a.w;
    vi[4 * u] = b.x; vi[4 * u + 1] = b.y; vi[4 * u + 2] = b.z;
    vi[4 * u + 3] = b.w;
  }
  frame_dfts<K>(vr, vi);
  // Output i = f K + ch in natural order into the own chunk, then each
  // lane of a pair stores the units 2k + (lane & 1) (k < 4) of the pair's
  // 32 floats: 32-byte sectors, whole.
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float a[4], b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int i = 4 * u + e;
      const int p = (i / K) * K + frame_pos<K>(i % K);
      a[e] = vr[p];
      b[e] = vi[p];
    }
    *reinterpret_cast<float4*>(cr + 4 * u) = f4(a);
    *reinterpret_cast<float4*>(ci + 4 * u) = f4(b);
  }
  __syncwarp();
  const int odd = tau & 1;
  const float* pr = w + 20 * (tau - odd);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int unit = 2 * k + odd;             // of the pair's 8
    const float* src = pr + 20 * (unit >> 2) + 4 * (unit & 3);
    const int o = 16 * (tau - odd) + 4 * unit;
    st4(yr + o, *reinterpret_cast<const float4*>(src));
    st4(yi + o, *reinterpret_cast<const float4*>(src + buf));
  }
}

// K = 16 P: DFT lane (frame m, t); tw[p P + t] = W_K^(t p); y at the tile's
// first output of frame 0.
template <int K>
__device__ __forceinline__ void dft_large(float* w, int buf,
                                          const float2* tw, float* yr,
                                          float* yi) {
  constexpr int P = Geo<K>::P;
  constexpr int J = kPoints / P;              // outputs p a lane finishes
  const int m = threadIdx.x / P, t = threadIdx.x % P;
  float vr[kPoints], vi[kPoints];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int o = unit_word<K>(m, t, u);
    const float4 a = *reinterpret_cast<const float4*>(w + o);
    const float4 b = *reinterpret_cast<const float4*>(w + buf + o);
    vr[4 * u] = a.x; vr[4 * u + 1] = a.y; vr[4 * u + 2] = a.z;
    vr[4 * u + 3] = a.w;
    vi[4 * u] = b.x; vi[4 * u + 1] = b.y; vi[4 * u + 2] = b.z;
    vi[4 * u + 3] = b.w;
  }
  // A_t[p] = sum_q U[t + P q] W_16^(q p), at v[out_pos<16>(p)]
  dft16<0>(vr, vi);
  // B_t[p] = W_K^(t p) A_t[p], back into the chunk in natural order
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    float a[4], b[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int p = 4 * u + e;
      float xr = vr[out_pos<16>(p)], xi = vi[out_pos<16>(p)];
      if (p > 0) {
        const float2 c = tw[p * P + t];
        cmul(xr, xi, c.x, c.y);
      }
      a[e] = xr;
      b[e] = xi;
    }
    const int o = unit_word<K>(m, t, u);
    *reinterpret_cast<float4*>(w + o) = f4(a);
    *reinterpret_cast<float4*>(w + buf + o) = f4(b);
  }
  __syncwarp();
  // The lane's outputs p (J of them) of every lane tt: v[j + J tt].
#pragma unroll
  for (int tt = 0; tt < P; ++tt) {
    if constexpr (P == 2) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {           // units t, t + 2
        const int o = unit_word<K>(m, tt, t + 2 * i);
        const float4 a = *reinterpret_cast<const float4*>(w + o);
        const float4 b = *reinterpret_cast<const float4*>(w + buf + o);
        const int j = 4 * i + J * tt;
        vr[j] = a.x; vr[j + 1] = a.y; vr[j + 2] = a.z; vr[j + 3] = a.w;
        vi[j] = b.x; vi[j + 1] = b.y; vi[j + 2] = b.z; vi[j + 3] = b.w;
      }
    } else if constexpr (P == 4) {             // unit t
      const int o = unit_word<K>(m, tt, t);
      const float4 a = *reinterpret_cast<const float4*>(w + o);
      const float4 b = *reinterpret_cast<const float4*>(w + buf + o);
      const int j = J * tt;
      vr[j] = a.x; vr[j + 1] = a.y; vr[j + 2] = a.z; vr[j + 3] = a.w;
      vi[j] = b.x; vi[j + 1] = b.y; vi[j + 2] = b.z; vi[j + 3] = b.w;
    } else {                                   // half of unit t / 2
      const int o = unit_word<K>(m, tt, t >> 1) + 2 * (t & 1);
      const float2 a = *reinterpret_cast<const float2*>(w + o);
      const float2 b = *reinterpret_cast<const float2*>(w + buf + o);
      const int j = J * tt;
      vr[j] = a.x; vr[j + 1] = a.y;
      vi[j] = b.x; vi[j + 1] = b.y;
    }
  }
  // Y[p + 16 s] = sum_tt W_P^(tt s) B_tt[p]
  float* fr = yr + m * K;
  float* fi = yi + m * K;
  if constexpr (P == 2) {
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float ar = vr[j], ai = vi[j];
      vr[j] = ar + vr[j + 8];
      vi[j] = ai + vi[j + 8];
      vr[j + 8] = ar - vr[j + 8];
      vi[j + 8] = ai - vi[j + 8];
    }
    // v[4 i + e + 8 s] is channel 16 s + 4 (t + 2 i) + e
#pragma unroll
    for (int s = 0; s < 2; ++s) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int o = 16 * s + 4 * (t + 2 * i);
        st4(fr + o, f4(vr, 4 * i + 8 * s));
        st4(fi + o, f4(vi, 4 * i + 8 * s));
      }
    }
  } else if constexpr (P == 4) {
    dft4<0, 4>(vr, vi);
    dft4<1, 4>(vr, vi);
    dft4<2, 4>(vr, vi);
    dft4<3, 4>(vr, vi);
    // v[e + 4 s] is channel 16 s + 4 t + e
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int o = 16 * s + 4 * t;
      st4(fr + o, f4(vr, 4 * s));
      st4(fi + o, f4(vi, 4 * s));
    }
  } else {
    dft8<0, 2>(vr, vi);
    dft8<1, 2>(vr, vi);
    // v[e + 2 out_pos<8>(s)] is channel 16 s + 2 t + e
#pragma unroll
    for (int s = 0; s < 8; ++s) {
      const int o = 16 * s + 2 * t;
      const int p = 2 * out_pos<8>(s);
      st2(fr + o, make_float2(vr[p], vr[p + 1]));
      st2(fi + o, make_float2(vi[p], vi[p + 1]));
    }
  }
}

// Block b walks tiles b, b + gridDim.x, ...  Per tile: wait for its
// window (barrier 1), start the copies of the block's next window, branch
// sums (barrier 2), U over the window (barrier 3), the DFT and the stores.
template <int K>
__global__ void __launch_bounds__(kThreads, 2)
channelize_kernel(const float* __restrict__ re, const float* __restrict__ im,
                  const float* __restrict__ ctx_re,
                  const float* __restrict__ ctx_im,
                  const float* __restrict__ C,
                  const float2* __restrict__ roots, const Shape s,
                  float* __restrict__ yr, float* __restrict__ yi) {
  using G = Geo<K>;
  constexpr int F = G::F, P = G::P;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  float2* const s_tw = reinterpret_cast<float2*>(smem + 4 * s.buf);
  float* const s_d = smem + 4 * s.buf + 2 * kPoints * P;
  const int tid = threadIdx.x;
  const int r = tid / K, n = tid % K;          // branch thread: run, index

  // s_d[i K + n]: the tap of term k = M - i of branch (n - 1) mod K
  for (int i = tid; i < s.M * K; i += kThreads) {
    const int nn = i % K;
    s_d[i] = C[(s.M - 1 - i / K) * K + (nn + K - 1) % K];
  }
  if constexpr (P > 1) {
    for (int i = tid; i < kPoints * P; i += kThreads) {
      s_tw[i] = roots[(i % P) * (i / P)];
    }
  }
  const int stride = static_cast<int>(gridDim.x);
  load_rows<K>(smem, re, im, ctx_re, ctx_im, s, blockIdx.x, 0, F + s.M);

  for (int tile = blockIdx.x, it = 0; tile < s.tiles; tile += stride, ++it) {
    float* const cur = smem + 2 * s.buf * (it & 1);
    float* const nxt = smem + 2 * s.buf * ((it + 1) & 1);
    cp_async_wait();
    __syncthreads();                  // window in; the last tile done
    if (tile + stride < s.tiles) {
      load_rows<K>(nxt, re, im, ctx_re, ctx_im, s, tile + stride, 0, F + s.M);
    }
    float ar[kRun], ai[kRun];
    {
      float d[kMaxTaps];
#pragma unroll
      for (int i = 0; i < kMaxTaps; ++i) {
        if (i < s.M) d[i] = s_d[i * K + n];
      }
      branch_plane<K>(cur, r, n, s.M, d, ar);
      branch_plane<K>(cur + s.buf, r, n, s.M, d, ai);
    }
    __syncthreads();                  // every thread has read the window
    put_u<K>(cur, r, n, ar);
    put_u<K>(cur + s.buf, r, n, ai);
    __syncthreads();                  // U in
    const int64_t o = static_cast<int64_t>(tile) * kTileSamples;
    if constexpr (K <= 16) {
      dft_small<K>(cur, s.buf, yr + o, yi + o);
    } else {
      dft_large<K>(cur, s.buf, s_tw, yr + o, yi + o);
    }
  }
}

template <int K>
int launch(const float* re, const float* im, const float* ctx_re,
           const float* ctx_im, int ctx_len, const float* C,
           const float2* roots, int M, int64_t n_frames, int blocks,
           float* yr, float* yi, cudaStream_t stream) {
  using G = Geo<K>;
  if (n_frames <= 0 || n_frames % G::F != 0 || M < 1 || M > kMaxTaps ||
      M * K - 1 > ctx_len || blocks < 1 || n_frames / G::F > INT32_MAX ||
      blocks > n_frames / G::F) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Shape s{M, ctx_len, static_cast<int>(n_frames / G::F), buffer_words<K>(M),
          0};
  s.aligned = ((reinterpret_cast<uintptr_t>(re) |
                reinterpret_cast<uintptr_t>(im)) &
               (4 * G::kCopy - 1)) == 0;
  const int smem = static_cast<int>(sizeof(float)) *
                   (4 * s.buf + 2 * kPoints * G::P + M * K);
  // The attribute is set only when a call needs more than before on this
  // device (setting it on every call costs host time on served paths).
  static int set_bytes[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > set_bytes[dev]) {
    err = cudaFuncSetAttribute(channelize_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_bytes[dev] = smem;
  }
  channelize_kernel<K><<<blocks, kThreads, smem, stream>>>(
      re, im, ctx_re, ctx_im, C, roots, s, yr, yi);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  Pointers on the current device: re/im [N], ctx
// [ctx_len] (only the trailing M*K - 1 samples are read), C [M][K] f32,
// roots [K] (re, im) f32 pairs, yr/yi [n_frames][K].  K divides 128, M <=
// 16; n_frames = N/K is a multiple of 4096/K; `blocks` (at most the number
// of tiles of 4096/K frames) blocks, block b walking tiles b, b + blocks,
// ....  Launches on `stream` without
// synchronising; returns cudaGetLastError() (or the error that stopped
// the launch).
extern "C" int channelize_launch(const void* re, const void* im,
                                 const void* ctx_re, const void* ctx_im,
                                 int ctx_len, const void* C,
                                 const void* roots, int K, int M,
                                 int64_t n_frames, int blocks, void* yr,
                                 void* yi, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
  const float2* rt = static_cast<const float2*>(roots);
#define COMMS_CH_CASE(KK)                                                    \
  case KK:                                                                   \
    return launch<KK>(f(re), f(im), f(ctx_re), f(ctx_im), ctx_len, f(C), rt, \
                      M, n_frames, blocks, o(yr), o(yi), st);
  switch (K) {
    COMMS_CH_CASE(2)
    COMMS_CH_CASE(4)
    COMMS_CH_CASE(8)
    COMMS_CH_CASE(16)
    COMMS_CH_CASE(32)
    COMMS_CH_CASE(64)
    COMMS_CH_CASE(128)
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef COMMS_CH_CASE
}
