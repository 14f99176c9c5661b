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
// What it computes, with K channels, M taps per branch, C[k-1, c] =
// h[k*K - 1 - c] (comms_tpu/kernels/channelizer_pallas.py:13-14), x[n < 0]
// the carried context ctx[ctx_len + n] and Y[j < 0] the carried spectrum
// tail (halo_in[hframes + j], frames-major [K]):
//   V[j, c]  = sum_{k=1..M} C[k-1, c] * x[(j - k)*K + c + 1]
//   Y[j, ch] = sum_{c<K} V[j, c] * root[((c + 1)*ch) mod K]
//   d[j, c]  = atan2_poly(cross, dotp),  dotp = yr*pr + yi*pi,
//              cross = yi*pr - yr*pi,  (yr, yi) = Y[j, c], (pr, pi) = Y[j-1, c]
//   a[t, c]  = sum_{m < Ta} h[m] * d[t*dec - m, c]
// root[n] = exp(-2j*pi*n/K), made on the host in float64 and rounded to
// float32.  Every sum is one chain in a fixed order: V over k = 1..M with
// fmaf from 0; Y over c = 0..K-1 with four fmaf a term (re: +vr*w.x,
// -vi*w.y; im: +vr*w.y, +vi*w.x); a over m = 0..Ta-1 with fmaf.  The
// demod's products and sums are rounded one by one (no contraction), in
// the TPU kernel's order (band_monitor_pallas.py:165-166): at stream start
// the carried tail is zero, atan2 of the signed-zero products gives 0 or
// +-pi, and a different order would move the first audio samples.  No
// term is dropped, not even one whose root is 0 or +-1 (that would change
// signed zeros).  So the output is bit-identical to the first (one output
// a thread, root table in shared memory) form of this kernel, whatever
// the tiling.  The kernel also writes the block's new carried state: the
// last hframes spectrum frames (frames-major, the memory of the JAX
// package's packed [halo_rows, 128]) and the last ctx_len input samples.
//
// Bound on the H100: per complex input sample it reads 8 bytes and writes
// 4/dec; it does 2M branch FMAs and 4K DFT FMAs per sample (the direct
// DFT: 1.07 G FMA at K = 16, N = 16.8M, ~0.032 ms on the CUDA cores), a
// demod (~45 instructions with the IEEE division) per channel frame and
// Ta/dec audio FMAs per channel frame.  Device memory (~0.045 ms at 16.8M
// samples) is not the limit; the instructions around the FMAs are.  The
// design cuts those:
// - Tiles of T = 4096/K frames (A = T/dec audio outputs of every channel).
//   Each block walks a run of consecutive tiles (the run length comes from
//   the wrapper, fixed by the shape), so the Ta - 1 phase differences and
//   the spectrum frame before a tile come from the tile before it instead
//   of being recomputed; only a run's first tile starts from the Ta frames
//   before it, computed (or, at the start of the call, read from the
//   carried spectrum tail).
// - Register-blocked spectrum: for K <= 16 one thread owns one frame and
//   all K channels (T/256 frames a thread below K = 16).  Its branch sums
//   V and then its K outputs stay in registers, the loops over c and ch
//   are unrolled with K a template parameter, so each root index is a
//   compile-time constant, and the roots and the branch matrix travel by
//   value in the launch's parameter block (a __grid_constant__ struct):
//   each DFT FMA takes its root as a constant-bank operand, with no load
//   and no index arithmetic.  Above K = 16, K/16 threads share a frame:
//   each computes 16 branch sums (a plane at a time), V goes through
//   shared memory branch-major, and each computes 16 channels (in two
//   passes of 8) against a per-group [c][16] root table in shared memory
//   (broadcast reads).  The register blocking changes which thread holds
//   which sum, never a sum's order.
// - The input window is held in shared memory as rows of K samples at a
//   padded stride Kp (Kp/4 odd), so that lanes one frame = one row apart
//   read their rows with conflict-free 128-bit loads; each row's pad holds
//   the next row's first samples (branch K-1 reads x[(j - k + 1)*K]).
//   Rows are copied with cp.async; for K <= 16 the next tile's window is
//   copied while the current tile demodulates and filters.
// - The demod reads Y[j] and Y[j-1] from rows of Y in shared memory (the
//   threads that own the frames stored them there; a tile's frame -1
//   comes from the stage before), 4 channels at a time, which keeps the
//   registers of 16 atan2s in flight free.  Three barriers a tile (six
//   above K = 16).
// - 256 threads a block, at most 128 registers a thread: two blocks an
//   SM, no spills at any K.
// - The audio FIR: a thread computes 4 channels of one output (one 128-bit
//   load of d and 4 FMAs a tap, taps loaded 4 at a time); d is held frames-
//   major at a padded stride Kd, which keeps those loads conflict-free at
//   K = 16, dec = 4.
// - Only the first and the last tile of the call touch the carried state
//   (block-uniform checks).
// Not carried over from the TPU kernel: the 128-lane packing, roll+select
// relayouts, composite audio views (_audio_mats), the 8-row halo alignment
// and the bf16x3 split products.
//
// Built without --use_fast_math: atan2_poly's division is IEEE-rounded
// and denormals are kept (atan2_poly.cuh).

#include <cuda_runtime.h>
#include <stdint.h>

#include "atan2_poly.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kTileSamples = 4096;   // T*K: frames x channels of a tile

// Window rows: at least K + 4 floats (the pad), odd in 16-byte units.
__host__ __device__ constexpr int padded(int k) {
  return k < 4 ? 4 : ((k / 4) % 2 == 0 ? k + 4 : k + 8);
}

// d and Y rows: at least K floats, odd in 16-byte units (K >= 4).
__host__ __device__ constexpr int rowpad(int k) {
  return k < 4 ? k : ((k / 4) % 2 == 0 ? k + 4 : k);
}

template <int K>
struct Geo {
  static constexpr int G = K < 16 ? K : 16;          // channels a thread
  static constexpr int P = K / G;                    // threads a frame
  static constexpr int T = kTileSamples / K;         // frames a tile
  static constexpr int R = T * P / kThreads;         // frames a thread
  static constexpr int kStride = kThreads / P;       // frames a pass
  static constexpr int Kp = padded(K);               // window row stride
  static constexpr int Kd = rowpad(K);               // d (and Y) rows
  static constexpr int CW = K < 4 ? K : 4;           // FIR channels a thread
  static constexpr int kCopy = K < 4 ? 2 : 4;        // floats a cp.async
  static_assert(R >= 1 && T % 32 == 0 && G % 2 == 0, "tile shape");
};

// The roots, and for K <= 16 the branch matrix [M][K] (M <= 16), by value.
template <int K>
struct Consts {
  float2 root[K];
  float C[Geo<K>::P == 1 ? 16 * K : 1];
};

struct Shape {
  int M;            // taps per branch
  int dec;          // audio decimation
  int Ta;           // audio taps
  int A;            // audio outputs per tile
  int hframes;      // carried spectrum frames
  int ctx_len;      // input context samples
  int run;          // tiles a block walks
  int aligned;      // planes aligned for the cp.async copies
  int tiles;        // n_frames / T
  int64_t n_frames; // N / K
  int64_t n_audio;  // n_frames / dec
};

// Shared memory, in floats (every part starts 16-byte aligned).
struct Layout {
  int d, y, prev, h, C, rt, total;
};

__host__ __device__ constexpr int round4(int n) { return (n + 3) / 4 * 4; }

template <int K>
__host__ __device__ inline Layout layout(const Shape& s) {
  using Gm = Geo<K>;
  Layout L;
  L.d = 2 * (Gm::T + s.M - 1) * Gm::Kp;             // window [2][rows][Kp]
  L.y = L.d + round4((s.Ta - 1 + Gm::T) * Gm::Kd);  // d [Ta-1+T][Kd]
  L.prev = L.y + (Gm::P == 1 ? 2 * Gm::T * Gm::Kd : 0);   // Y [2][T][Kd]
  L.h = L.prev + 4 * K;                             // prev [2][2][K]
  L.C = L.h + round4(s.Ta);                         // h [Ta]
  L.rt = L.C + (Gm::P > 1 ? round4(s.M * K) : 0);   // C [M][K]
  L.total = L.rt + (Gm::P > 1 ? 2 * K * K : 0);     // roots [P][K][16] f2
  return L;
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


// n floats (2 or 4) from shared memory into v[0..n).
template <int n>
__device__ __forceinline__ void lds(const float* p, float* v) {
  if constexpr (n == 4) {
    const float4 q = *reinterpret_cast<const float4*>(p);
    v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
  } else {
    const float2 q = *reinterpret_cast<const float2*>(p);
    v[0] = q.x; v[1] = q.y;
  }
}

template <int n>
__device__ __forceinline__ void sts(float* p, const float* v) {
  if constexpr (n == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *reinterpret_cast<float2*>(p) = make_float2(v[0], v[1]);
  }
}

// G floats at p (G even) in chunks of 4 (of 2 when G = 2).
template <int G>
__device__ __forceinline__ void lds_row(const float* p, float* v) {
#pragma unroll
  for (int j = 0; j < G; j += (G < 4 ? 2 : 4)) lds<(G < 4 ? 2 : 4)>(p + j, v + j);
}

template <int G>
__device__ __forceinline__ void sts_row(float* p, const float* v) {
#pragma unroll
  for (int j = 0; j < G; j += (G < 4 ? 2 : 4)) sts<(G < 4 ? 2 : 4)>(p + j, v + j);
}

// Window rows of tile `tile` into w (re plane, then im at w + rows*Kp),
// rows = T + M - 1: row q holds x[(tile*T - M + q)*K + e] for e < Kp (the
// pad e >= K holds the next row's first samples; the last row's pad only
// up to the one copy that holds element K, the last a frame reads).
// cp.async when the window lies in the planes and they are aligned (one
// group a thread), else loads with the context for x < 0.
template <int K>
__device__ __forceinline__ void load_window(
    float* w, const float* __restrict__ re, const float* __restrict__ im,
    const float* __restrict__ ctx_re, const float* __restrict__ ctx_im,
    const Shape& s, int64_t tile) {
  using Gm = Geo<K>;
  constexpr int Kp = Gm::Kp;
  const int rows = Gm::T + s.M - 1;
  const int64_t n0 = (tile * Gm::T - s.M) * K;
  if (s.aligned && n0 >= 0) {
    constexpr int cpr = Kp / Gm::kCopy;
    const int n = rows * cpr;
#pragma unroll 1
    for (int plane = 0; plane < 2; ++plane) {
      const float* src = (plane ? im : re) + n0;
      float* dst = w + plane * rows * Kp;
      for (int c = threadIdx.x; c < n; c += kThreads) {
        const int q = c / cpr;
        const int e = (c - q * cpr) * Gm::kCopy;
        if (q == rows - 1 && e >= K + Gm::kCopy) continue;
        cp_async<Gm::kCopy>(dst + q * Kp + e, src + q * K + e);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::);
  } else {
    const int n = rows * Kp;
#pragma unroll 1
    for (int plane = 0; plane < 2; ++plane) {
      const float* src = plane ? im : re;
      const float* ctx = plane ? ctx_im : ctx_re;
      float* dst = w + plane * rows * Kp;
      for (int c = threadIdx.x; c < n; c += kThreads) {
        const int q = c / Kp;
        const int e = c - q * Kp;
        if (q == rows - 1 && e >= K + Gm::kCopy) continue;
        const int64_t x = n0 + q * K + e;
        float v = 0.f;
        if (x >= 0) {
          v = src[x];
        } else if (x >= -s.ctx_len) {
          v = ctx[s.ctx_len + x];
        }
        dst[q * Kp + e] = v;
      }
    }
  }
}

// K <= 16: V and Y of the frame whose first window row is at wr/wi (row
// i; term k = 1..M reads row i + M - k).
template <int K>
__device__ __forceinline__ void frame_spectrum(const float* wr, const float* wi,
                                               int M, const Consts<K>& cst,
                                               float (&yr)[K], float (&yi)[K]) {
  constexpr int Kp = Geo<K>::Kp;
  constexpr int L = K < 4 ? 2 : 4;
  float vr[K], vi[K];
#pragma unroll
  for (int c = 0; c < K; ++c) vr[c] = vi[c] = 0.f;
  const float* br = wr + (M - 1) * Kp;
  const float* bi = wi + (M - 1) * Kp;
  // Branch K-1 reads element K of its row: the pad, i.e. element 0 of the
  // row after, which the iteration before loaded.
  float nr[L], ni[L];
  lds<L>(br + K, nr);
  lds<L>(bi + K, ni);
  float er = nr[0], ei = ni[0];
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    if (k < M) {
      float xr[K + 1], xi[K + 1];
      lds_row<K>(br - k * Kp, xr);
      lds_row<K>(bi - k * Kp, xi);
      xr[K] = er;
      xi[K] = ei;
#pragma unroll
      for (int c = 0; c < K; ++c) {
        vr[c] = fmaf(cst.C[k * K + c], xr[c + 1], vr[c]);
        vi[c] = fmaf(cst.C[k * K + c], xi[c + 1], vi[c]);
      }
      er = xr[0];
      ei = xi[0];
    }
  }
#pragma unroll
  for (int ch = 0; ch < K; ++ch) yr[ch] = yi[ch] = 0.f;
#pragma unroll
  for (int c = 0; c < K; ++c) {
#pragma unroll
    for (int ch = 0; ch < K; ++ch) {
      const float2 w = cst.root[((c + 1) * ch) % K];
      yr[ch] = fmaf(vr[c], w.x, yr[ch]);
      yr[ch] = fmaf(-vi[c], w.y, yr[ch]);
      yi[ch] = fmaf(vr[c], w.y, yi[ch]);
      yi[ch] = fmaf(vi[c], w.x, yi[ch]);
    }
  }
}

// K > 16: the 16 branch sums c0 .. c0+15 of one plane of the frame at w
// (a plane at a time keeps fewer registers live).
template <int K>
__device__ __forceinline__ void group_sums(const float* w, const float* s_C,
                                           int M, int c0, float (&v)[16]) {
  constexpr int Kp = Geo<K>::Kp;
#pragma unroll
  for (int c = 0; c < 16; ++c) v[c] = 0.f;
  const float* b = w + (M - 1) * Kp + c0;
#pragma unroll 1
  for (int k = 0; k < M; ++k) {
    float x[20], cc[16];
    lds_row<20>(b - k * Kp, x);       // elements c0 .. c0+19 (the pad)
    lds_row<16>(s_C + k * K + c0, cc);
#pragma unroll
    for (int c = 0; c < 16; ++c) v[c] = fmaf(cc[c], x[c + 1], v[c]);
  }
}

// K > 16: channels g*16 .. g*16+15 of frame i from V held branch-major
// (V[c] of frame i at Vr[c*T + i]: lanes on consecutive frames read
// consecutive words), against the group's root table rt[c][16], in two
// passes of 8 channels (fewer registers live; each channel's chain is
// the same).
template <int K>
__device__ __forceinline__ void group_dft(const float* Vr, const float* Vi,
                                          const float2* rt, float (&yr)[16],
                                          float (&yi)[16]) {
  constexpr int T = Geo<K>::T;
  const float4* w4 = reinterpret_cast<const float4*>(rt);
#pragma unroll
  for (int h = 0; h < 16; h += 8) {
    float ar[8], ai[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) ar[j] = ai[j] = 0.f;
#pragma unroll 2
    for (int c = 0; c < K; ++c) {
      const float xr = Vr[c * T], xi = Vi[c * T];
#pragma unroll
      for (int j = 0; j < 8; j += 2) {
        const float4 w = w4[c * 8 + (h + j) / 2];
        ar[j] = fmaf(xr, w.x, ar[j]);
        ar[j] = fmaf(-xi, w.y, ar[j]);
        ai[j] = fmaf(xr, w.y, ai[j]);
        ai[j] = fmaf(xi, w.x, ai[j]);
        ar[j + 1] = fmaf(xr, w.z, ar[j + 1]);
        ar[j + 1] = fmaf(-xi, w.w, ar[j + 1]);
        ai[j + 1] = fmaf(xr, w.w, ai[j + 1]);
        ai[j + 1] = fmaf(xi, w.z, ai[j + 1]);
      }
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      yr[h + j] = ar[j];
      yi[h + j] = ai[j];
    }
  }
}

template <int K>
struct Block {
  using Gm = Geo<K>;
  static constexpr int T = Gm::T, G = Gm::G, P = Gm::P, R = Gm::R;
  static constexpr int Kp = Gm::Kp, Kd = Gm::Kd, CW = Gm::CW;
  // Y rows: their own buffer for K <= 16 (the next window is copied over
  // the window meanwhile), the window's rows above (V, then Y, go there).
  static constexpr int Ky = P == 1 ? Kd : Kp;

  const Shape& s;
  const Consts<K>& cst;
  float* win;
  float* s_d;
  float* s_y;      // Y re rows [T][Ky], then Y im rows at s_y + yim
  float* s_prev;   // [2][2][K]: the last frame of the stage before
  float* s_h;
  float* s_C;
  float2* s_rt;
  int rows, yim, g, i0, c0;

  // Above K = 16: makes the compiler recompute the addresses derived from
  // the thread's frame and group in each phase instead of keeping them
  // live across the tile loop (they spilled at 128 registers).
  __device__ __forceinline__ void fence_index() {
    if constexpr (P > 1) asm volatile("" : "+r"(i0), "+r"(c0));
  }

  // Y of frame i (channels c0 .. c0+G-1) into its row, and the last
  // frame's also into s_prev[p] (the next stage's frame before its first).
  __device__ __forceinline__ void put_y(int p, int i, const float* yr,
                                        const float* yi) {
    sts_row<G>(s_y + i * Ky + c0, yr);
    sts_row<G>(s_y + yim + i * Ky + c0, yi);
    if (i == T - 1) {
      sts_row<G>(s_prev + 2 * p * K + c0, yr);
      sts_row<G>(s_prev + (2 * p + 1) * K + c0, yi);
    }
  }

  // Y of this thread's frames i >= lo, from the window, into their rows.
  // Above K = 16 it passes three barriers, which every thread reaches
  // (the rows are the window's).
  __device__ __forceinline__ void spectrum(int p, int lo) {
    if constexpr (P == 1) {
#pragma unroll 1
      for (int r = 0; r < R; ++r) {
        const int i = i0 + r * Gm::kStride;
        if (i >= lo) {
          float yr[K], yi[K];
          frame_spectrum<K>(win + i * Kp, win + (rows + i) * Kp, s.M, cst,
                            yr, yi);
          put_y(p, i, yr, yi);
        }
      }
    } else {
      const bool act = i0 >= lo;
      float vr[16], vi[16];
      if (act) {
        group_sums<K>(win + i0 * Kp, s_C, s.M, c0, vr);
        group_sums<K>(win + (rows + i0) * Kp, s_C, s.M, c0, vi);
      }
      __syncthreads();                  // every thread has read the window
      if (act) {
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          win[(c0 + j) * T + i0] = vr[j];
          win[rows * Kp + (c0 + j) * T + i0] = vi[j];
        }
      }
      __syncthreads();
      float yr[16], yi[16];
      if (act) group_dft<K>(win + i0, win + rows * Kp + i0,
                            s_rt + g * K * 16, yr, yi);
      __syncthreads();                  // every thread has read its V row
      if (act) put_y(p, i0, yr, yi);
    }
  }

  // Y of frames T - Ta .. T - 1 of the tile before the call's first: the
  // carried spectrum tail (frames before T - hframes are not needed).
  __device__ __forceinline__ void carried(int p, int lo,
                                          const float* __restrict__ halo_r,
                                          const float* __restrict__ halo_i) {
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r * Gm::kStride;
      if (i >= lo && i >= T - s.hframes) {
        const int64_t o = static_cast<int64_t>(s.hframes - T + i) * K + c0;
        float yr[G], yi[G];
#pragma unroll
        for (int j = 0; j < G; ++j) {
          yr[j] = halo_r[o + j];
          yi[j] = halo_i[o + j];
        }
        put_y(p, i, yr, yi);
      }
    }
  }

  // d of this thread's frames i >= lo into s_d row doff + i, from Y[i]
  // and Y[i - 1] in their rows (Y[-1] in s_prev[p ^ 1]), CW channels at a
  // time.  Writes the spectrum tail if halo.
  __device__ __forceinline__ void demod(int p, int lo, int doff, bool halo,
                                        float* __restrict__ halo_out_r,
                                        float* __restrict__ halo_out_i) {
#pragma unroll 1
    for (int r = 0; r < R; ++r) {
      const int i = i0 + r * Gm::kStride;
      if (i < lo) continue;
      const float* y = s_y + i * Ky + c0;
      const float* q = i > 0 ? y - Ky : s_prev + 2 * (p ^ 1) * K + c0;
      const int q_im = i > 0 ? yim : K;
      float* dd = s_d + (doff + i) * Kd + c0;
      const bool tail = halo && i >= T - s.hframes;
      const int64_t o = static_cast<int64_t>(i - T + s.hframes) * K + c0;
#pragma unroll 1
      for (int j = 0; j < G; j += CW) {
        float a[CW], b[CW], pr[CW], pi[CW], dv[CW];
        lds<CW>(y + j, a);
        lds<CW>(y + yim + j, b);
        lds<CW>(q + j, pr);
        lds<CW>(q + q_im + j, pi);
#pragma unroll
        for (int u = 0; u < CW; ++u) {
          const float dotp = __fadd_rn(__fmul_rn(a[u], pr[u]),
                                       __fmul_rn(b[u], pi[u]));
          const float cross = __fsub_rn(__fmul_rn(b[u], pr[u]),
                                        __fmul_rn(a[u], pi[u]));
          dv[u] = atan2_poly(cross, dotp);
        }
        sts<CW>(dd + j, dv);
        if (tail) {
          sts<CW>(halo_out_r + o + j, a);
          sts<CW>(halo_out_i + o + j, b);
        }
      }
    }
  }

  // The carried d rows (the tile before's last Ta - 1 frames) to the front.
  __device__ __forceinline__ void shift_d() {
    constexpr int cpt = K / CW;
    for (int e = threadIdx.x; e < (s.Ta - 1) * cpt; e += kThreads) {
      const int q = e / cpt;
      const int c = (e - q * cpt) * CW;
      float v[CW];
      lds<CW>(s_d + (T + q) * Kd + c, v);
      sts<CW>(s_d + q * Kd + c, v);
    }
  }

  // a[tile*A + t, c] for t < A, CW channels a thread.
  __device__ __forceinline__ void fir(int tile, float* __restrict__ audio) {
    constexpr int cpt = K / CW;
    for (int it = threadIdx.x; it < s.A * cpt; it += kThreads) {
      const int t = it / cpt;
      const int cg = it - t * cpt;
      const float* dp = s_d + (s.Ta - 1 + t * s.dec) * Kd + cg * CW;
      float acc[CW];
#pragma unroll
      for (int j = 0; j < CW; ++j) acc[j] = 0.f;
      int m = 0;
      for (; m + 4 <= s.Ta; m += 4) {
        float hm[4], dv[4][CW];
        lds<4>(s_h + m, hm);
        const float* q = dp - m * Kd;
#pragma unroll
        for (int u = 0; u < 4; ++u) lds<CW>(q - u * Kd, dv[u]);
#pragma unroll
        for (int u = 0; u < 4; ++u) {
#pragma unroll
          for (int j = 0; j < CW; ++j) acc[j] = fmaf(hm[u], dv[u][j], acc[j]);
        }
      }
      for (; m < s.Ta; ++m) {
        float dv[CW];
        lds<CW>(dp - m * Kd, dv);
        const float hm = s_h[m];
#pragma unroll
        for (int j = 0; j < CW; ++j) acc[j] = fmaf(hm, dv[j], acc[j]);
      }
      float* out = audio + static_cast<int64_t>(cg * CW) * s.n_audio +
                   static_cast<int64_t>(tile) * s.A + t;
#pragma unroll
      for (int j = 0; j < CW; ++j) out[j * s.n_audio] = acc[j];
    }
  }
};

// Block b walks tiles b*run .. min((b+1)*run, tiles) - 1: first the Ta
// frames before its first tile (their Y, then their d), then per tile the
// spectrum, the demod and the audio FIR.  For K <= 16 the next tile's
// window is copied during the demod and the FIR, above during the FIR.
template <int K>
__global__ void __launch_bounds__(kThreads, 2)
band_monitor_kernel(const float* __restrict__ re,
                    const float* __restrict__ im,
                    const float* __restrict__ ctx_re,
                    const float* __restrict__ ctx_im,
                    const float* __restrict__ halo_r,
                    const float* __restrict__ halo_i,
                    const float* __restrict__ C,
                    const float* __restrict__ h, const Shape s,
                    const __grid_constant__ Consts<K> cst,
                    float* __restrict__ audio,
                    float* __restrict__ halo_out_r,
                    float* __restrict__ halo_out_i,
                    float* __restrict__ ctx_out_r,
                    float* __restrict__ ctx_out_i) {
  using B = Block<K>;
  constexpr int T = B::T, G = B::G, P = B::P, Ky = B::Ky;
  extern __shared__ float4 smem4[];
  float* const smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout<K>(s);
  const int tid = threadIdx.x;
  const int rows = T + s.M - 1;
  B blk{s, cst, smem, smem + L.d, P == 1 ? smem + L.y : smem,
        smem + L.prev, smem + L.h, smem + L.C,
        reinterpret_cast<float2*>(smem + L.rt), rows,
        P == 1 ? T * Ky : rows * Ky, P == 1 ? 0 : tid / T,
        P == 1 ? tid : tid % T, 0};
  blk.c0 = blk.g * G;
  const int t_begin = static_cast<int>(blockIdx.x) * s.run;
  const int t_end = min(t_begin + s.run, s.tiles);

  for (int i = tid; i < s.Ta; i += kThreads) blk.s_h[i] = h[i];
  if constexpr (P > 1) {
    for (int i = tid; i < s.M * K; i += kThreads) blk.s_C[i] = C[i];
    for (int i = tid; i < K * K; i += kThreads) {
      const int gg = i / (K * 16), c = (i / 16) % K, j = i % 16;
      blk.s_rt[i] = cst.root[((c + 1) * (gg * 16 + j)) % K];
    }
  }

  // The Ta frames before the run: Y (computed, or the carried tail at the
  // start of the call), then d of all but the first of them.
  const int lo = T - s.Ta;
  int p = 0;
  if (t_begin > 0) {
    load_window<K>(blk.win, re, im, ctx_re, ctx_im, s, t_begin - 1);
    cp_async_wait();
    __syncthreads();
    blk.spectrum(p, lo);
  } else {
    blk.carried(p, lo, halo_r, halo_i);
  }
  __syncthreads();                      // Y in (and the window read)
  if constexpr (P == 1) {
    load_window<K>(blk.win, re, im, ctx_re, ctx_im, s, t_begin);
  }
  blk.demod(p, lo + 1, s.Ta - 1 - T, false, halo_out_r, halo_out_i);
  if constexpr (P > 1) {
    __syncthreads();                    // the rows read
    load_window<K>(blk.win, re, im, ctx_re, ctx_im, s, t_begin);
  }

  for (int tile = t_begin; tile < t_end; ++tile) {
    p ^= 1;
    cp_async_wait();
    __syncthreads();                    // window in, the last FIR done
    if (tile > t_begin) blk.shift_d();
    blk.fence_index();
    blk.spectrum(p, 0);
    __syncthreads();                    // Y in (and the window read)
    const bool next = tile + 1 < t_end;
    if constexpr (P == 1) {
      if (next) load_window<K>(blk.win, re, im, ctx_re, ctx_im, s, tile + 1);
    }
    blk.fence_index();
    blk.demod(p, 0, s.Ta - 1, tile == s.tiles - 1, halo_out_r, halo_out_i);
    __syncthreads();                    // d in (and the rows read)
    if constexpr (P > 1) {
      if (next) load_window<K>(blk.win, re, im, ctx_re, ctx_im, s, tile + 1);
    }
    blk.fir(tile, audio);
  }
  if (t_end == s.tiles) {
    const int64_t n = s.n_frames * K;
    for (int i = tid; i < s.ctx_len; i += kThreads) {
      ctx_out_r[i] = re[n - s.ctx_len + i];
      ctx_out_i[i] = im[n - s.ctx_len + i];
    }
  }
}

// The largest dynamic shared memory set per device for each K (the
// attribute is set only when a call needs more: setting it on every call
// costs host time on the served path).
template <int K>
int launch(const float* re, const float* im, const float* ctx_re,
           const float* ctx_im, const float* halo_r, const float* halo_i,
           const float* C_host, const float* roots_host, const float* C_dev,
           const float* h, Shape s, float* audio, float* halo_out_r,
           float* halo_out_i, float* ctx_out_r, float* ctx_out_i,
           cudaStream_t stream) {
  using Gm = Geo<K>;
  if (s.dec < 1 || Gm::T % s.dec != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  s.A = Gm::T / s.dec;
  if (s.M < 1 || s.M > 16 || s.Ta < 1 || s.hframes < s.Ta ||
      s.hframes > Gm::T || s.Ta > Gm::T || s.M * K - 1 > s.ctx_len ||
      s.n_frames <= 0 || s.n_frames % Gm::T != 0 ||
      s.hframes > s.n_frames || s.ctx_len > s.n_frames * K || s.run < 1 ||
      (Gm::P > 1 && C_dev == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (s.n_frames / Gm::T > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  s.n_audio = s.n_frames / s.dec;
  s.tiles = static_cast<int>(s.n_frames / Gm::T);
  s.aligned = ((reinterpret_cast<uintptr_t>(re) |
                reinterpret_cast<uintptr_t>(im)) &
               (4 * Gm::kCopy - 1)) == 0;
  Consts<K> cst;
  for (int i = 0; i < K; ++i) {
    cst.root[i] = make_float2(roots_host[2 * i], roots_host[2 * i + 1]);
  }
  if constexpr (Gm::P == 1) {
    for (int i = 0; i < 16 * K; ++i) {
      cst.C[i] = i < s.M * K ? C_host[i] : 0.f;
    }
  } else {
    cst.C[0] = 0.f;
  }
  const int smem = static_cast<int>(sizeof(float)) * layout<K>(s).total;
  static int set_bytes[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > set_bytes[dev]) {
    err = cudaFuncSetAttribute(band_monitor_kernel<K>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    set_bytes[dev] = smem;
  }
  const dim3 grid(static_cast<unsigned>((s.tiles + s.run - 1) / s.run));
  band_monitor_kernel<K><<<grid, kThreads, smem, stream>>>(
      re, im, ctx_re, ctx_im, halo_r, halo_i, C_dev, h, s, cst, audio,
      halo_out_r, halo_out_i, ctx_out_r, ctx_out_i);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  Device pointers on the current device: re/im [N],
// ctx [ctx_len] (only the trailing M*K - 1 samples are read), halo
// [hframes][K] (carried spectrum tail), h [Ta] audio taps, C_dev [M][K]
// (read only for K > 16, may be null below); host pointers: C [M][K] and
// roots [K] (re, im) float32 pairs, copied into the launch's parameters.
// Outputs audio [K][N/K/dec] (channel-major), halo_out [hframes][K] and
// ctx_out [ctx_len].  K divides 128, M <= 16, dec divides 4096/K, N/K a
// multiple of 4096/K, Ta <= hframes <= 4096/K; each block walks `run`
// consecutive tiles of 4096/K frames.  One launch on `stream`, without
// synchronising; returns cudaGetLastError() (or the error that stopped
// the launch).
extern "C" int band_monitor_launch(
    const void* re, const void* im, const void* ctx_re, const void* ctx_im,
    int ctx_len, const void* halo_r, const void* halo_i, int hframes,
    const void* C, const void* roots, const void* C_dev, int K, int M,
    const void* h, int Ta, int dec, int64_t n_frames, int run, void* audio,
    void* halo_out_r, void* halo_out_i, void* ctx_out_r, void* ctx_out_i,
    void* stream) {
  Shape s{M, dec, Ta, 0, hframes, ctx_len, run, 0, 0, n_frames, 0};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto o = [](void* p) { return static_cast<float*>(p); };
#define COMMS_BM_CASE(KK)                                                    \
  case KK:                                                                   \
    return launch<KK>(f(re), f(im), f(ctx_re), f(ctx_im), f(halo_r),         \
                      f(halo_i), f(C), f(roots), f(C_dev), f(h), s,          \
                      o(audio), o(halo_out_r), o(halo_out_i), o(ctx_out_r),  \
                      o(ctx_out_i), st);
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
