// Decimating FIR on float32 re/im planes, for Hopper (sm_90a).
//
//   y[f] = sum_{t < MD} taps[t] * x[f*D - t]        (real or complex taps)
//
// with the taps zero-padded to MD = D*ceil(T/D), as
// comms_tpu_torch/ops/fir.py::decimating_branch_taps pads them, x[n < 0]
// read from the carried context, ctx[ctx_len + n], and x[n >= N] = 0.  One
// kernel serves three TPU kernels' entries: comms_tpu/kernels/
// decim_fir_pallas.py::fir_decimate_planar_pallas (context one row of
// D*128 samples, a batch of [B, N] rows) and comms_tpu/kernels/
// poly_fir_pallas.py::poly_fir_pallas_planar (context 8*D*128 samples,
// taps up to D*128 + 1), both through comms_tpu_torch/kernels/
// decim_fir.py, and comms_tpu/kernels/fir_pallas.py::fir_planar_pallas
// (:253), the dense streaming FIR, through comms_tpu_torch/kernels/fir.py
// at D = 1 (MD = T up to 1025, context 1024 samples).
//
// Bound on the H100: per input sample it reads 8 bytes and writes 8/D;
// it does MD/D FMAs per plane and output (4 per output and tap with
// complex taps).  The band monitor's audio FIR (8 x 1,048,576 samples,
// D = 4, 32 taps) is bound by its bytes (0.025 ms); the K3 entry at 641
// taps (16,752,640 samples, D = 5) by its FMAs (0.129 ms at 67 TFLOP/s).
// The dense FIR (D = 1) moves 16 bytes a sample and does 2T (real taps)
// or 4T (complex) FMAs a sample: at the QPSK matched filter's 32 real
// taps over 33,554,432 samples its bytes bound it (0.160 ms at 3.35
// TB/s), at 257 complex taps its FMAs (1.030 ms at 67 TFLOP/s).
// Design:
// - persistent blocks (kernels/decim_fir.partition, passed in): T
//   threads (128, or 64 for small calls), block b walking tiles b,
//   b + B, ... of S = R*T consecutive outputs of one row (the rows' tiles
//   numbered one after the other; a row's last tile may be partial);
// - a tile's window is its S + M groups of D samples a plane (M = MD/D;
//   group j holds samples (f0 - M + j)*D .. + D-1), stored from shared
//   float a0 = (-MD) mod 4 on, so that 4-sample quads in shared memory
//   are 16-byte quads of the planes, and copied with 16-byte cp.async.
//   Only a row's first tile reads the context and only its last reaches
//   past N: the copy decides both once a tile (the quads wholly inside
//   the row are cp.async, the others built sample by sample); planes
//   that are not 16-byte aligned are read sample by sample throughout;
// - kStages = 2 window buffers a block: the next window is copied while
//   the block computes the current one.  (With one buffer the kernel
//   copies the next window once the block has read the current one,
//   while the SM's other blocks compute: more blocks fit an SM, and it
//   ran as fast, tools/k2_compare.py's variant stages1.)
// - register-blocked polyphase sums: a thread computes R consecutive
//   outputs a .. a + R-1 of the tile.  With t = qD + p, output a + r reads
//   element 0 of window group a + r + M - q at p = 0 and element D - p of
//   group a + r + M - 1 - q at p > 0.  So the thread holds a ring of R + 1
//   groups a plane in registers; each step of q loads one new group a
//   plane and the D taps of the step (broadcast), for R*D FMAs a plane
//   (twice that with complex taps).  The steps are unrolled by the ring's
//   length, so each ring slot is a constant register, and whole rounds of
//   the ring run without a branch;
// - R by D (kROfD, odd): a warp's lanes then load groups R*D floats
//   apart, which is free of bank conflicts for scalar (D odd), float2
//   (D = 2, 6) and float4 (D = 4) loads; at D = 8 (two float4 a group,
//   lanes 6 quads apart) quad k lies at shared quad k ^ ((k >> 3) & 1)
//   (tests/_k2_replay.py checks every D's loads and copies).  R = 9 at
//   D = 1, the dense FIR: long complex filters there are issue-bound,
//   and 9 beat 7 by 7% at 257 complex taps, level at 32 real taps
//   (tools/k4_compare.py);
// - D above 8 takes one instantiation with D at run time: one output a
//   thread, each product read from the window (no ring);
// - outputs go through a per-warp shared row and leave as float4 stores;
//   the launch also writes the next call's context (each row's last
//   ctx_len samples), which the wrappers returned as copies before;
// - each output is one FMA chain over t = 0..MD-1 in ascending order (with
//   complex taps ar += hr*xr, ar += -hi*xi, ai += hr*xi, ai += hi*xr per
//   tap), as in the first (one output a thread) form of this kernel and
//   in the dense FIR's first kernel (a block of 1024 outputs, 4 a
//   thread, sliding in registers), so the output is bit-identical to
//   both, and chopping a stream anywhere reproduces the one-shot output
//   bit for bit.
// The TPU kernels' wide-row layout, 8-row halo alignment and bf16x3
// split products are not carried over; complex taps are a plain complex
// MAC.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreadsMax = 128;      // threads a block, at most
constexpr int kStages = 2;            // window buffers a block
constexpr int kDMax = 8;              // largest D with its own instantiation
// Outputs a thread by D; entry 0 is the run-time-D path (D > kDMax).
constexpr int kROfD[kDMax + 1] = {1, 9, 7, 5, 5, 7, 3, 3, 3};
constexpr int kMaxIn = 1 << 30;       // samples a row, at most

// Taps of one step of q in shared memory: D padded to whole vector loads.
__host__ __device__ constexpr int tap_stride(int D) {
  return D <= 2 ? D : (D + 3) / 4 * 4;
}

struct FirShape {
  int n_in;         // samples a row
  int n_out;        // n_in / D
  int D, M, MD;
  int ctx_len;      // context samples a row
  int S;            // outputs a tile (R * threads)
  int tpr;          // tiles a row
  int tiles;        // rows * tpr
  int a0;           // (-MD) mod 4: shared float of window sample 0
  int nq;           // 16-byte quads of a window plane
  int wq;           // quads of a window plane in shared memory (even)
  int dp;           // tap_stride(D) (D on the run-time-D path)
  int aligned_in;   // planes 16-byte aligned and n_in % 4 == 0
  int aligned_out;  // outputs 16-byte aligned and n_out % 4 == 0
  int rows;
};

__host__ __device__ inline int window_quads(int D, int M, int S, int a0) {
  return (a0 + (S + M) * D + 3) / 4;
}

// Shared quad of window quad k: at D = 8 bit 3 flips bit 0.
template <bool kSwz>
__device__ __forceinline__ int swz(int k) {
  return kSwz ? k ^ ((k >> 3) & 1) : k;
}

__device__ __forceinline__ void cp_async16(float4* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

// The window of `tile` into buffer w (re quads at w, im at w + s.wq):
// plane samples w0 + 4k .. w0 + 4k + 3 into shared quad swz(k), k < s.nq,
// w0 = (f0 - M)*D - a0, as one cp.async group of each thread.  Samples
// below 0 come from the context (zeros below it), samples at or past
// n_in are zero.
template <bool kSwz>
__device__ __forceinline__ void load_window(
    float4* w, const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ ctx_r, const float* __restrict__ ctx_i,
    const FirShape& s, int tile) {
  const int T = blockDim.x;
  const int row = tile / s.tpr;
  const int f0 = (tile - row * s.tpr) * s.S;
  const int64_t off = static_cast<int64_t>(row) * s.n_in;
  const float* const pr = xr + off;
  const float* const pi = xi + off;
  const int w0 = (f0 - s.M) * s.D - s.a0;            // a multiple of 4
  int k_lo = w0 < 0 ? min(-w0 / 4, s.nq) : 0;
  int k_hi = s.aligned_in ? min((s.n_in - w0) / 4, s.nq) : k_lo;
  k_hi = max(k_hi, k_lo);
#pragma unroll 1
  for (int k = k_lo + static_cast<int>(threadIdx.x); k < k_hi; k += T) {
    cp_async16(w + swz<kSwz>(k), pr + w0 + 4 * k);
    cp_async16(w + s.wq + swz<kSwz>(k), pi + w0 + 4 * k);
  }
  // the quads below k_lo (a row's first tile) and from k_hi on (its last
  // tile, or every quad of planes that are not aligned), sample by sample
  const float* const qr = ctx_r + static_cast<int64_t>(row) * s.ctx_len;
  const float* const qi = ctx_i + static_cast<int64_t>(row) * s.ctx_len;
  auto edge = [&](int k) {
    float vr[4], vi[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int n = w0 + 4 * k + e;
      vr[e] = vi[e] = 0.f;
      if (n < 0) {
        const int c = s.ctx_len + n;
        if (c >= 0) {
          vr[e] = qr[c];
          vi[e] = qi[c];
        }
      } else if (n < s.n_in) {
        vr[e] = pr[n];
        vi[e] = pi[n];
      }
    }
    w[swz<kSwz>(k)] = make_float4(vr[0], vr[1], vr[2], vr[3]);
    w[s.wq + swz<kSwz>(k)] = make_float4(vi[0], vi[1], vi[2], vi[3]);
  };
#pragma unroll 1
  for (int k = threadIdx.x; k < k_lo; k += T) edge(k);
#pragma unroll 1
  for (int k = k_hi + static_cast<int>(threadIdx.x); k < s.nq; k += T) {
    edge(k);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// The D samples of the window group at shared float i into g.
template <int D, bool kSwz>
__device__ __forceinline__ void load_group(const float* __restrict__ base,
                                           int i, float (&g)[D]) {
  if constexpr (D % 4 == 0) {
    const float4* b4 = reinterpret_cast<const float4*>(base);
#pragma unroll
    for (int k = 0; k < D / 4; ++k) {
      const float4 v = b4[swz<kSwz>((i >> 2) + k)];
      g[4 * k] = v.x;
      g[4 * k + 1] = v.y;
      g[4 * k + 2] = v.z;
      g[4 * k + 3] = v.w;
    }
  } else if constexpr (D % 2 == 0) {
    const float2* b2 = reinterpret_cast<const float2*>(base);
#pragma unroll
    for (int k = 0; k < D / 2; ++k) {
      const float2 v = b2[(i >> 1) + k];
      g[2 * k] = v.x;
      g[2 * k + 1] = v.y;
    }
  } else {
#pragma unroll
    for (int k = 0; k < D; ++k) g[k] = base[i + k];
  }
}

// The DP taps of one step (a broadcast load).
template <int DP>
__device__ __forceinline__ void load_taps(const float* __restrict__ h,
                                          float (&v)[DP]) {
  if constexpr (DP % 4 == 0) {
#pragma unroll
    for (int k = 0; k < DP / 4; ++k) {
      const float4 q = reinterpret_cast<const float4*>(h)[k];
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
  } else if constexpr (DP == 2) {
    const float2 q = *reinterpret_cast<const float2*>(h);
    v[0] = q.x;
    v[1] = q.y;
  } else {
    v[0] = h[0];
  }
}

// One product of the chain in the first kernel's order.
template <bool kCplx>
__device__ __forceinline__ void mac(float hr, float hi, float xr, float xi,
                                    float& ar, float& ai) {
  if (kCplx) {
    ar = fmaf(hr, xr, ar);
    ar = fmaf(-hi, xi, ar);
    ai = fmaf(hr, xi, ai);
    ai = fmaf(hi, xr, ai);
  } else {
    ar = fmaf(hr, xr, ar);
    ai = fmaf(hr, xi, ai);
  }
}

// One step of q (K = q mod (R + 1)): ring slot (u - q) mod (R + 1) holds
// window group a + M - 1 - q + u (u = 0..R); the step loads u = 0 (shared
// float g) into slot (-q) mod (R + 1), then output r takes element 0 of
// u = r + 1 (t = qD) and elements D-1 .. 1 of u = r (t = qD + 1 ..).
template <int D, int R, bool kCplx, bool kSwz, int K>
__device__ __forceinline__ void fir_step(
    const float* __restrict__ cr, const float* __restrict__ ci, int g,
    const float* __restrict__ hr_s, const float* __restrict__ hi_s,
    float (&xr)[R + 1][D], float (&xi)[R + 1][D], float (&ar)[R],
    float (&ai)[R]) {
  constexpr int kRing = R + 1;
  constexpr int DP = tap_stride(D);
  constexpr int s0 = (kRing - K) % kRing;
  load_group<D, kSwz>(cr, g, xr[s0]);
  load_group<D, kSwz>(ci, g, xi[s0]);
  float hr[DP], hi[DP];
  load_taps<DP>(hr_s, hr);
  if (kCplx) {
    load_taps<DP>(hi_s, hi);
  } else {
#pragma unroll
    for (int p = 0; p < DP; ++p) hi[p] = 0.f;
  }
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int u1 = (r + 1 + kRing - K) % kRing;
    const int u0 = (r + kRing - K) % kRing;
    mac<kCplx>(hr[0], hi[0], xr[u1][0], xi[u1][0], ar[r], ai[r]);
#pragma unroll
    for (int p = 1; p < D; ++p) {
      mac<kCplx>(hr[p], hi[p], xr[u0][D - p], xi[u0][D - p], ar[r], ai[r]);
    }
  }
}

// Steps q + K, q + K + 1, ... of a chunk of R + 1 steps (q a multiple of
// R + 1), up to M (`left` = M - q).  A full chunk (kFull) runs all R + 1
// steps without a branch, so its loads can be issued ahead of the FMAs of
// the steps before them.
template <int D, int R, bool kCplx, bool kSwz, bool kFull, int K>
__device__ __forceinline__ void fir_chunk(
    const float* __restrict__ cr, const float* __restrict__ ci, int g,
    const float* __restrict__ hr_s, const float* __restrict__ hi_s,
    int left, float (&xr)[R + 1][D], float (&xi)[R + 1][D], float (&ar)[R],
    float (&ai)[R]) {
  constexpr int DP = tap_stride(D);
  fir_step<D, R, kCplx, kSwz, K>(cr, ci, g - K * D, hr_s + K * DP,
                                 hi_s + K * DP, xr, xi, ar, ai);
  if constexpr (K < R) {
    if (kFull || K + 1 < left) {
      fir_chunk<D, R, kCplx, kSwz, kFull, K + 1>(cr, ci, g, hr_s, hi_s,
                                                 left, xr, xi, ar, ai);
    }
  }
}

// A tile's R outputs a thread from the window planes cr, ci.
template <int kD, bool kCplx>
__device__ __forceinline__ void tile_sums(
    const float* __restrict__ cr, const float* __restrict__ ci,
    const float* __restrict__ s_hr, const float* __restrict__ s_hi,
    const FirShape& s, float (&ar)[kROfD[kD]], float (&ai)[kROfD[kD]]) {
  constexpr int R = kROfD[kD];
  if constexpr (kD == 0) {
    // run-time D: output a reads shared float a0 + (a + M)*D - t
    const int b = s.a0 + (static_cast<int>(threadIdx.x) + s.M) * s.D;
    const float* br = cr + b;
    const float* bi = ci + b;
    ar[0] = ai[0] = 0.f;
#pragma unroll 4
    for (int t = 0; t < s.MD; ++t) {
      mac<kCplx>(s_hr[t], kCplx ? s_hi[t] : 0.f, br[-t], bi[-t], ar[0],
                 ai[0]);
    }
  } else {
    constexpr bool kSwz = kD % 8 == 0;
    constexpr int DP = tap_stride(kD);
#pragma unroll
    for (int r = 0; r < R; ++r) ar[r] = ai[r] = 0.f;
    float xr[R + 1][kD], xi[R + 1][kD];
    const int j0 = R * static_cast<int>(threadIdx.x) + s.M - 1;
#pragma unroll
    for (int u = 1; u <= R; ++u) {
      load_group<kD, kSwz>(cr, s.a0 + (j0 + u) * kD, xr[u]);
      load_group<kD, kSwz>(ci, s.a0 + (j0 + u) * kD, xi[u]);
    }
    int q = 0;
#pragma unroll 1
    for (; q + R + 1 <= s.M; q += R + 1) {
      fir_chunk<kD, R, kCplx, kSwz, true, 0>(cr, ci, s.a0 + (j0 - q) * kD,
                                             s_hr + q * DP, s_hi + q * DP,
                                             R + 1, xr, xi, ar, ai);
    }
    if (q < s.M) {
      fir_chunk<kD, R, kCplx, kSwz, false, 0>(cr, ci, s.a0 + (j0 - q) * kD,
                                              s_hr + q * DP, s_hi + q * DP,
                                              s.M - q, xr, xi, ar, ai);
    }
  }
}

template <int kD, bool kCplx>
__global__ void __launch_bounds__(kThreadsMax, 4) decim_fir_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ ctx_r, const float* __restrict__ ctx_i,
    const float* __restrict__ taps_r, const float* __restrict__ taps_i,
    const FirShape s, float* __restrict__ yr, float* __restrict__ yi,
    float* __restrict__ nctx_r, float* __restrict__ nctx_i) {
  constexpr int R = kROfD[kD];
  constexpr bool kSwz = kD != 0 && kD % 8 == 0;
  extern __shared__ float4 smem[];
  float4* const s_win = smem;                                // [stages][2][wq]
  float* const s_out = reinterpret_cast<float*>(smem + kStages * 2 * s.wq);
  float* const s_hr = s_out + 2 * s.S;                       // [M * dp]
  float* const s_hi = s_hr + s.M * s.dp;                     // complex taps
  const int T = blockDim.x;
  const int stride = static_cast<int>(gridDim.x);
  // the first windows are in flight while the taps are read (one
  // cp.async group a tile, an empty one past the last)
  constexpr int kAhead = kStages > 1 ? kStages - 1 : 0;   // tiles ahead
#pragma unroll
  for (int k = 0; k < (kAhead > 0 ? kAhead : 1); ++k) {
    const int tile = static_cast<int>(blockIdx.x) + k * stride;
    if (tile < s.tiles) {
      load_window<kSwz>(s_win + 2 * s.wq * k, xr, xi, ctx_r, ctx_i, s,
                        tile);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
  }
  // taps[q*D + p] at shared [q*dp + p], zeros in the padding
  for (int i = threadIdx.x; i < s.M * s.dp; i += T) {
    const int q = i / s.dp, p = i - q * s.dp;
    s_hr[i] = p < s.D ? taps_r[q * s.D + p] : 0.f;
    if (kCplx) s_hi[i] = p < s.D ? taps_i[q * s.D + p] : 0.f;
  }
  // the next call's context, each row's last ctx_len samples, spread
  // over all the blocks' threads (most copy one sample or none)
  if (nctx_r != nullptr) {
    const int64_t total = static_cast<int64_t>(s.rows) * s.ctx_len;
    for (int64_t e = static_cast<int64_t>(blockIdx.x) * T + threadIdx.x;
         e < total; e += static_cast<int64_t>(stride) * T) {
      const int64_t row = e / s.ctx_len;
      const int64_t src = row * s.n_in + s.n_in - s.ctx_len +
                          (e - row * s.ctx_len);
      nctx_r[e] = xr[src];
      nctx_i[e] = xi[src];
    }
  }
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  float* const o_r = s_out + warp * 32 * R;        // this warp's outputs
  float* const o_i = o_r + s.S;

  for (int tile = blockIdx.x, it = 0; tile < s.tiles; tile += stride, ++it) {
    const float4* const cur = s_win + 2 * s.wq * (it % kStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kAhead > 0 ? kAhead - 1
                                                             : 0)
                 : "memory");
    __syncthreads();                  // window in; the last tile done
    if constexpr (kAhead > 0) {
      const int ahead = tile + kAhead * stride;
      if (ahead < s.tiles) {
        load_window<kSwz>(s_win + 2 * s.wq * ((it + kAhead) % kStages),
                          xr, xi, ctx_r, ctx_i, s, ahead);
      } else {
        asm volatile("cp.async.commit_group;\n" ::);
      }
    }

    float ar[R], ai[R];
    tile_sums<kD, kCplx>(reinterpret_cast<const float*>(cur),
                         reinterpret_cast<const float*>(cur + s.wq), s_hr,
                         s_hi, s, ar, ai);

    // through the warp's shared row to float4 stores
#pragma unroll
    for (int r = 0; r < R; ++r) {
      o_r[lane * R + r] = ar[r];
      o_i[lane * R + r] = ai[r];
    }
    __syncwarp();
    const int row = tile / s.tpr;
    const int fw = (tile - row * s.tpr) * s.S + warp * 32 * R;
    float* const pr = yr + static_cast<int64_t>(row) * s.n_out;
    float* const pi = yi + static_cast<int64_t>(row) * s.n_out;
#pragma unroll
    for (int k = lane; k < 8 * R; k += 32) {
      const int f = fw + 4 * k;
      const float4 vr = reinterpret_cast<const float4*>(o_r)[k];
      const float4 vi = reinterpret_cast<const float4*>(o_i)[k];
      if (s.aligned_out && f + 4 <= s.n_out) {
        *reinterpret_cast<float4*>(pr + f) = vr;
        *reinterpret_cast<float4*>(pi + f) = vi;
      } else {
        const float er[4] = {vr.x, vr.y, vr.z, vr.w};
        const float ei[4] = {vi.x, vi.y, vi.z, vi.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          if (f + e < s.n_out) {
            pr[f + e] = er[e];
            pi[f + e] = ei[e];
          }
        }
      }
    }
    if constexpr (kAhead == 0) {      // one buffer: the next window now
      __syncthreads();
      if (tile + stride < s.tiles) {
        load_window<kSwz>(s_win, xr, xi, ctx_r, ctx_i, s, tile + stride);
      }
    }
  }
}

int outputs_per_thread(int D) { return D <= kDMax ? kROfD[D] : kROfD[0]; }

FirShape shape_of(int MD, int D, int ctx_len, int64_t n_in, int rows,
                  int threads) {
  FirShape s;
  s.n_in = static_cast<int>(n_in);
  s.n_out = s.n_in / D;
  s.D = D;
  s.M = MD / D;
  s.MD = MD;
  s.ctx_len = ctx_len;
  s.S = outputs_per_thread(D) * threads;
  s.tpr = (s.n_out + s.S - 1) / s.S;
  s.tiles = rows * s.tpr;
  s.a0 = (4 - MD % 4) % 4;
  s.nq = window_quads(D, s.M, s.S, s.a0);
  s.wq = (s.nq + 1) / 2 * 2;
  s.dp = D <= kDMax ? tap_stride(D) : D;
  s.aligned_in = 0;
  s.aligned_out = 0;
  s.rows = rows;
  return s;
}

template <int kD, bool kCplx>
cudaError_t launch(const float* xr, const float* xi, const float* ctx_r,
                   const float* ctx_i, const float* taps_r,
                   const float* taps_i, const FirShape& s, int blocks,
                   int threads, int64_t smem, float* yr, float* yi,
                   float* nctx_r, float* nctx_i, cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      decim_fir_kernel<kD, kCplx>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  decim_fir_kernel<kD, kCplx><<<blocks, threads, smem, stream>>>(
      xr, xi, ctx_r, ctx_i, taps_r, taps_i, s, yr, yi, nctx_r, nctx_i);
  return cudaGetLastError();
}

template <bool kCplx>
cudaError_t dispatch(int D, const float* xr, const float* xi,
                     const float* ctx_r, const float* ctx_i,
                     const float* taps_r, const float* taps_i,
                     const FirShape& s, int blocks, int threads, int64_t smem,
                     float* yr, float* yi, float* nr, float* ni,
                     cudaStream_t st) {
#define DECIM_FIR_CASE(d)                                                  \
  case d:                                                                  \
    return launch<d, kCplx>(xr, xi, ctx_r, ctx_i, taps_r, taps_i, s,       \
                            blocks, threads, smem, yr, yi, nr, ni, st);
  switch (D) {
    DECIM_FIR_CASE(1)
    DECIM_FIR_CASE(2)
    DECIM_FIR_CASE(3)
    DECIM_FIR_CASE(4)
    DECIM_FIR_CASE(5)
    DECIM_FIR_CASE(6)
    DECIM_FIR_CASE(7)
    DECIM_FIR_CASE(8)
    default:
      return launch<0, kCplx>(xr, xi, ctx_r, ctx_i, taps_r, taps_i, s,
                              blocks, threads, smem, yr, yi, nr, ni, st);
  }
#undef DECIM_FIR_CASE
}

}  // namespace

// Dynamic shared memory of one launch, in bytes: kStages window buffers
// of two planes, the warps' output rows and the taps (the wrapper picks
// the threads so that it fits the card's 227 KB).
extern "C" int64_t decim_fir_smem_bytes(int MD, int D, int threads,
                                        int complex_taps) {
  if (D < 1 || MD < D || threads < 32) return -1;
  const FirShape s = shape_of(MD, D, 0, 0, 1, threads);
  return static_cast<int64_t>(sizeof(float)) *
         (static_cast<int64_t>(kStages) * 2 * 4 * s.wq + 2 * s.S +
          static_cast<int64_t>(s.M) * s.dp * (complex_taps ? 2 : 1));
}

// C entry for ctypes.  Pointers on the current device: xr/xi [rows][n_in],
// ctx_r/ctx_i [rows][ctx_len] (only the trailing MD - 1 samples are read),
// taps_r (and taps_i when complex) [MD], yr/yi [rows][n_in / D] and,
// unless null, nctx_r/nctx_i [rows][ctx_len]: each row's last ctx_len
// samples (the next call's context; ctx_len <= n_in).  The
// partition (kernels/decim_fir.partition): `threads` a block (a multiple
// of 32 up to 128), `blocks` persistent blocks.  Launches on `stream`
// without synchronising; returns cudaGetLastError() (or the error that
// stopped the launch).
extern "C" int decim_fir_launch(const void* xr, const void* xi,
                                const void* ctx_r, const void* ctx_i,
                                int ctx_len, const void* taps_r,
                                const void* taps_i, int MD, int D,
                                int complex_taps, int64_t n_in, int rows,
                                int threads, int blocks, void* yr, void* yi,
                                void* nctx_r, void* nctx_i, void* stream) {
  if (D < 1 || MD < D || MD % D != 0 || MD - 1 > ctx_len || n_in <= 0 ||
      (nctx_r != nullptr && ctx_len > n_in) ||
      n_in > kMaxIn || n_in % D != 0 || rows < 1 || threads < 32 ||
      threads > kThreadsMax || threads % 32 != 0 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  FirShape s = shape_of(MD, D, ctx_len, n_in, rows, threads);
  if (static_cast<int64_t>(rows) * s.tpr > INT32_MAX / 2) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto a16 = [](const void* p) {
    return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
  };
  s.aligned_in = a16(xr) && a16(xi) && n_in % 4 == 0;
  s.aligned_out = a16(yr) && a16(yi) && s.n_out % 4 == 0;
  const int64_t smem = decim_fir_smem_bytes(MD, D, threads, complex_taps);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* pxr = static_cast<const float*>(xr);
  const float* pxi = static_cast<const float*>(xi);
  const float* pcr = static_cast<const float*>(ctx_r);
  const float* pci = static_cast<const float*>(ctx_i);
  const float* phr = static_cast<const float*>(taps_r);
  const float* phi = static_cast<const float*>(taps_i);
  float* pyr = static_cast<float*>(yr);
  float* pyi = static_cast<float*>(yi);
  float* pnr = static_cast<float*>(nctx_r);
  float* pni = static_cast<float*>(nctx_i);
  const cudaError_t err =
      complex_taps
          ? dispatch<true>(D, pxr, pxi, pcr, pci, phr, phi, s, blocks,
                           threads, smem, pyr, pyi, pnr, pni, st)
          : dispatch<false>(D, pxr, pxi, pcr, pci, phr, nullptr, s, blocks,
                            threads, smem, pyr, pyi, pnr, pni, st);
  return static_cast<int>(err);
}
