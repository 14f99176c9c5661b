// The QPSK receiver's symbol path and correlation panels, for Hopper
// (sm_90a).  Replaces the TPU kernel comms_tpu/kernels/qpsk_sym_pallas.py
// (qpsk_symbol_gemm, qpsk_symbol_gemm_scalars and qpsk_panels);
// comms_tpu_torch/kernels/qpsk_sym.py holds the wrappers and the plain
// versions.
//
// Symbols (qpsk_sym_kernel):
//
//   y[s] = e^{-j ang(s)} * sum_{t < MD} (fr + j fi)[t] * (xr + j xi)[4(s+1) - t]
//
// with x[n < 0] from the carried context (MD - 1 samples; zeros without
// one) and x[n >= N] = 0.  The de-rotation angle uses the TPU kernel's
// float32 decomposition, with s = g*65536 + row*128 + lane:
//   wsm = mod(ws, 2pi), w128 = mod(wsm*128, 2pi),
//   base_g = mod(phase0 + wsm + (w128*512)*g, 2pi),
//   ang = (base_g + w128*row) + wsm*lane,
// each partial product below ~2.5e3 rad, so the angle stays within ~1e-4
// rad at 8.4M symbols, where a single ws*s product would not.  Every step
// is rounded as written (__fmul_rn/__fadd_rn: no FMA contraction) and
// sincosf is the accurate one (no --use_fast_math), so the plain version
// computes the same angles.  The taps come either from the device (the
// traced-taps entry) or are built in the kernel from the estimates (w,
// lag[4], shift2) read by pointer from a small device buffer (the
// _scalars entry): flat = conv(lagrange at t0 = shift2 + 4, mf) from the
// 12 shifted rows of the matched filter, then fr/fi = flat * cos/sin(w t).
// Reading the estimates by pointer keeps the host from waiting on the
// previous block's estimate chain.
//
// Bound on the H100: the planes are read once (8 bytes per sample) and
// the symbols written (2 bytes per sample): 335.5 MB, 0.100 ms at 2^25
// samples; 4*MD FMAs per symbol (176 at MD = 44), 1.5 GFMA, 0.044 ms on
// the CUDA cores.  So the kernel is bound by its bytes, with the FMAs and
// the epilogue's sincosf to be hidden under the copies.  Design:
// - persistent blocks (qpsk_sym.partition, passed in): T threads (128,
//   or 64 when a call has fewer than 264 tiles of 4T symbols; the entry
//   takes 64, 128 or 256), block b walking tiles b, b + B, ... (B at most
//   6,336: 48 blocks an SM, 5 resident at 95 registers); a tile is
//   S = 4T symbols, S divides 65536, so a tile lies in one TPU step and
//   its de-rotation base is computed once a tile, wsm and w128 once a
//   block;
// - the taps are loaded (traced taps) or built from the estimates
//   (_scalars) once a block into shared memory;
// - a tile's window is its S + MD/4 sample quads of each plane (global
//   quads s0 - MD/4 + 1 .. s0 + S), copied with 16-byte cp.async into one
//   of kStages = 2 buffers while the block computes the other (the first
//   window while the taps are read or built).  Only the call's first
//   tile reads the context and only its last tile reaches past N: the
//   copy routine decides both once a tile, interior tiles take the
//   unchecked path;
// - register-blocked polyphase sums: a thread computes 4 consecutive
//   symbols f .. f + 3.  With t = 4q + p, symbol f reads element 0 of
//   window quad f + M - q at p = 0 and elements 3, 2, 1 of quad
//   f + M - 1 - q at p = 1, 2, 3 (M = MD/4).  So the thread holds 5 quads
//   of each plane in a ring of registers and each step of q loads one new
//   quad a plane (and one quad of fr and of fi, broadcast) for 64 FMAs.
//   Window quad j lies at shared quad j ^ ((j >> 3) & 3): the 8 lanes of
//   a quarter warp read quads 4 apart, and the swizzle spreads them over
//   the 8 16-byte bank groups (conflict-free, tests/_k5_sym_replay.py);
// - each symbol keeps the parent's arithmetic, so its bits are the
//   parent's: the four fmaf chains (xr*fr, xi*fi, xr*fi, xi*fr) over
//   t = 0 .. MD-1 in ascending order, the __fsub_rn/__fadd_rn combine,
//   the angle decomposition above and the accurate sincosf; each
//   thread stores its 4 symbols as one float4 a plane.
//
// Panels (qpsk_panel_tf32x3_kernel + qpsk_panel_chunk_sum_kernel):
//
//   P[pa, pb][m, c] = sum_r A_pa[r, m] * B_pb[r, c],  m < 128, c < w
//   A_p[r, m] = plane_p[128 r + m]       (0 at or past K = N - hw)
//   B_p[r, c] = plane_p[128 r + c - hw]  (0 outside [0, N))
//
// over the R = ceil(K / 128) rows, w = 128 + 2hw, planes re (0) and im
// (1): P1 = P[re, re], P2 = -P[re, im], P3 = P[im, re], P4 = -P[im, im]
// (TimingEstimator.corr_panels).  4 x 128 x w multiply-adds per row: 30.9
// GFMA at 33.5M samples and hw 51.
//
// Bound on the H100: tensor operations.  In 3xTF32 (tf32x3.cuh: x = hi +
// lo, three TF32 products a term, about 21 bits kept, float32 accuracy)
// that is 3 x 61.7 GFLOP at 495 TFLOP/s = 0.374 ms, against 0.080 ms to
// read the planes; the f32 CUDA cores (67 TFLOP/s) would need 0.92 ms.
// Design:
// - the rows are cut into at least 66 chunks (floor(R / 66) rows each);
//   one block per (chunk, tile), a tile being 128 rows of one A plane x
//   128 columns of one window (the second tile of a window holds its
//   last w8 - 128 columns, w8 = w rounded up to 8), two warpgroups of 64
//   rows, 215 registers, one block an SM;
// - the products are Hopper warpgroup MMAs, wgmma m64n128k8 TF32: A from
//   registers (each thread loads and splits its fragment from the raw
//   stage), B from shared memory, which for TF32 must be K-major: B is
//   split and transposed once per stage into the 128-byte swizzle (the
//   32 k of a stage fill one 128-byte row).  mma.sync reached about a
//   quarter of the tensor cores' TF32 rate here, wgmma about all of it;
// - a stage is 32 rows: the A and B samples of each row are copied raw
//   with 1-D bulk copies (TMA), 4 rows a warp, completing on an mbarrier,
//   masked stages at the planes' edges with zero-filling cp.async; two
//   stages in flight.  While a stage's wgmma run, the block copies the
//   stage after next and splits the next stage's B;
// - the tensor cores' float32 accumulation truncates: summed over a
//   whole chunk (4,000 rows) the panels drifted to 4e-5 of float64.  So
//   each stage's products start from zero and are then added into
//   float32 sums with __fadd_rn: no accumulation on the tensor cores
//   spans more than 32 rows;
// - a second kernel adds the chunks' partial panels in chunk order.  No
//   float atomics: two runs give bit-identical panels, so an argmax or
//   floor downstream cannot flip between runs.
// The remaining distance to the bound (1.08 ms against 0.374 at 2^25):
// shared-memory traffic (B read three times a k-step by the wgmma, the
// raw copies and the split's reads and writes), the copy and split
// phases of a block that overlap the wgmma only in part, and 10% of
// computed columns past w8 at hw 51.
//
// Not carried over from the TPU kernel: the [N/512, 512] row views and
// 8-row halo DMAs, the band matrices BA/BB, the lane-127 column term, the
// roll + select of the panel operands and the bf16x3 split (here TF32).
// Fusing symbols and panels into one read of the planes is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include "tf32x3.cuh"

namespace {

constexpr int kSymR = 4;                      // symbols a thread
constexpr int kRing = kSymR + 1;              // window quads a thread holds
static_assert(kSymR % 4 == 0, "symbols are stored as float4");
constexpr int kSymThreadsMax = 256;           // threads a block, at most
constexpr int kSymThreadsMin = 64;
constexpr int kStages = 2;                    // window buffers a block
constexpr int kMdMax = 132;
constexpr int kStepSyms = 65536;              // symbols per TPU grid step
constexpr int kRows = 512;                    // rows of 128 per step
constexpr int kMfLanes = 128;
constexpr float kTwoPi = 6.283185307179586f;

__device__ __forceinline__ float mod_2pi(float x) {
  // jnp.mod / torch.remainder: fmod, then the sign of the divisor.
  float r = fmodf(x, kTwoPi);
  if (r != 0.f && (r < 0.f)) r = __fadd_rn(r, kTwoPi);
  return r;
}

// Quads of one plane of one window buffer: S + M rounded up to the
// swizzle's groups of kSymR quads.
__host__ __device__ __forceinline__ int window_quads(int S, int M) {
  return (S + M + kSymR - 1) / kSymR * kSymR;
}

// Shared quad of window quad j.
__device__ __forceinline__ int swz(int j) {
  return j ^ ((j >> 3) & (kSymR - 1));
}

__device__ __forceinline__ void cp_async16(float4* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

struct SymShape {
  int64_t quads;    // N / 4: sample quads of a plane (= symbols)
  int M;            // MD / 4
  int S;            // symbols a tile (kSymR * blockDim.x)
  int wq;           // window_quads(S, M)
  int tiles;        // quads / S
  int aligned;      // both planes 16-byte aligned (else plain loads)
};

// The window of the tile at symbol s0 into buffer w (re quads at w, im at
// w + s.wq): global quads s0 - M + 1 + j for j < S + M, as one cp.async
// group of each thread.  Quads below 0 come from the context (zeros
// without one), quads at or past N/4 are zero; only the call's first and
// last tiles have them.
__device__ __forceinline__ void load_window(
    float4* w, const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ ctx_r, const float* __restrict__ ctx_i,
    const SymShape& s, int64_t s0) {
  const int T = blockDim.x;
  const int nq = s.S + s.M;
  const int64_t k0 = s0 - s.M + 1;
  const int j_lo = k0 < 0 ? static_cast<int>(-k0) : 0;
  const int j_hi = k0 + nq > s.quads ? static_cast<int>(s.quads - k0) : nq;
  const float* pr = xr + 4 * k0;
  const float* pi = xi + 4 * k0;
  if (s.aligned) {
#pragma unroll 1
    for (int j = j_lo + static_cast<int>(threadIdx.x); j < j_hi; j += T) {
      cp_async16(w + swz(j), pr + 4 * j);
      cp_async16(w + s.wq + swz(j), pi + 4 * j);
    }
  } else {
#pragma unroll 1
    for (int j = j_lo + static_cast<int>(threadIdx.x); j < j_hi; j += T) {
      w[swz(j)] = make_float4(pr[4 * j], pr[4 * j + 1], pr[4 * j + 2],
                              pr[4 * j + 3]);
      w[s.wq + swz(j)] = make_float4(pi[4 * j], pi[4 * j + 1],
                                     pi[4 * j + 2], pi[4 * j + 3]);
    }
  }
  if (j_lo > 0) {                             // the call's first tile
    const int MD = 4 * s.M;
#pragma unroll 1
    for (int j = threadIdx.x; j < j_lo; j += T) {
      float vr[4] = {0.f, 0.f, 0.f, 0.f}, vi[4] = {0.f, 0.f, 0.f, 0.f};
      if (ctx_r != nullptr) {
        const int c = MD - 1 + 4 * static_cast<int>(k0 + j);   // >= 3
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          vr[e] = ctx_r[c + e];
          vi[e] = ctx_i[c + e];
        }
      }
      w[swz(j)] = make_float4(vr[0], vr[1], vr[2], vr[3]);
      w[s.wq + swz(j)] = make_float4(vi[0], vi[1], vi[2], vi[3]);
    }
  }
#pragma unroll 1
  for (int j = j_hi + static_cast<int>(threadIdx.x); j < nq; j += T) {
    w[swz(j)] = make_float4(0.f, 0.f, 0.f, 0.f);        // the last tile
    w[s.wq + swz(j)] = make_float4(0.f, 0.f, 0.f, 0.f);
  }
  asm volatile("cp.async.commit_group;\n" ::);
}

// One step of q for the thread's kSymR symbols: quad slot (u - q) mod
// kRing holds window quad f + M - 1 - q + u (u = 0 .. kSymR); slot
// (-q) mod kRing takes the new quad f + M - 1 - q.  K = q mod kRing.
template <int K>
__device__ __forceinline__ void sym_step(
    const float4* __restrict__ cur, int wq, int j, float4 a, float4 b,
    float4 (&qr)[kRing], float4 (&qi)[kRing], float (&acc)[kSymR][4]) {
  constexpr int p0 = (kRing - K) % kRing;
  qr[p0] = cur[swz(j)];
  qi[p0] = cur[wq + swz(j)];
#pragma unroll
  for (int r = 0; r < kSymR; ++r) {
    const float4 lr = qr[(r + kRing - K) % kRing];
    const float4 li = qi[(r + kRing - K) % kRing];
    const float hr = qr[(r + 1 + kRing - K) % kRing].x;
    const float hi = qi[(r + 1 + kRing - K) % kRing].x;
    float* c = acc[r];
    // t = 4q: element 0 of quad u = r + 1
    c[0] = fmaf(hr, a.x, c[0]);
    c[1] = fmaf(hi, b.x, c[1]);
    c[2] = fmaf(hr, b.x, c[2]);
    c[3] = fmaf(hi, a.x, c[3]);
    // t = 4q + 1, 4q + 2, 4q + 3: elements 3, 2, 1 of quad u = r
    c[0] = fmaf(lr.w, a.y, c[0]);
    c[1] = fmaf(li.w, b.y, c[1]);
    c[2] = fmaf(lr.w, b.y, c[2]);
    c[3] = fmaf(li.w, a.y, c[3]);
    c[0] = fmaf(lr.z, a.z, c[0]);
    c[1] = fmaf(li.z, b.z, c[1]);
    c[2] = fmaf(lr.z, b.z, c[2]);
    c[3] = fmaf(li.z, a.z, c[3]);
    c[0] = fmaf(lr.y, a.w, c[0]);
    c[1] = fmaf(li.y, b.w, c[1]);
    c[2] = fmaf(lr.y, b.w, c[2]);
    c[3] = fmaf(li.y, a.w, c[3]);
  }
}

// Steps q + K, q + K + 1, ... of a chunk of kRing steps (q a multiple of
// kRing, so that each step's ring slots are constants), up to M.
template <int K>
struct SymChunk {
  static __device__ __forceinline__ void run(
      const float4* __restrict__ cur, int wq, int j, int left,
      const float4* __restrict__ ta, const float4* __restrict__ tb,
      float4 (&qr)[kRing], float4 (&qi)[kRing], float (&acc)[kSymR][4]) {
    sym_step<K>(cur, wq, j - K, ta[K], tb[K], qr, qi, acc);
    if (K + 1 < left) {
      SymChunk<K + 1>::run(cur, wq, j, left, ta, tb, qr, qi, acc);
    }
  }
};

template <>
struct SymChunk<kRing> {
  static __device__ __forceinline__ void run(
      const float4* __restrict__, int, int, int, const float4* __restrict__,
      const float4* __restrict__, float4 (&)[kRing], float4 (&)[kRing],
      float (&)[kSymR][4]) {}
};

__global__ void __launch_bounds__(kSymThreadsMax, 2) qpsk_sym_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ ctx_r, const float* __restrict__ ctx_i,
    const float* __restrict__ taps_r, const float* __restrict__ taps_i,
    const float* __restrict__ params, const float* __restrict__ mf_rows,
    const float* __restrict__ scal_f, const int* __restrict__ scal_i,
    const SymShape s, float* __restrict__ yr, float* __restrict__ yi) {
  __shared__ float4 s_taps[2][kMdMax / 4];   // fr, fi as quads of t
  extern __shared__ float4 s_win[];
  float* const s_fr = reinterpret_cast<float*>(s_taps[0]);
  float* const s_fi = reinterpret_cast<float*>(s_taps[1]);
  const int T = blockDim.x;
  const int M = s.M, MD = 4 * s.M;
  const int stride = static_cast<int>(gridDim.x);
  // the first windows are in flight while the taps are read or built
  // (one cp.async group a tile, an empty one past the last)
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    const int tile = static_cast<int>(blockIdx.x) + k * stride;
    if (tile < s.tiles) {
      load_window(s_win + 2 * s.wq * k, xr, xi, ctx_r, ctx_i, s,
                  static_cast<int64_t>(tile) * s.S);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }
  }

  float ws, phase0;
  if (taps_r != nullptr) {                    // traced taps
    ws = params[0];
    phase0 = params[1];
    for (int t = threadIdx.x; t < MD; t += T) {
      s_fr[t] = taps_r[t];
      s_fi[t] = taps_i[t];
    }
  } else {                                    // taps from the estimates
    const float w = scal_f[0];
    const int t0 = scal_i[0] + 4;
    ws = __fmul_rn(w, 4.f);
    phase0 = scal_f[5];
    for (int t = threadIdx.x; t < MD; t += T) {
      float flat = 0.f;
      for (int k = 0; k < 12; ++k) {
        const int j = k - t0;
        const float a = (j >= 0 && j < 4) ? scal_f[1 + j] : 0.f;
        flat = __fadd_rn(flat, __fmul_rn(a, mf_rows[k * kMfLanes + t]));
      }
      float sn, cs;
      sincosf(__fmul_rn(w, static_cast<float>(t)), &sn, &cs);
      s_fr[t] = __fmul_rn(flat, cs);
      s_fi[t] = __fmul_rn(flat, sn);
    }
  }
  const float wsm = mod_2pi(ws);
  const float w128 = mod_2pi(__fmul_rn(wsm, 128.f));
  const float head = __fadd_rn(phase0, wsm);
  const float per_step = __fmul_rn(w128, static_cast<float>(kRows));

  const int fa = kSymR * static_cast<int>(threadIdx.x);
  for (int tile = blockIdx.x, it = 0; tile < s.tiles; tile += stride, ++it) {
    const float4* const cur = s_win + 2 * s.wq * (it % kStages);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(kStages - 2) : "memory");
    __syncthreads();                  // window in; the last tile done
    const int ahead = tile + (kStages - 1) * stride;
    if (ahead < s.tiles) {
      load_window(s_win + 2 * s.wq * ((it + kStages - 1) % kStages), xr, xi,
                  ctx_r, ctx_i, s, static_cast<int64_t>(ahead) * s.S);
    } else {
      asm volatile("cp.async.commit_group;\n" ::);
    }

    float acc[kSymR][4];
#pragma unroll
    for (int r = 0; r < kSymR; ++r) {
      acc[r][0] = acc[r][1] = acc[r][2] = acc[r][3] = 0.f;
    }
    float4 qr[kRing], qi[kRing];
    const int j0 = fa + M - 1;
#pragma unroll
    for (int u = 1; u < kRing; ++u) {
      qr[u] = cur[swz(j0 + u)];
      qi[u] = cur[s.wq + swz(j0 + u)];
    }
#pragma unroll 1
    for (int q = 0; q < M; q += kRing) {
      SymChunk<0>::run(cur, s.wq, j0 - q, M - q, s_taps[0] + q,
                       s_taps[1] + q, qr, qi, acc);
    }

    // de-rotation: base once a tile (a tile lies in one TPU step)
    const int64_t s0 = static_cast<int64_t>(tile) * s.S;
    const int64_t g = s0 / kStepSyms;
    const float base = mod_2pi(__fadd_rn(
        head, __fmul_rn(per_step, static_cast<float>(g))));
    const int rem0 = static_cast<int>(s0 - g * kStepSyms) + fa;
    float o_r[kSymR], o_i[kSymR];
#pragma unroll
    for (int r = 0; r < kSymR; ++r) {
      const float y_r = __fsub_rn(acc[r][0], acc[r][1]);
      const float y_i = __fadd_rn(acc[r][2], acc[r][3]);
      const int rem = rem0 + r;
      const float ang = __fadd_rn(
          __fadd_rn(base, __fmul_rn(w128, static_cast<float>(rem >> 7))),
          __fmul_rn(wsm, static_cast<float>(rem & 127)));
      float sn, cs;
      sincosf(ang, &sn, &cs);
      o_r[r] = __fadd_rn(__fmul_rn(y_r, cs), __fmul_rn(y_i, sn));
      o_i[r] = __fsub_rn(__fmul_rn(y_i, cs), __fmul_rn(y_r, sn));
    }
#pragma unroll
    for (int r = 0; r < kSymR; r += 4) {
      *reinterpret_cast<float4*>(yr + s0 + fa + r) =
          make_float4(o_r[r], o_r[r + 1], o_r[r + 2], o_r[r + 3]);
      *reinterpret_cast<float4*>(yi + s0 + fa + r) =
          make_float4(o_i[r], o_i[r + 1], o_i[r + 2], o_i[r + 3]);
    }
  }
}

// ---- panels
// Block tile: all 128 rows of one A plane (re or im) x kBN = 128 columns
// of one window (Wr or Wi), two warpgroups of 64 rows (one m64n128k8
// wgmma shape each).
constexpr int kLanes = 128;
constexpr int kBN = 128;
constexpr int kPanelThreads = 256;
constexpr int kStageRows = 32;        // rows of 128 samples a stage
static_assert(kStageRows * 4 == 128, "one 128-byte swizzle row of k");
// Each stage is copied raw, two stages in flight: per row the 128 A
// samples and kBN + 4 B samples (the window's start rounded down to 4
// samples, so that the copies are 16-byte aligned).  A rows are 136
// floats apart: the A fragment loads (lane (g, t) at row t, column g +
// const) hit 32 banks.
constexpr int kRawA = kLanes + 8;
constexpr int kRawB = kBN + 4;
constexpr int kRawFloats = kStageRows * (kRawA + kRawB);
// B, split into hi and lo, is stored K-major in the 128-byte swizzle
// (tf32x3::smem_desc_sw128): row n of B^T (32 k, 128 bytes) at n * 128,
// its k chunk Q (4 values) at chunk Q ^ (n % 8).
constexpr int kOpFloats = kBN * kStageRows;
constexpr int kSplitFloats = 2 * kOpFloats;
constexpr int kPanelSmem = static_cast<int>(
    (2 * kRawFloats + 2 * kSplitFloats) * sizeof(float) + 1024);

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;"
               :: "r"(dst), "l"(src));
}

// mbarrier and 1-D bulk copies (the TMA): a stage's rows are copied by
// lane 0 of each warp and complete on the stage buffer's mbarrier.
__device__ __forceinline__ void mbar_init(uint64_t* bar, int arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(arrivals));
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

// Spins until the phase of the given parity completes; traps (an error,
// not a hang) if it has not after ~2^26 tries, seconds on the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t i = 0; !done; ++i) {
    if (i == (1u << 26)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  }
}

__device__ __forceinline__ void bulk_copy(uint32_t dst, const float* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}

// Four samples plane[i .. i+3] into shared memory at dst, each zero
// outside [lo, hi): one 16-byte cp.async where all four are inside and
// aligned, else four 4-byte ones (src-size 0 writes a zero).
__device__ __forceinline__ void stage4(uint32_t dst, const float* plane,
                                       int64_t i, int64_t lo, int64_t hi) {
  const float* src = plane + i;
  if (i >= lo && i + 4 <= hi &&
      (reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    cp_async16(dst, src);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const bool on = i + e >= lo && i + e < hi;
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;"
                 :: "r"(dst + 4 * e), "l"(on ? src + e : plane),
                 "r"(on ? 4 : 0));
  }
}

// One raw stage, rows r0 .. r0 + kStageRows - 1: A[rr][c] = pa[128 r +
// c], zero at or past a_end; B[rr][c] = pb[128 r + b0 + c], zero outside
// [0, n).  A `plain` stage (every sample inside its range, the planes
// 16-byte aligned) is 2 x kStageRows bulk copies, kStageRows / kWarps
// rows of each from lane 0 of each warp; else each thread copies its
// share with cp.async, zero-filling.  Either way lane 0 of each warp
// arrives on `bar` with the bulk bytes it expects (0 if none).
constexpr int kWarps = kPanelThreads / 32;
static_assert(kStageRows % kWarps == 0, "rows a warp");
__device__ __forceinline__ void panel_stage_load(
    float* raw, uint64_t* bar, const float* pa, const float* pb, int64_t r0,
    int64_t b0, int64_t a_end, int64_t n, bool plain) {
  constexpr int kGA = kLanes / 4, kGB = kRawB / 4;
  constexpr int kRowsW = kStageRows / kWarps;
  const uint32_t base = smem_addr(raw);
  const int64_t ia = kLanes * r0, ib = kLanes * r0 + b0;
  const bool leader = threadIdx.x % 32 == 0;
  if (plain) {
    if (leader) {
      tf32x3::fence_smem_for_wgmma();         // earlier reads before the copy
      mbar_arrive(bar, kRowsW * (kLanes + kRawB) * sizeof(float));
#pragma unroll
      for (int k = 0; k < kRowsW; ++k) {
        const int rr = threadIdx.x / 32 * kRowsW + k;
        bulk_copy(base + 4 * rr * kRawA, pa + ia + kLanes * rr,
                  kLanes * sizeof(float), bar);
        bulk_copy(base + 4 * (kStageRows * kRawA + rr * kRawB),
                  pb + ib + kLanes * rr, kRawB * sizeof(float), bar);
      }
    }
    return;
  }
  if (leader) mbar_arrive(bar, 0);
  for (int q = threadIdx.x; q < kStageRows * kGA; q += kPanelThreads) {
    const int rr = q / kGA, c = 4 * (q % kGA);
    stage4(base + 4 * (rr * kRawA + c), pa, ia + kLanes * rr + c, 0, a_end);
  }
  for (int q = threadIdx.x; q < kStageRows * kGB; q += kPanelThreads) {
    const int rr = q / kGB, c = 4 * (q % kGB);
    stage4(base + 4 * (kStageRows * kRawA + rr * kRawB + c), pb,
           ib + kLanes * rr + c, 0, n);
  }
}

// The raw stage's B split into hi and lo (tf32x3.cuh) and transposed into
// the swizzled K-major rows: item (k chunk Q, column n) reads four raw
// rows at column n + d (consecutive n on consecutive lanes) and writes
// 16 bytes of hi and of lo (eight lanes cover the 8 chunks of the 32
// banks).
__device__ __forceinline__ void panel_split_b(const float* raw, float* split,
                                              int d) {
  constexpr int kQ = kStageRows / 4;
  const float* rawb = raw + kStageRows * kRawA + d;
#pragma unroll
  for (int q = threadIdx.x; q < kQ * kBN; q += kPanelThreads) {
    const int nn = q % kBN, Q = q / kBN;
    uint32_t h[4], l[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      tf32x3::split_tf32(rawb[(4 * Q + e) * kRawB + nn], h[e], l[e]);
    float* hi = split + nn * 32 + 4 * (Q ^ (nn & 7));
    *reinterpret_cast<uint4*>(hi) = make_uint4(h[0], h[1], h[2], h[3]);
    *reinterpret_cast<uint4*>(hi + kOpFloats) =
        make_uint4(l[0], l[1], l[2], l[3]);
  }
  tf32x3::fence_smem_for_wgmma();
}

// Partial panels of one chunk of rows for one block tile:
// part[chunk][2 pa + pb][128][w8], pa/pb = 0 for re, 1 for im.  Per
// stage each warpgroup loads and splits its A fragments from the raw
// stage and issues 3 x kStageRows / 8 wgmma (3xTF32) into an accumulator
// that starts from zero; while they run the block copies the stage after
// next and splits the next stage's B; then the accumulator is added into
// float32 sums with __fadd_rn, so that no accumulation on the tensor
// cores spans more than one stage.
__global__ void __launch_bounds__(kPanelThreads, 1)
qpsk_panel_tf32x3_kernel(const float* __restrict__ xr,
                         const float* __restrict__ xi, int64_t n, int hw,
                         int64_t K, int64_t R, int chunk_rows, int w8,
                         float* __restrict__ part) {
  extern __shared__ __align__(16) float smem[];
  float* raw = smem;                          // two raw stages
  // two split stages of B, 1024-byte aligned (the swizzle atoms)
  const uint32_t pad = (1024 - smem_addr(smem + 2 * kRawFloats) % 1024) % 1024;
  float* split = smem + 2 * kRawFloats + pad / 4;
  const int nbc = (w8 + kBN - 1) / kBN;
  const int nb = blockIdx.x % nbc;
  const int pb_i = (blockIdx.x / nbc) % 2;
  const int pa_i = blockIdx.x / (2 * nbc);
  const float* pa = pa_i ? xi : xr;
  const float* pb = pb_i ? xi : xr;
  const int cb = nb * kBN;                    // first column
  const int hwa = (hw + 3) & ~3;
  const int d = hwa - hw;                     // column c at B offset c - cb + d
  const int64_t b0 = cb - hwa;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r_end =
      r_begin + chunk_rows < R ? r_begin + chunk_rows : R;
  // A is zero past the chunk's rows as well: a stage may overhang them.
  const int64_t a_end = K < kLanes * r_end ? K : kLanes * r_end;
  const int steps =
      static_cast<int>((r_end - r_begin + kStageRows - 1) / kStageRows);
  const bool aligned =
      ((reinterpret_cast<uintptr_t>(xr) | reinterpret_cast<uintptr_t>(xi)) &
       15) == 0;
  const int lane = threadIdx.x % 32;
  const int g = lane >> 2, t = lane & 3;
  const int wg = threadIdx.x / 128;
  const int row = 64 * wg + 16 * ((threadIdx.x / 32) % 4) + g;

  __shared__ __align__(8) uint64_t bars[2];   // one per raw stage buffer
  auto load = [&](int s) {
    const int64_t r0 = r_begin + static_cast<int64_t>(s) * kStageRows;
    const bool plain = aligned && kLanes * r0 + b0 >= 0 &&
                       kLanes * (r0 + kStageRows - 1) + b0 + kRawB <= n &&
                       kLanes * (r0 + kStageRows) <= a_end;
    panel_stage_load(raw + (s % 2) * kRawFloats, &bars[s % 2], pa, pb, r0,
                     b0, a_end, n, plain);
    asm volatile("cp.async.commit_group;");
  };
  // stage s in: the thread's own cp.async copies, then the buffer's
  // mbarrier (its (s / 2)-th phase), then every thread's
  auto wait_stage = [&](int s) {
    asm volatile("cp.async.wait_group 0;");
    mbar_wait(&bars[s % 2], (s / 2) & 1);
    __syncthreads();
  };

  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.f;
  uint32_t ah[kStageRows / 8][4], al[kStageRows / 8][4];

  if (threadIdx.x == 0) {
    mbar_init(&bars[0], kWarps);
    mbar_init(&bars[1], kWarps);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  load(0);
  if (steps > 1) load(1);
  wait_stage(0);
  panel_split_b(raw, split, d);
  __syncthreads();
  for (int s = 0; s < steps; ++s) {
    // A fragments (rows row, row + 8; k = 8 kb + t, + 4) from the raw stage
    const float* ra = raw + (s % 2) * kRawFloats + t * kRawA + row;
#pragma unroll
    for (int kb = 0; kb < kStageRows / 8; ++kb) {
      const float* p = ra + 8 * kb * kRawA;
      tf32x3::split_tf32(p[0], ah[kb][0], al[kb][0]);
      tf32x3::split_tf32(p[8], ah[kb][1], al[kb][1]);
      tf32x3::split_tf32(p[4 * kRawA], ah[kb][2], al[kb][2]);
      tf32x3::split_tf32(p[4 * kRawA + 8], ah[kb][3], al[kb][3]);
    }
    const uint32_t bh = smem_addr(split + (s % 2) * kSplitFloats);
    const uint32_t bl = bh + kOpFloats * sizeof(float);
    tf32x3::fence_regs(acc);
    tf32x3::wgmma_fence();
#pragma unroll
    for (int kb = 0; kb < kStageRows / 8; ++kb) {
      tf32x3::wgmma_tf32x3(acc, ah[kb], al[kb],
                           tf32x3::smem_desc_sw128(bh + 32 * kb, 1024),
                           tf32x3::smem_desc_sw128(bl + 32 * kb, 1024),
                           kb > 0);
    }
    tf32x3::wgmma_commit();
    if (s + 1 < steps) {                      // the next stage, meanwhile
      wait_stage(s + 1);
      if (s + 2 < steps) load(s + 2);
      panel_split_b(raw + ((s + 1) % 2) * kRawFloats,
                    split + ((s + 1) % 2) * kSplitFloats, d);
    }
    tf32x3::wgmma_wait();
    tf32x3::fence_regs(acc);
#pragma unroll
    for (int kb = 0; kb < kStageRows / 8; ++kb) {
      tf32x3::fence_regs(ah[kb]);
      tf32x3::fence_regs(al[kb]);
    }
#pragma unroll
    for (int i = 0; i < 64; ++i) sum[i] = __fadd_rn(sum[i], acc[i]);
    __syncthreads();             // B of stage s + 1 in; stage s read
  }

  // the m64n128 accumulator layout: rows row and row + 8, columns 8j + 2t
  // and 8j + 2t + 1 in sum[4j .. 4j + 3]
  float* out = part + (static_cast<int64_t>(blockIdx.y) * 4 + 2 * pa_i +
                       pb_i) * kLanes * w8;
#pragma unroll
  for (int j = 0; j < kBN / 8; ++j) {
    const int col = cb + 8 * j + 2 * t;
    if (cb + 8 * j < w8) {
      *reinterpret_cast<float2*>(&out[row * w8 + col]) =
          make_float2(sum[4 * j], sum[4 * j + 1]);
      *reinterpret_cast<float2*>(&out[(row + 8) * w8 + col]) =
          make_float2(sum[4 * j + 2], sum[4 * j + 3]);
    }
  }
}

// panels [4][128][width]: P1, P2, P3, P4, each the sum over the chunks in
// chunk order, with the conj negation on P2 and P4.
__global__ void qpsk_panel_chunk_sum_kernel(const float* __restrict__ part,
                                            int chunks, int width, int w8,
                                            float* __restrict__ panels) {
  const int64_t total = 4LL * kLanes * width;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (o >= total) return;
  const int p = static_cast<int>(o / (kLanes * width));
  const int rem = static_cast<int>(o % (kLanes * width));
  const float* src = part + (static_cast<int64_t>(p) * kLanes +
                             rem / width) * w8 + rem % width;
  const int64_t step = 4LL * kLanes * w8;
  float acc = 0.f;
  for (int k = 0; k < chunks; ++k) acc = __fadd_rn(acc, src[k * step]);
  panels[o] = (p & 1) ? -acc : acc;
}

}  // namespace

// C entry for ctypes: the symbols.  Pointers on the current device:
// xr/xi [n] (n % 4 == 0); ctx_r/ctx_i [MD - 1] or null (zero context);
// either taps_r/taps_i [MD] with params [2] = (ws, phase0), or (taps_r
// null) mf_rows [16 x 128], scal_f [6] = (w, lag[4], phase0) and scal_i
// [1] = shift2; yr/yi [n / 4], 16-byte aligned.  MD % 4 == 0, MD <= 132.
// The partition (qpsk_sym.partition): `threads` a block (64, 128 or 256;
// tiles of 4 * threads symbols, which must divide n / 4) and `blocks`
// (at most the tiles).  Launches on `stream` without synchronising;
// returns cudaGetLastError().
extern "C" int qpsk_sym_launch(const void* xr, const void* xi,
                               const void* ctx_r, const void* ctx_i,
                               int MD, const void* taps_r,
                               const void* taps_i, const void* params,
                               const void* mf_rows, const void* scal_f,
                               const void* scal_i, int64_t n, int threads,
                               int blocks, void* yr, void* yi,
                               void* stream) {
  const int S = kSymR * threads;
  if (MD < 4 || MD > kMdMax || MD % 4 != 0 || n <= 0 || n % 4 != 0 ||
      (taps_r == nullptr && (mf_rows == nullptr || scal_f == nullptr ||
                             scal_i == nullptr || MD > kMfLanes)) ||
      threads < kSymThreadsMin || threads > kSymThreadsMax ||
      (threads & (threads - 1)) != 0 || (n / 4) % S != 0 ||
      (n / 4) / S > INT32_MAX || blocks < 1 || blocks > (n / 4) / S ||
      ((reinterpret_cast<uintptr_t>(yr) | reinterpret_cast<uintptr_t>(yi)) &
       15) != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SymShape s{n / 4, MD / 4, S, window_quads(S, MD / 4),
             static_cast<int>((n / 4) / S), 0};
  s.aligned = ((reinterpret_cast<uintptr_t>(xr) |
                reinterpret_cast<uintptr_t>(xi)) & 15) == 0;
  const int smem = static_cast<int>(sizeof(float4)) * 2 * kStages * s.wq;
  // The limit is raised once per device, to the most any call takes.
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(
        qpsk_sym_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(sizeof(float4)) * 2 * kStages *
            window_quads(kSymR * kSymThreadsMax, kMdMax / 4));
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  qpsk_sym_kernel<<<blocks, threads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(ctx_r), static_cast<const float*>(ctx_i),
      static_cast<const float*>(taps_r), static_cast<const float*>(taps_i),
      static_cast<const float*>(params), static_cast<const float*>(mf_rows),
      static_cast<const float*>(scal_f), static_cast<const int*>(scal_i), s,
      static_cast<float*>(yr), static_cast<float*>(yi));
  return static_cast<int>(cudaGetLastError());
}

// C entry for ctypes: the correlation panels.  xr/xi [n]; part [chunks x
// 4 x 128 x w8] scratch (w8 = 128 + 2hw rounded up to a multiple of 8),
// chunks = ceil(R / chunk_rows), R = ceil((n - hw) / 128); panels [4 x
// 128 x (128 + 2hw)].  0 < hw <= 64.  Two launches on `stream`; returns
// cudaGetLastError().
extern "C" int qpsk_panels_launch(const void* xr, const void* xi, int64_t n,
                                  int hw, int chunk_rows, void* part,
                                  int chunks, void* panels, void* stream) {
  const int64_t K = n - hw;
  const int64_t R = (K + kLanes - 1) / kLanes;
  if (hw <= 0 || hw > 64 || K <= 0 || chunk_rows <= 0 || chunks < 1 ||
      chunks > 65535 || static_cast<int64_t>(chunks) * chunk_rows < R ||
      static_cast<int64_t>(chunks - 1) * chunk_rows >= R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width = kLanes + 2 * hw;
  const int w8 = (width + 7) & ~7;
  const int tiles = 4 * ((w8 + kBN - 1) / kBN);
  // The shared-memory limit is raised once per device: setting it on
  // every call costs host time on the served path.
  static bool smem_set[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev < 0 || dev >= 64) return static_cast<int>(cudaErrorInvalidDevice);
  if (!smem_set[dev]) {
    err = cudaFuncSetAttribute(qpsk_panel_tf32x3_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kPanelSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_set[dev] = true;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  qpsk_panel_tf32x3_kernel<<<dim3(tiles, chunks), kPanelThreads, kPanelSmem,
                             s>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi), n, hw, K,
      R, chunk_rows, w8, static_cast<float*>(part));
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = 4LL * kLanes * width;
  qpsk_panel_chunk_sum_kernel<<<static_cast<unsigned>((total + 255) / 256),
                                256, 0, s>>>(
      static_cast<const float*>(part), chunks, width, w8,
      static_cast<float*>(panels));
  return static_cast<int>(cudaGetLastError());
}
