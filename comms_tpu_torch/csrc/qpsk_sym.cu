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
// the symbols written (2 bytes per sample); 4*MD FMAs per symbol (176 at
// MD = 44): 1.5 GFMA at 33.5M samples, a few tenths of a ms on the CUDA
// cores.  One block per 256 symbols stages its window (4*256 + MD samples
// of each plane) in shared memory phase-major (sample i at [i % 4][i / 4]),
// so that the 32 threads of a warp read one phase at consecutive words for
// every tap (conflict-free); the four real sums (xr*fr, xi*fi, xr*fi,
// xi*fr) run as separate FMA chains over t, as the plain version's four
// products do.
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

constexpr int kSymThreads = 256;              // symbols per block
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

__global__ void qpsk_sym_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi,
    const float* __restrict__ ctx_r, const float* __restrict__ ctx_i,
    int MD, const float* __restrict__ taps_r,
    const float* __restrict__ taps_i, const float* __restrict__ params,
    const float* __restrict__ mf_rows, const float* __restrict__ scal_f,
    const int* __restrict__ scal_i, int64_t n, float* __restrict__ yr,
    float* __restrict__ yi) {
  __shared__ float s_fr[kMdMax], s_fi[kMdMax];
  extern __shared__ float smem[];
  const int M = MD / 4;
  const int Q = kSymThreads + M;              // window words per phase
  float* s_xr = smem;
  float* s_xi = smem + 4 * Q;

  float ws, phase0;
  if (taps_r != nullptr) {                    // traced taps
    ws = params[0];
    phase0 = params[1];
    for (int t = threadIdx.x; t < MD; t += kSymThreads) {
      s_fr[t] = taps_r[t];
      s_fi[t] = taps_i[t];
    }
  } else {                                    // taps from the estimates
    const float w = scal_f[0];
    const int t0 = scal_i[0] + 4;
    ws = __fmul_rn(w, 4.f);
    phase0 = scal_f[5];
    for (int t = threadIdx.x; t < MD; t += kSymThreads) {
      float flat = 0.f;
      for (int s = 0; s < 12; ++s) {
        const int j = s - t0;
        const float a = (j >= 0 && j < 4) ? scal_f[1 + j] : 0.f;
        flat = __fadd_rn(flat, __fmul_rn(a, mf_rows[s * kMfLanes + t]));
      }
      float sn, cs;
      sincosf(__fmul_rn(w, static_cast<float>(t)), &sn, &cs);
      s_fr[t] = __fmul_rn(flat, cs);
      s_fi[t] = __fmul_rn(flat, sn);
    }
  }

  const int64_t s0 = static_cast<int64_t>(blockIdx.x) * kSymThreads;
  const int64_t n0 = 4 * s0 + 4 - MD;         // window sample 0
  for (int i = threadIdx.x; i < 4 * Q; i += kSymThreads) {
    const int64_t m = n0 + i;
    float vr = 0.f, vi = 0.f;
    if (m >= 0) {
      if (m < n) {
        vr = xr[m];
        vi = xi[m];
      }
    } else if (ctx_r != nullptr) {
      vr = ctx_r[MD - 1 + m];
      vi = ctx_i[MD - 1 + m];
    }
    s_xr[(i & 3) * Q + (i >> 2)] = vr;
    s_xi[(i & 3) * Q + (i >> 2)] = vi;
  }
  __syncthreads();

  const int f = threadIdx.x;
  const int64_t s = s0 + f;
  if (4 * s >= n) return;
  // Symbol s reads window sample 4(f + M) - t.
  float prr = 0.f, pii = 0.f, pri = 0.f, pir = 0.f;
  for (int t = 0; t < MD; ++t) {
    const int i = 4 * (f + M) - t;
    const float x_r = s_xr[(i & 3) * Q + (i >> 2)];
    const float x_i = s_xi[(i & 3) * Q + (i >> 2)];
    prr = fmaf(x_r, s_fr[t], prr);
    pii = fmaf(x_i, s_fi[t], pii);
    pri = fmaf(x_r, s_fi[t], pri);
    pir = fmaf(x_i, s_fr[t], pir);
  }
  const float y_r = __fsub_rn(prr, pii);
  const float y_i = __fadd_rn(pri, pir);

  const float wsm = mod_2pi(ws);
  const float w128 = mod_2pi(__fmul_rn(wsm, 128.f));
  const int64_t g = s / kStepSyms;
  const int rem = static_cast<int>(s - g * kStepSyms);
  const float base = mod_2pi(__fadd_rn(
      __fadd_rn(phase0, wsm),
      __fmul_rn(__fmul_rn(w128, static_cast<float>(kRows)),
                static_cast<float>(g))));
  const float ang = __fadd_rn(
      __fadd_rn(base, __fmul_rn(w128, static_cast<float>(rem >> 7))),
      __fmul_rn(wsm, static_cast<float>(rem & 127)));
  float sn, cs;
  sincosf(ang, &sn, &cs);
  yr[s] = __fadd_rn(__fmul_rn(y_r, cs), __fmul_rn(y_i, sn));
  yi[s] = __fsub_rn(__fmul_rn(y_i, cs), __fmul_rn(y_r, sn));
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

extern "C" int64_t qpsk_sym_smem_bytes(int MD) {
  return static_cast<int64_t>(sizeof(float)) * 2 * 4 *
         (kSymThreads + MD / 4);
}

// C entry for ctypes: the symbols.  Pointers on the current device:
// xr/xi [n] (n % 4 == 0); ctx_r/ctx_i [MD - 1] or null (zero context);
// either taps_r/taps_i [MD] with params [2] = (ws, phase0), or (taps_r
// null) mf_rows [16 x 128], scal_f [6] = (w, lag[4], phase0) and scal_i
// [1] = shift2; yr/yi [n / 4].  MD % 4 == 0, MD <= 132.  Launches on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int qpsk_sym_launch(const void* xr, const void* xi,
                               const void* ctx_r, const void* ctx_i,
                               int MD, const void* taps_r,
                               const void* taps_i, const void* params,
                               const void* mf_rows, const void* scal_f,
                               const void* scal_i, int64_t n, void* yr,
                               void* yi, void* stream) {
  if (MD < 4 || MD > kMdMax || MD % 4 != 0 || n <= 0 || n % 4 != 0 ||
      (taps_r == nullptr && (mf_rows == nullptr || scal_f == nullptr ||
                             scal_i == nullptr || MD > kMfLanes))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int64_t smem = qpsk_sym_smem_bytes(MD);
  const int64_t syms = n / 4;
  const unsigned grid =
      static_cast<unsigned>((syms + kSymThreads - 1) / kSymThreads);
  cudaError_t err = cudaFuncSetAttribute(
      qpsk_sym_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  qpsk_sym_kernel<<<grid, kSymThreads, smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi),
      static_cast<const float*>(ctx_r), static_cast<const float*>(ctx_i), MD,
      static_cast<const float*>(taps_r), static_cast<const float*>(taps_i),
      static_cast<const float*>(params), static_cast<const float*>(mf_rows),
      static_cast<const float*>(scal_f), static_cast<const int*>(scal_i), n,
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
