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
// Panels (qpsk_panel_partial_kernel + qpsk_panel_reduce_kernel):
//
//   C[m, c] = sum_r A[r, m] * B[r, c],  m < 256, c < 512
//   A[r, m] = plane_m[128 r + (m % 128)] (0 at or past K = N - hw)
//   B[r, c] = plane_c[128 r + (c % 256) - hw] (0 outside [0, N))
//
// with plane_m = re for m < 128 else im and plane_c = re for c < 256 else
// im: P1 = C[:128, :w], P3 = C[128:, :w], P2 = -C[:128, 256:256+w],
// P4 = -C[128:, 256:256+w], w = 128 + 2hw (TimingEstimator.corr_panels).
// This is the receiver's heavy part: 256 x 512 FMAs per 128-sample row
// (34 GFMA at 33.5M samples, >= 1 ms on the CUDA cores).  The TPU kernel
// carried the panel sums from one grid step to the next; here the rows
// are cut into chunks of 4096 rows, one block per (64 x 64 output tile,
// chunk) forms its partial sums as a classic shared-memory SGEMM (16-row
// k-steps, 4 x 4 outputs per thread), and a second kernel adds the
// chunks in a fixed order.  No float atomics: two runs give bit-identical
// panels, so an argmax or floor downstream cannot flip between runs.
//
// Not carried over from the TPU kernel: the [N/512, 512] row views and
// 8-row halo DMAs, the band matrices BA/BB, the lane-127 column term, the
// roll + select of the panel operands and the bf16x3 split; all float32
// on the CUDA cores.  Fusing symbols and panels into one read of the
// planes, and tensor cores, are later work.

#include <cuda_runtime.h>
#include <stdint.h>

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
constexpr int kTile = 64;                     // output tile edge
constexpr int kK = 16;                        // rows per k-step
constexpr int kPanelThreads = 256;
constexpr int kM = 256;                       // rows of C (rev | imv)
constexpr int kC = 512;                       // columns of C (Wr | Wi)

__global__ void qpsk_panel_partial_kernel(
    const float* __restrict__ xr, const float* __restrict__ xi, int64_t n,
    int hw, int64_t K, int64_t R, int chunk_rows, int col_tiles,
    float* __restrict__ part) {
  __shared__ __align__(16) float As[kK][kTile];
  __shared__ __align__(16) float Bs[kK][kTile];
  const int mt = blockIdx.x % 4;              // tile of m
  const int ct = blockIdx.x / 4;              // tile of c, < 2*col_tiles
  const int m0 = mt * kTile;
  const int c0 = (ct < col_tiles ? ct : 4 + ct - col_tiles) * kTile;
  const float* pa = m0 < 128 ? xr : xi;
  const float* pb = c0 < 256 ? xr : xi;
  const int ja = m0 & 127;
  const int cb = c0 & 255;
  const int64_t r_begin = static_cast<int64_t>(blockIdx.y) * chunk_rows;
  const int64_t r_end = r_begin + chunk_rows < R ? r_begin + chunk_rows : R;

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;
  float acc[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b) acc[a][b] = 0.f;

  for (int64_t r0 = r_begin; r0 < r_end; r0 += kK) {
    // 16 rows x 64 columns of A and of B, 4 per thread.
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int idx = tid + e * kPanelThreads;
      const int rr = idx / kTile, cc = idx % kTile;
      const int64_t r = r0 + rr;
      float a = 0.f, b = 0.f;
      if (r < r_end) {
        const int64_t ka = 128 * r + ja + cc;
        if (ka < K) a = pa[ka];
        const int64_t kb = 128 * r + cb + cc - hw;
        if (kb >= 0 && kb < n) b = pb[kb];
      }
      As[rr][cc] = a;
      Bs[rr][cc] = b;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kK; ++kk) {
      const float4 a = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 b = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float av[4] = {a.x, a.y, a.z, a.w};
      const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int p = 0; p < 4; ++p)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[p][q] = fmaf(av[p], bv[q], acc[p][q]);
    }
    __syncthreads();
  }
  float* out = part + static_cast<int64_t>(blockIdx.y) * kM * kC;
#pragma unroll
  for (int p = 0; p < 4; ++p) {
    float4 v = make_float4(acc[p][0], acc[p][1], acc[p][2], acc[p][3]);
    *reinterpret_cast<float4*>(
        &out[(m0 + ty * 4 + p) * kC + c0 + tx * 4]) = v;
  }
}

// panels [4][128][width]: P1, P2, P3, P4, each the sum over the chunks in
// chunk order, with the conj negation on P2 and P4.
__global__ void qpsk_panel_reduce_kernel(const float* __restrict__ part,
                                         int chunks, int width,
                                         float* __restrict__ panels) {
  const int64_t total = 4LL * 128 * width;
  const int64_t o = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
  if (o >= total) return;
  const int p = static_cast<int>(o / (128 * width));
  const int rem = static_cast<int>(o % (128 * width));
  const int j = rem / width, col = rem % width;
  const int m = (p >= 2 ? 128 : 0) + j;       // P3, P4: imv rows
  const int c = (p == 1 || p == 3 ? 256 : 0) + col;  // P2, P4: Wi
  float acc = 0.f;
  for (int k = 0; k < chunks; ++k) {
    acc = __fadd_rn(acc, part[static_cast<int64_t>(k) * kM * kC + m * kC + c]);
  }
  panels[o] = (p == 1 || p == 3) ? -acc : acc;
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

// Rows of 128 per chunk of the panel products (the partial sums' grain).
extern "C" int qpsk_panel_chunk_rows() { return 4096; }

// C entry for ctypes: the correlation panels.  xr/xi [n], part [chunks x
// 256 x 512] scratch with chunks = ceil(ceil((n - hw) / 128) / 4096),
// panels [4 x 128 x (128 + 2hw)].  0 < hw <= 64.  Two launches on
// `stream`; returns cudaGetLastError().
extern "C" int qpsk_panels_launch(const void* xr, const void* xi, int64_t n,
                                  int hw, void* part, int chunks,
                                  void* panels, void* stream) {
  const int chunk_rows = qpsk_panel_chunk_rows();
  const int64_t K = n - hw;
  const int64_t R = (K + 127) / 128;
  if (hw <= 0 || hw > 64 || K <= 0 || chunks < 1 ||
      static_cast<int64_t>(chunks) * chunk_rows < R ||
      static_cast<int64_t>(chunks - 1) * chunk_rows >= R) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int width = 128 + 2 * hw;
  const int col_tiles = (width + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  qpsk_panel_partial_kernel<<<dim3(4 * 2 * col_tiles, chunks),
                              kPanelThreads, 0, s>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi), n, hw, K,
      R, chunk_rows, col_tiles, static_cast<float*>(part));
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t total = 4LL * 128 * width;
  qpsk_panel_reduce_kernel<<<static_cast<unsigned>((total + 255) / 256), 256,
                             0, s>>>(static_cast<const float*>(part), chunks,
                                     width, static_cast<float*>(panels));
  return static_cast<int>(cudaGetLastError());
}
