// The receive chain's two sequential loops, for Hopper (sm_90a): the
// decision-directed Costas loop (comms_tpu/ops/demodulation.py::
// costas_loop_block) and the per-sample log-domain AGC (comms_tpu/ops/
// agc.py::agc_scan).  Neither replaces a Pallas kernel: in the JAX package
// both are lax.scan loops, whose carried value feeds the next step through
// a nonlinear function, so they have no parallel form.  Run as PyTorch
// operations on 0-d tensors, each step would cost about ten launches;
// here one launch walks the whole block.
// comms_tpu_torch/kernels/recurrence.py holds the wrappers and the plain
// versions.
//
// Costas loop of order M, per symbol s (complex, float32 throughout):
//   c   = s * e^{-j ph}
//   err = atan2(Im, Re)(-c^M) / M,   c^M by XLA's integer_pow (binary
//                                    powers: c^4 = (c*c)*(c*c))
//   fr  = fr + beta*err
//   ph  = (ph + fr) + alpha*err      (ph is never wrapped, as in JAX)
//   out = c
// AGC, per sample s, gain g:
//   y   = s * g
//   err = log(target / (|y| + 1e-12))
//   g   = g * exp(rate*err)
//   out = y
//
// Every product and sum is rounded as written (__fmul_rn/__fadd_rn/
// __fsub_rn/__fdiv_rn: no FMA contraction), the complex products in XLA's
// order (ar*br - ai*bi, ar*bi + ai*br), and sincosf, atan2f, hypotf, logf
// and expf are CUDA's accurate ones (no --use_fast_math), so the plain
// versions, one PyTorch operation a step, compute the same values.
//
// Bound on the H100: neither bytes (16 bytes a step) nor operations
// (~50 a step), but the latency of the dependent chain.  Each step needs
// the previous step's state before it can start: for the Costas loop
// sincosf of ph, the rotation, two complex squares (order 4), atan2f and
// the two updates, about 215 dependent cycles (an estimate: ~80 for
// sincosf's reduction and polynomials, ~90 for atan2f's division and
// polynomial, ~45 for the ten multiply-adds), ~110 ns a symbol at 1.98
// GHz; for the
// AGC hypotf, a division, logf and expf, about 150 cycles, ~75 ns a
// sample.  Design: one thread walks the block (a second thread would only
// wait on the first); its loads are off the dependent chain, issued
// kChunk steps ahead into registers (fully unrolled, so the arrays stay
// in registers) while the chain runs on the previous chunk; stores are
// fire-and-forget.  The carried state is read from and written to device
// memory, so a call never synchronises with the host.  Inputs and outputs
// are planes with an element stride (1 for planes, 2 for the re/im views
// of a complex tensor).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChunk = 16;   // loads in flight ahead of the chain

// (ar + j ai) * (br + j bi) in XLA's order, each step rounded.
__device__ __forceinline__ void cmul(float ar, float ai, float br, float bi,
                                     float& cr, float& ci) {
  cr = __fsub_rn(__fmul_rn(ar, br), __fmul_rn(ai, bi));
  ci = __fadd_rn(__fmul_rn(ar, bi), __fmul_rn(ai, br));
}

// x^m, m >= 1, as XLA's integer_pow expands it: acc takes x at each set
// bit of m (acc * x), x squares between bits.
__device__ __forceinline__ void cpow(float xr, float xi, int m, float& yr,
                                     float& yi) {
  bool have = false;
  while (m > 0) {
    if (m & 1) {
      if (have) {
        cmul(yr, yi, xr, xi, yr, yi);
      } else {
        yr = xr;
        yi = xi;
        have = true;
      }
    }
    m >>= 1;
    if (m > 0) cmul(xr, xi, xr, xi, xr, xi);
  }
}

__device__ __forceinline__ void load_chunk(const float* __restrict__ xr,
                                           const float* __restrict__ xi,
                                           int64_t xs, int64_t n,
                                           int64_t base, float (&r)[kChunk],
                                           float (&i)[kChunk]) {
#pragma unroll
  for (int j = 0; j < kChunk; ++j) {
    const int64_t k = base + j;
    r[j] = k < n ? xr[k * xs] : 0.f;
    i[j] = k < n ? xi[k * xs] : 0.f;
  }
}

// kOrder > 0: the order is known at compile time (4, QPSK: the power is
// two squarings, unrolled, and the division by the order a product by
// its exact reciprocal, which rounds identically); kOrder == 0: any
// order, from ``order``.
template <int kOrder>
__global__ void __launch_bounds__(1)
    costas_loop_kernel(const float* __restrict__ xr,
                       const float* __restrict__ xi, int64_t xs, int64_t n,
                       const float* __restrict__ ph_in,
                       const float* __restrict__ fr_in, int order,
                       float alpha, float beta, float* __restrict__ yr,
                       float* __restrict__ yi, int64_t ys,
                       float* __restrict__ ph_out,
                       float* __restrict__ fr_out) {
  float ph = *ph_in;
  float fr = *fr_in;
  float cr[kChunk], ci[kChunk], nr[kChunk], ni[kChunk];
  load_chunk(xr, xi, xs, n, 0, cr, ci);
  for (int64_t base = 0; base < n; base += kChunk) {
    load_chunk(xr, xi, xs, n, base + kChunk, nr, ni);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int64_t k = base + j;
      if (k < n) {
        float s, c;
        sincosf(ph, &s, &c);
        // (sr + j si) * (c - j s)
        const float ar =
            __fadd_rn(__fmul_rn(cr[j], c), __fmul_rn(ci[j], s));
        const float ai =
            __fsub_rn(__fmul_rn(ci[j], c), __fmul_rn(cr[j], s));
        float qr, qi;
        cpow(ar, ai, kOrder > 0 ? kOrder : order, qr, qi);
        const float a = atan2f(-qi, -qr);
        const float err =
            kOrder == 4 ? __fmul_rn(a, 0.25f)
                        : __fdiv_rn(a, static_cast<float>(order));
        fr = __fadd_rn(fr, __fmul_rn(beta, err));
        ph = __fadd_rn(__fadd_rn(ph, fr), __fmul_rn(alpha, err));
        yr[k * ys] = ar;
        yi[k * ys] = ai;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      cr[j] = nr[j];
      ci[j] = ni[j];
    }
  }
  *ph_out = ph;
  *fr_out = fr;
}

__global__ void __launch_bounds__(1)
    agc_scan_kernel(const float* __restrict__ xr,
                    const float* __restrict__ xi, int64_t xs, int64_t n,
                    const float* __restrict__ g_in, float target, float rate,
                    float* __restrict__ yr, float* __restrict__ yi,
                    int64_t ys, float* __restrict__ g_out) {
  float g = *g_in;
  float cr[kChunk], ci[kChunk], nr[kChunk], ni[kChunk];
  load_chunk(xr, xi, xs, n, 0, cr, ci);
  for (int64_t base = 0; base < n; base += kChunk) {
    load_chunk(xr, xi, xs, n, base + kChunk, nr, ni);
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      const int64_t k = base + j;
      if (k < n) {
        const float ar = __fmul_rn(cr[j], g);
        const float ai = __fmul_rn(ci[j], g);
        const float mag = __fadd_rn(hypotf(ar, ai), 1e-12f);
        const float err = logf(__fdiv_rn(target, mag));
        g = __fmul_rn(g, expf(__fmul_rn(rate, err)));
        yr[k * ys] = ar;
        yi[k * ys] = ai;
      }
    }
#pragma unroll
    for (int j = 0; j < kChunk; ++j) {
      cr[j] = nr[j];
      ci[j] = ni[j];
    }
  }
  *g_out = g;
}

}  // namespace

extern "C" int costas_loop_launch(const void* xr, const void* xi,
                                  int64_t in_stride, int64_t n,
                                  const void* ph_in, const void* fr_in,
                                  int order, float alpha, float beta,
                                  void* yr, void* yi,
                                  int64_t out_stride, void* ph_out,
                                  void* fr_out, void* stream) {
  if (n < 0 || in_stride < 1 || out_stride < 1 || order < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  auto kernel = order == 4 ? costas_loop_kernel<4> : costas_loop_kernel<0>;
  kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi), in_stride,
      n, static_cast<const float*>(ph_in), static_cast<const float*>(fr_in),
      order, alpha, beta, static_cast<float*>(yr), static_cast<float*>(yi),
      out_stride, static_cast<float*>(ph_out), static_cast<float*>(fr_out));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int agc_scan_launch(const void* xr, const void* xi,
                               int64_t in_stride, int64_t n, const void* g_in,
                               float target, float rate, void* yr, void* yi,
                               int64_t out_stride, void* g_out, void* stream) {
  if (n < 0 || in_stride < 1 || out_stride < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  agc_scan_kernel<<<1, 1, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xr), static_cast<const float*>(xi), in_stride,
      n, static_cast<const float*>(g_in), target, rate,
      static_cast<float*>(yr), static_cast<float*>(yi), out_stride,
      static_cast<float*>(g_out));
  return static_cast<int>(cudaGetLastError());
}
