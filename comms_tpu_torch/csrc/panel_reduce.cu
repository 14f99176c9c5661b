// The panel-side reductions of the QPSK estimate chain, for Hopper
// (sm_90a).  Replaces the TPU kernel
// comms_tpu/kernels/panel_reduce_pallas.py::panel_reductions;
// comms_tpu_torch/kernels/panel_reduce.py holds the wrapper and the plain
// version.  From the symbol kernel's two [256, 256] panel accumulators
// (p13 = [P1; P3], p24 = [-P2; -P4], columns the lag windows) it writes a
// [16, 128] float32 block:
//
//   row 0/1, lane v (v <= 2hw): gr[v], gi[v] = sum_j E[j, j + v], the
//            r2-rotated lag sums of TimingEstimator.lag_sums_r2, where
//            E = (Er, Ei) folds c2/s2 = cos/sin(2 pi (j mod sps) / sps);
//   row 8+a, lane v (a < sps): the same sum over rows j = a (mod sps)
//            of Er;
//   row 2, lane 0: atan2 of the v = -1 lag sum (gi, gr at v = hw - 1), by
//            the FM kernels' polynomial atan2 (atan2_poly.cuh, the
//            polynomial of fm_chain_pallas._atan2, which K11 imports);
//   every other entry 0 (the TPU kernel leaves them unwritten).
//
// Bound on the H100: it reads 512 KB and does ~(2hw+1)*128*12 flops, a
// few microseconds at any layout; the launch costs more.  One block of
// 128 threads: thread v walks the 128 rows of its diagonal in order (no
// atomics, deterministic), so the three sums of a lag share one pass.
// The TPU kernel's iota shear masks over the whole [128, 256] panel per
// lag (needed there because Mosaic has no gather) are not carried over.
// hw <= 63: at hw = 64 the TPU kernel's 128 lanes drop the v = +hw lag.

#include <cuda_runtime.h>
#include <stdint.h>

#include "atan2_poly.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kOutRows = 16;

__global__ void panel_reduce_kernel(const float* __restrict__ p13,
                                    const float* __restrict__ p24, int hw,
                                    int sps, float* __restrict__ out) {
  const int v = threadIdx.x;
  for (int r = 0; r < kOutRows; ++r) out[r * kLanes + v] = 0.f;
  __syncthreads();
  if (v > 2 * hw) return;
  const float dphi = static_cast<float>(2.0 * 3.14159265358979323846 / sps);
  float gr = 0.f, gi = 0.f;
  float ga[8];
#pragma unroll
  for (int a = 0; a < 8; ++a) ga[a] = 0.f;
  for (int j = 0; j < kLanes; ++j) {
    const int c = j + v;                      // <= 127 + 126 < 256
    const int a = j % sps;
    float s2, c2;
    sincosf(__fmul_rn(static_cast<float>(a), dphi), &s2, &c2);
    const float P1 = p13[j * 256 + c];
    const float P3 = p13[(kLanes + j) * 256 + c];
    const float P2 = -p24[j * 256 + c];
    const float P4 = -p24[(kLanes + j) * 256 + c];
    const float er = (c2 * P1 + s2 * P3) - (c2 * P4 - s2 * P2);
    const float ei = (c2 * P2 + s2 * P4) + (c2 * P3 - s2 * P1);
    gr += er;
    gi += ei;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      if (b == a) ga[b] += er;
    }
  }
  out[0 * kLanes + v] = gr;
  out[1 * kLanes + v] = gi;
  for (int a = 0; a < sps; ++a) out[(8 + a) * kLanes + v] = ga[a];
  if (v == hw - 1) out[2 * kLanes] = atan2_poly(gi, gr);
}

}  // namespace

// C entry for ctypes.  p13/p24 [256 x 256] and out [16 x 128] float32 on
// the current device; 0 < hw <= 63, 1 <= sps <= 8.  Launches on `stream`
// without synchronising; returns cudaGetLastError().
extern "C" int panel_reduce_launch(const void* p13, const void* p24, int hw,
                                   int sps, void* out, void* stream) {
  if (hw <= 0 || hw > 63 || sps < 1 || sps > 8) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  panel_reduce_kernel<<<1, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p13), static_cast<const float*>(p24), hw, sps,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
