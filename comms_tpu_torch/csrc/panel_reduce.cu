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
// Bound on the H100: it reads at most 128 * (2hw+1) * 4 panel entries
// (~211 KB at hw = 51) and does ~(2hw+1)*128*12 flops, well under a
// microsecond at any layout; the launch costs more.  Design: one block of
// kGroups * 128 threads, thread (g, v) summing lag v over the kGroupRows
// rows of row group g, its loads issued kBatch rows at a time before the
// arithmetic; c2/s2 once per residue a < sps (the same sincosf of the
// same float angle as a per-row evaluation) in shared memory; the
// groups' partial sums combined in shared memory in group order (no
// atomics: repeated calls give the same bits); every output entry
// written once, zeros included.  The TPU kernel's iota shear masks over
// the whole [128, 256] panel per lag (needed there because Mosaic has no
// gather) are not carried over.  hw <= 63: at hw = 64 the TPU kernel's
// 128 lanes drop the v = +hw lag.

#include <cuda_runtime.h>
#include <stdint.h>

#include "atan2_poly.cuh"

namespace {

constexpr int kLanes = 128;
constexpr int kOutRows = 16;
constexpr int kRows = 128;                      // panel rows j
constexpr int kGroups = 8;                      // row groups
constexpr int kGroupRows = kRows / kGroups;
constexpr int kBatch = 8;                       // rows of loads in flight
constexpr int kThreads = kGroups * kLanes;
constexpr int kSums = 2 + 8;                    // gr, gi, one per residue

__global__ void __launch_bounds__(kThreads)
    panel_reduce_kernel(const float* __restrict__ p13,
                        const float* __restrict__ p24, int hw, int sps,
                        float* __restrict__ out) {
  __shared__ float cs[2][8];
  __shared__ float part[kGroups][kSums][kLanes];
  const int t = threadIdx.x;
  const int v = t % kLanes;
  const int g = t / kLanes;
  if (t < sps) {
    const float dphi = static_cast<float>(2.0 * 3.14159265358979323846 / sps);
    float s2, c2;
    sincosf(__fmul_rn(static_cast<float>(t), dphi), &s2, &c2);
    cs[0][t] = c2;
    cs[1][t] = s2;
  }
  __syncthreads();
  if (v <= 2 * hw) {
    float gr = 0.f, gi = 0.f;
    float ga[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) ga[b] = 0.f;
    int a = (g * kGroupRows) % sps;
#pragma unroll
    for (int i0 = 0; i0 < kGroupRows; i0 += kBatch) {
      float P1[kBatch], P2[kBatch], P3[kBatch], P4[kBatch];
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const int j = g * kGroupRows + i0 + i;
        const int c = j + v;                    // <= 127 + 126 < 256
        P1[i] = p13[j * 256 + c];
        P3[i] = p13[(kLanes + j) * 256 + c];
        P2[i] = -p24[j * 256 + c];
        P4[i] = -p24[(kLanes + j) * 256 + c];
      }
#pragma unroll
      for (int i = 0; i < kBatch; ++i) {
        const float c2 = cs[0][a], s2 = cs[1][a];
        const float er = (c2 * P1[i] + s2 * P3[i]) - (c2 * P4[i] - s2 * P2[i]);
        const float ei = (c2 * P2[i] + s2 * P4[i]) + (c2 * P3[i] - s2 * P1[i]);
        gr += er;
        gi += ei;
#pragma unroll
        for (int b = 0; b < 8; ++b) {
          if (b == a) ga[b] += er;
        }
        a = a + 1 == sps ? 0 : a + 1;
      }
    }
    part[g][0][v] = gr;
    part[g][1][v] = gi;
#pragma unroll
    for (int b = 0; b < 8; ++b) part[g][2 + b][v] = ga[b];
  }
  __syncthreads();
  // Every entry of out once: entry e = t + k * kThreads, row e / 128.
#pragma unroll
  for (int k = 0; k < kOutRows * kLanes / kThreads; ++k) {
    const int e = t + k * kThreads;
    const int row = e / kLanes, lane = e % kLanes;
    int s = -1;
    if (row == 0 || row == 1) s = row;
    if (row >= 8 && row - 8 < sps) s = 2 + row - 8;
    float val = 0.f;
    if (s >= 0 && lane <= 2 * hw) {
      for (int gg = 0; gg < kGroups; ++gg) val += part[gg][s][lane];
    }
    if (row == 2 && lane == 0) {
      float gr = 0.f, gi = 0.f;
      for (int gg = 0; gg < kGroups; ++gg) {
        gr += part[gg][0][hw - 1];
        gi += part[gg][1][hw - 1];
      }
      val = atan2_poly(gi, gr);
    }
    out[e] = val;
  }
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
  panel_reduce_kernel<<<1, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(p13), static_cast<const float*>(p24), hw, sps,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
