// Polynomial atan2 shared by the FM kernels (fm_chain.cu, band_monitor.cu).
//
// Octant-reduced degree-15 odd polynomial, the coefficients and branches
// of comms_tpu/kernels/fm_chain_pallas.py::_atan2 (8.8e-8 rad).  The
// sign-bit tests keep atan2(+-0, -0) = +-pi, which the FM demodulators
// reach at stream start, where the previous sample is zero.  Built
// without --use_fast_math: r = num / (den + 1e-30f) is IEEE-rounded and
// denormals are kept.

#pragma once

#include <cuda_runtime.h>

static __device__ __forceinline__ float atan2_poly(float y, float x) {
  const float ax = fabsf(x);
  const float ay = fabsf(y);
  const bool swap = ay > ax;
  const float num = fminf(ax, ay);
  const float den = fmaxf(ax, ay);
  const float r = num / (den + 1e-30f);
  const float r2 = r * r;
  float p = -4.831168387e-03f;
  p = p * r2 + 2.475678069e-02f;
  p = p * r2 + -6.021912799e-02f;
  p = p * r2 + 9.967923619e-02f;
  p = p * r2 + -1.404013889e-01f;
  p = p * r2 + 1.997368136e-01f;
  p = p * r2 + -3.333230283e-01f;
  p = p * r2 + 9.999999582e-01f;
  float a = p * r;
  if (swap) a = 1.57079632679489661923f - a;
  if (__float_as_int(x) < 0) a = 3.14159265358979323846f - a;
  if (__float_as_int(y) < 0) a = -a;
  return a;
}
