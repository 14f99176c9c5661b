// Welch accumulation over segments of float32 re/im planes, for Hopper
// (sm_90a).  Replaces the two PSD entries of the TPU kernel
// comms_tpu/kernels/fft_pallas.py: psd_pallas_planar (explicit segment
// rows, optional row weights) and psd_stream_pallas_planar (50%-overlap
// segments of a flat stream); comms_tpu_torch/kernels/fft.py holds the
// wrappers, the plain versions and the run partition (psd_partition).
//
//   acc[k] = sum_r | sum_t (w_r x[r, t] - m_r) win[t] e^{-2 pi i t k / n} |^2
//
// with segment r at x + r * row_stride (row_stride = n for segment rows,
// n / 2 for the stream), w_r the row weight (1 without weights) and m_r
// the mean of w_r x[r, :] when demeaning (0 otherwise); n = 256..16384.
//
// Bound on the H100: the stream entry reads each sample once (8 bytes)
// and does two n-point FFTs per sample (about 5 log2(n) + 10 flops per
// transformed point), so device memory bounds it (0.04 ms for 16,777,216
// samples at 3.35 TB/s; the FFTs are about 2 GFLOP at n = 1024, 0.03 ms
// at the CUDA cores' float32 rate).
//
// Design.  Every transform runs in registers on the register FFT of
// fft_reg.cuh with K6's twiddles (kPowers: one table entry a butterfly,
// its powers by running products): T = n / 16 threads a segment, thread
// t holding the points t + T q (q < 16), in blocks of max(128, T)
// threads, so G = max(128, T) / T segment groups a block.  Each group
// walks a run of `per_run` consecutive segments (the partition depends
// only on rows and n, never on the card: kernels/fft.psd_partition):
// - Loads go straight from the planes into registers.  At row stride
//   n / 2 (the stream entry, and the rows entry on unfold's 50%-overlap
//   views) points q + 8 of segment s are points q of segment s + 1, so a
//   thread keeps the raw upper half in registers and loads only the 8 new
//   points a plane for each later segment of its run: each sample is read
//   from device memory once, with no shared memory for the overlap.  Any
//   other stride loads all 16, and so does 16384 points, where the carry's
//   16 registers spill (the second read of a sample then hits L1).
// - Row weight and mean act on the raw values per segment, so the carried
//   half stays raw.  The mean is summed in a fixed order (each thread's 16
//   points in order, an xor-shuffle tree in the warp, the group's warps in
//   order through shared memory), subtracted before the window and the
//   FFT: subtracting m FFT(win) after the transform would cancel at bins
//   0 and +-1 when the mean is large.
// - |X|^2 adds into 16 sums a thread (bins t + T q) across the run, in
//   registers, or in the thread's own shared-memory slots where a block of
//   1024 threads (16384 points) leaves 64 registers.  At the run's end
//   the block's groups add their sums in group order into one partial row
//   per block, and psd_reduce_kernel adds the partial rows bin by bin in
//   a fixed order.  No float atomics: two calls give bit-identical sums,
//   and the two entries, one kernel on one partition, give the same bits
//   on the same segments.
// - Up to 8192 points a thread may take 128 registers (16 warps an SM):
//   at 64 registers (32 warps) the kernel ran no faster, since the
//   instructions of its loop (about 1,200 a segment at 1024 points), not
//   latency, bound it.
// The TPU kernel's Z-order accumulator, its DMA ring over 8-row halos and
// its zero-weighted final odd segment are not carried over: the stream
// entry runs its 2N/n - 1 segments as rows at stride n / 2.

#include <cuda_runtime.h>
#include <stdint.h>

#include "fft_reg.cuh"

namespace {

using fft_reg_detail::kPoints;
using fft_reg_detail::pad;

constexpr int kHalf = kPoints / 2;
constexpr int kMinThreads = 128;        // kernels/fft._PSD_MIN_THREADS
constexpr int kRegs = 128;              // register cap a thread, at most
constexpr bool kCarry = true;
constexpr int kWindowRegsUpTo = 1024;   // window in registers up to n
constexpr int kReduceGroups = 32;

__host__ __device__ constexpr int block_threads(int n) {
  return n / kPoints > kMinThreads ? n / kPoints : kMinThreads;
}

__host__ __device__ constexpr int groups(int n) {
  return block_threads(n) / (n / kPoints);
}

// Registers a thread at kRegs or what one block of the size leaves.
__host__ __device__ constexpr int reg_cap(int n) {
  return 65536 / block_threads(n) < kRegs ? 65536 / block_threads(n)
                                          : kRegs;
}

__host__ __device__ constexpr int min_blocks(int n) {
  return 65536 / (block_threads(n) * reg_cap(n));
}

// At 64 registers the sums live in shared memory, the window is read
// through L1 and nothing is carried.
__host__ __device__ constexpr bool smem_sums(int n) {
  return reg_cap(n) <= 64;
}

__host__ __device__ constexpr int smem_bytes(int n) {
  return static_cast<int>(sizeof(float2)) * groups(n) * pad(n) +
         static_cast<int>(sizeof(float)) *
             (2 * (block_threads(n) / 32) +
              (smem_sums(n) ? kPoints * block_threads(n) : 0));
}

struct PsdArgs {
  const float* xr;
  const float* xi;
  int64_t rows;
  int64_t row_stride;
  const float* win;
  const float* row_w;
  int demean;
  const float2* tw;
  int per_run;
  float* part;
};

template <int N>
__global__ void __launch_bounds__(block_threads(N), min_blocks(N))
    psd_partial_kernel(const PsdArgs p) {
  constexpr int THREADS = block_threads(N);
  constexpr int T = N / kPoints;              // threads a segment
  constexpr int G = THREADS / T;              // segment groups a block
  constexpr int WARPS = THREADS / 32;
  constexpr int W = T / 32;                   // warps a segment, if >= 1
  constexpr int LANES = T < 32 ? T : 32;      // lanes a segment in a warp
  constexpr int LD = pad(N);                  // float2 between regions
  constexpr bool kSmemSums = smem_sums(N);
  // Above 1024 points the window's 16 registers would spill: it is read
  // through L1 there.
  constexpr bool kWinRegs = N <= kWindowRegsUpTo && !kSmemSums;
  extern __shared__ float2 smem[];
  float* red = reinterpret_cast<float*>(smem + G * LD);   // [2][WARPS]
  float* sums = red + 2 * WARPS;              // [16][THREADS], kSmemSums
  const int t = threadIdx.x % T;
  const int g = threadIdx.x / T;
  const int64_t s0 =
      (static_cast<int64_t>(blockIdx.x) * G + g) * p.per_run;
  const bool carry = kCarry && !kSmemSums && 2 * p.row_stride == N;

  float wv[kWinRegs ? kPoints : 1];
  if constexpr (kWinRegs) {
#pragma unroll
    for (int q = 0; q < kPoints; ++q) wv[q] = __ldg(p.win + t + T * q);
  }
  float acc[kSmemSums ? 1 : kPoints];
#pragma unroll
  for (int q = 0; q < kPoints; ++q) {
    if constexpr (kSmemSums) {
      sums[threadIdx.x + THREADS * q] = 0.f;
    } else {
      acc[q] = 0.f;
    }
  }
  // vr/vi: this segment's raw points; cr/ci: its raw upper half, the next
  // segment's lower half.
  float vr[kPoints], vi[kPoints];
  float cr[kHalf], ci[kHalf];
  for (int i = 0; i < p.per_run; ++i) {
    const int64_t s = s0 + i;
    const bool ok = s < p.rows;
    const float* a = p.xr + s * p.row_stride + t;
    const float* b = p.xi + s * p.row_stride + t;
    if (carry && i > 0) {
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        vr[q] = cr[q];
        vi[q] = ci[q];
        vr[q + kHalf] = ok ? __ldg(a + T * (q + kHalf)) : 0.f;
        vi[q + kHalf] = ok ? __ldg(b + T * (q + kHalf)) : 0.f;
      }
    } else {
#pragma unroll
      for (int q = 0; q < kPoints; ++q) {
        vr[q] = ok ? __ldg(a + T * q) : 0.f;
        vi[q] = ok ? __ldg(b + T * q) : 0.f;
      }
    }
    if (carry) {
#pragma unroll
      for (int q = 0; q < kHalf; ++q) {
        cr[q] = vr[q + kHalf];
        ci[q] = vi[q + kHalf];
      }
    }
    if (p.row_w) {
      const float w = ok ? __ldg(p.row_w + s) : 0.f;
#pragma unroll
      for (int q = 0; q < kPoints; ++q) {
        vr[q] *= w;
        vi[q] *= w;
      }
    }
    if (p.demean) {
      float sr = 0.f, si = 0.f;
#pragma unroll
      for (int q = 0; q < kPoints; ++q) {
        sr += vr[q];
        si += vi[q];
      }
      // an xor tree gives every lane the same bits (a + b == b + a)
#pragma unroll
      for (int o = LANES / 2; o > 0; o >>= 1) {
        sr += __shfl_xor_sync(0xffffffffu, sr, o);
        si += __shfl_xor_sync(0xffffffffu, si, o);
      }
      if constexpr (W > 1) {
        // red is written again only after this segment's exchange
        // barriers, so one barrier here suffices
        if ((threadIdx.x & 31) == 0) {
          red[threadIdx.x >> 5] = sr;
          red[WARPS + (threadIdx.x >> 5)] = si;
        }
        __syncthreads();
        sr = 0.f;
        si = 0.f;
#pragma unroll
        for (int k = 0; k < W; ++k) {
          sr += red[g * W + k];
          si += red[WARPS + g * W + k];
        }
      }
      const float mr = sr * (1.f / N), mi = si * (1.f / N);
#pragma unroll
      for (int q = 0; q < kPoints; ++q) {
        vr[q] -= mr;
        vi[q] -= mi;
      }
    }
#pragma unroll
    for (int q = 0; q < kPoints; ++q) {
      float w;
      if constexpr (kWinRegs) {
        w = wv[q];
      } else {
        w = __ldg(p.win + t + T * q);
      }
      vr[q] *= w;
      vi[q] *= w;
    }
    fft_reg<N, true>(vr, vi, t, smem + g * LD, p.tw);
    if (ok) {
#pragma unroll
      for (int q = 0; q < kPoints; ++q) {
        const float e = vr[q] * vr[q] + vi[q] * vi[q];
        if constexpr (kSmemSums) {
          sums[threadIdx.x + THREADS * q] += e;
        } else {
          acc[q] += e;
        }
      }
    }
  }
  // The groups' sums -> one partial row, bin by bin in group order.  The
  // last exchange ended in a barrier, so each group's region is free.
  const auto total = [&](int q) {
    if constexpr (kSmemSums) {
      return sums[threadIdx.x + THREADS * q];
    } else {
      return acc[q];
    }
  };
  float* out = p.part + static_cast<int64_t>(blockIdx.x) * N;
  if constexpr (G == 1) {
#pragma unroll
    for (int q = 0; q < kPoints; ++q) out[t + T * q] = total(q);
  } else {
    float* own = reinterpret_cast<float*>(smem + g * LD);
#pragma unroll
    for (int q = 0; q < kPoints; ++q) own[t + T * q] = total(q);
    __syncthreads();
    for (int c = threadIdx.x; c < N; c += THREADS) {
      float v = 0.f;
#pragma unroll
      for (int k = 0; k < G; ++k) {
        v += reinterpret_cast<const float*>(smem + k * LD)[c];
      }
      out[c] = v;
    }
  }
}

// out[c] = sum over the P partial rows of part[:, c]: kReduceGroups
// threads per bin each add a fixed contiguous range of rows in order,
// then the first adds the groups' sums in order.
__global__ void __launch_bounds__(32 * kReduceGroups)
    psd_reduce_kernel(const float* __restrict__ part, int P, int n,
                      float* __restrict__ out) {
  __shared__ float red[kReduceGroups][33];
  const int c = blockIdx.x * 32 + threadIdx.x;
  const int per = (P + kReduceGroups - 1) / kReduceGroups;
  const int g0 = threadIdx.y * per;
  const int g1 = g0 + per < P ? g0 + per : P;
  float s = 0.f;
#pragma unroll 8
  for (int g = g0; g < g1; ++g) s += part[static_cast<int64_t>(g) * n + c];
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0) {
    float v = 0.f;
#pragma unroll
    for (int y = 0; y < kReduceGroups; ++y) v += red[y][threadIdx.x];
    out[c] = v;
  }
}

template <int N>
int launch(const PsdArgs& a, int blocks, float* out, cudaStream_t s) {
  constexpr int smem = smem_bytes(N);
  cudaError_t err = cudaFuncSetAttribute(
      psd_partial_kernel<N>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t runs = (a.rows + a.per_run - 1) / a.per_run;
  if (blocks != (runs + groups(N) - 1) / groups(N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  psd_partial_kernel<N><<<blocks, block_threads(N), smem, s>>>(a);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  psd_reduce_kernel<<<N / 32, dim3(32, kReduceGroups), 0, s>>>(
      a.part, blocks, N, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// C entry for ctypes.  Pointers on the current device: xr/xi hold `rows`
// segments of n samples, segment r at r * row_stride floats (unit sample
// stride; segments may overlap); win [n]; row_w [rows] or null; tw the
// n-entry table W_n^k as (re, im) pairs; part [blocks, n] scratch; out
// [n].  per_run segments a run and blocks = ceil(ceil(rows / per_run) /
// G), G = max(128, n / 16) / (n / 16) runs a block, as
// kernels/fft.psd_partition picks them.  n a power of two in 256..16384.
// Launches on `stream` without synchronising; returns cudaGetLastError()
// (or the error that stopped the launch).
extern "C" int psd_launch(const void* xr, const void* xi, int64_t rows,
                          int64_t row_stride, int n, const void* win,
                          const void* row_w, int demean, const void* tw,
                          int per_run, void* part, int blocks, void* out,
                          void* stream) {
  if (rows < 1 || row_stride < 1 || per_run < 1 || blocks < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const PsdArgs a{static_cast<const float*>(xr),
                  static_cast<const float*>(xi),
                  rows,
                  row_stride,
                  static_cast<const float*>(win),
                  static_cast<const float*>(row_w),
                  demean,
                  static_cast<const float2*>(tw),
                  per_run,
                  static_cast<float*>(part)};
  auto* o = static_cast<float*>(out);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (n) {
    case 256: return launch<256>(a, blocks, o, s);
    case 512: return launch<512>(a, blocks, o, s);
    case 1024: return launch<1024>(a, blocks, o, s);
    case 2048: return launch<2048>(a, blocks, o, s);
    case 4096: return launch<4096>(a, blocks, o, s);
    case 8192: return launch<8192>(a, blocks, o, s);
    case 16384: return launch<16384>(a, blocks, o, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
