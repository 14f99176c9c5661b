// The ring halo exchange of the sharded layer, for Hopper (sm_90a).
// Replaces the TPU kernel comms_tpu/kernels/halo_rdma.py::ring_halo_exchange;
// comms_tpu_torch/kernels/halo_ring.py holds the wrapper and the plain
// version.
//
// On the TPU each rank signals its left neighbour on a barrier semaphore,
// then RDMAs its last `halo` samples into its right neighbour's halo
// buffer in VMEM (rank 0 receives rank n-1's tail: the ring wraps).  The
// barrier is there only because a remote write lands in another chip's
// live buffer.  Here every shard of the ring lies on one card: the
// exchange is one launch that copies P (src, dst) byte ranges of `nbytes`
// each, the wrapper having built the pairs (the wrapped ring, the ring
// with the carried context as the first shard's source, one ring per
// group along an axis of a 2-D mesh, several planes in the same launch).
// One launch on the current stream replaces the barrier: stream order
// already puts every producer of a source before it, no other card takes
// part, and every destination is a fresh buffer that aliases no source.
//
// Bound on the H100: it moves 2 * P * nbytes through device memory
// (3.35 TB/s).  At the sharded paths' halos (tens of bytes to 2 x 25,669
// bytes a shard) that is well under a microsecond, so the launch latency
// bounds it.  Design: the pointers travel by value in the kernel's
// parameter block (up to 128 pairs, ~2 KB of the 4 KB limit; read through
// __grid_constant__, so no local copy is made), so a call needs no device
// pointer table and no host-to-device copy.  blockIdx.y picks the pair,
// blocks along x stride over its bytes; 16-byte vector copies when every
// pointer and nbytes are 16-byte aligned, 4-byte words when they are
// 4-byte aligned (tail views of float32 tensors often are only that),
// single bytes otherwise.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxPairs = 128;
constexpr int kThreads = 256;
constexpr int kMaxBlocksX = 1024;

struct HaloPair {
  const void* src;
  void* dst;
};

struct HaloParams {
  HaloPair pair[kMaxPairs];
};

template <typename T>
__global__ void __launch_bounds__(kThreads)
    halo_ring_kernel(const __grid_constant__ HaloParams p, long long n) {
  const HaloPair pr = p.pair[blockIdx.y];
  const T* __restrict__ src = static_cast<const T*>(pr.src);
  T* __restrict__ dst = static_cast<T*>(pr.dst);
  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  for (long long i = static_cast<long long>(blockIdx.x) * kThreads +
                     threadIdx.x;
       i < n; i += stride) {
    dst[i] = src[i];
  }
}

template <typename T>
cudaError_t launch(const HaloParams& p, int npairs, long long nbytes,
                   cudaStream_t stream) {
  const long long n = nbytes / static_cast<long long>(sizeof(T));
  long long bx = (n + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(npairs));
  halo_ring_kernel<T><<<grid, kThreads, 0, stream>>>(p, n);
  return cudaGetLastError();
}

}  // namespace

extern "C" int halo_ring_max_pairs() { return kMaxPairs; }

// C entry for ctypes.  srcs[i], dsts[i] (host arrays of npairs device
// pointers, 1 <= npairs <= 128) name byte ranges of `nbytes` each on the
// current device; no destination overlaps a source.  Launches one copy
// kernel on `stream` without synchronising; returns cudaGetLastError().
extern "C" int halo_ring_launch(const void* const* srcs,
                                void* const* dsts, int npairs,
                                long long nbytes, void* stream) {
  if (npairs < 1 || npairs > kMaxPairs || nbytes < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  HaloParams p;
  uintptr_t bits = static_cast<uintptr_t>(nbytes);
  for (int i = 0; i < npairs; ++i) {
    p.pair[i].src = srcs[i];
    p.pair[i].dst = dsts[i];
    bits |= reinterpret_cast<uintptr_t>(srcs[i]) |
            reinterpret_cast<uintptr_t>(dsts[i]);
  }
  for (int i = npairs; i < kMaxPairs; ++i) {
    p.pair[i].src = nullptr;
    p.pair[i].dst = nullptr;
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if ((bits & 15u) == 0) {
    err = launch<uint4>(p, npairs, nbytes, s);
  } else if ((bits & 3u) == 0) {
    err = launch<uint32_t>(p, npairs, nbytes, s);
  } else {
    err = launch<uint8_t>(p, npairs, nbytes, s);
  }
  return static_cast<int>(err);
}
