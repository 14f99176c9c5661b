// The ring halo exchange of the sharded layer, for Hopper (sm_90a).
// Replaces the TPU kernel comms_tpu/kernels/halo_rdma.py::ring_halo_exchange;
// comms_tpu_torch/kernels/halo_ring.py holds the wrapper and the plain
// version.
//
// On the TPU each rank signals its left neighbour on a barrier semaphore,
// then RDMAs its last `halo` samples into its right neighbour's halo
// buffer in VMEM (rank 0 receives rank n-1's tail: the ring wraps).  The
// barrier is there only because a remote write lands in another chip's
// live buffer.  Within one process every shard of the ring lies on one
// card: the exchange is one launch that copies P (src, dst) byte ranges
// of `nbytes` each, the wrapper having built the pairs (the wrapped ring,
// the ring with the carried context as the first shard's source, one ring
// per group along an axis of a 2-D mesh, several planes in the same
// launch).  One launch on the current stream replaces the barrier: stream
// order already puts every producer of a source before it, no other card
// takes part, and every destination is a fresh buffer that aliases no
// source.  Across processes (the entries at the end of this file) the
// same launch also carries the pairs whose destination is a window in
// another process's memory.
//
// Bound on the H100: it moves 2 * P * nbytes through device memory
// (3.35 TB/s).  At the sharded paths' halos (tens of bytes to 2 x 25,669
// bytes a shard) that is well under a microsecond, so the launch bounds
// it; a 1 MiB ring of 8 shards needs 5.0 us at 3.35 TB/s.  Design:
// - The pointers travel by value in the kernel's parameter block, read
//   through __grid_constant__ (no local copy, no device pointer table, no
//   host-to-device copy), in a block sized to the call: 16 pairs (264 B)
//   or 128 pairs (2,056 B).
// - Every pair takes one path: 16-byte words.  The wrapper hands out
//   destinations that start 16-byte aligned (rows of one buffer at a row
//   stride rounded up to 16 bytes).  A source may start at any byte: the
//   kernel reads the aligned 16-byte words that hold it, from the source
//   rounded down to 16 bytes, and assembles each output word from two
//   neighbouring input words: its 4-byte lanes picked by the offset's
//   word part, then funnel shifts by its byte part (the offset is uniform
//   across a pair; a source on a 16-byte boundary takes the plain word
//   copy).  One realigned path serves offsets 1..15: four instantiations,
//   one a word part, measured no faster (tools/k12_compare.py).  It never
//   reads past the last 16-byte word that holds a source byte, so a tail
//   at the end of its allocation is safe.  The last nbytes % 16 bytes are
//   written by narrow stores.
// - One wave: blockIdx.y picks the pair; the blocks along x are as many
//   as the pair's words need at kWords words a thread, but no more than
//   the SMs hold at once (from the occupancy query, once per device)
//   shared among the pairs; each thread issues its kWords loads before
//   its stores.

#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kSmallPairs = 16;
constexpr int kMaxPairs = 128;
constexpr int kThreads = 256;
constexpr int kWords = 2;        // 16-byte words a thread has in flight
constexpr int kMaxDevices = 64;

struct HaloPair {
  const void* src;
  void* dst;
};

template <int kCap>
struct HaloParams {
  HaloPair pair[kCap];
  int nbytes;
};

// Output word from input words a (holding the word's first source byte)
// and b (the next), the source 4 q + sh / 8 bytes past a's start: the
// 4-byte lanes q .. q + 4 of a:b picked by selects (q is uniform across a
// pair), then funnel-shifted right by sh bits.
__device__ __forceinline__ uint4 realign(const uint4& a, const uint4& b,
                                         unsigned q, unsigned sh) {
  const unsigned v[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
  unsigned s[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
    unsigned x = v[i];
    x = q >= 1 ? v[i + 1] : x;
    x = q >= 2 ? v[i + 2] : x;
    x = q >= 3 ? v[i + 3] : x;
    s[i] = x;
  }
  uint4 o;
  o.x = __funnelshift_r(s[0], s[1], sh);
  o.y = __funnelshift_r(s[1], s[2], sh);
  o.z = __funnelshift_r(s[2], s[3], sh);
  o.w = __funnelshift_r(s[3], s[4], sh);
  return o;
}

// The last word's first `rem` (1..15) bytes, by 4-byte and 1-byte stores
// (dst is 16-byte aligned).
__device__ __forceinline__ void store_head(uint4* dst, const uint4& o,
                                           int rem) {
  const unsigned v[4] = {o.x, o.y, o.z, o.w};
  unsigned* d32 = reinterpret_cast<unsigned*>(dst);
  unsigned char* d8 = reinterpret_cast<unsigned char*>(dst);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (4 * k + 4 <= rem) {
      d32[k] = v[k];
    } else {
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        if (4 * k + c < rem) d8[4 * k + c] = (v[k] >> (8 * c)) & 0xffu;
      }
    }
  }
}

// One pair's copy by this thread: words w0, w0 + stride, ... of the
// output; kAligned: the source is 16-byte aligned (base = src), else it
// starts 4 q + sh / 8 bytes past base.  last: the last input word that
// holds a source byte.  32-bit indices (nbytes < 2^31): at the sharded
// paths' halos the copy is a few instructions a thread, and 64-bit index
// arithmetic measured 0.1-0.2 us slower there (tools/k12_compare.py).
template <bool kAligned>
__device__ __forceinline__ void copy_pair(const uint4* __restrict__ base,
                                          uint4* __restrict__ dst,
                                          int nbytes, int last, unsigned q,
                                          unsigned sh, int w0, int stride) {
  const int nwords = (nbytes + 15) >> 4;
  for (int w = w0; w < nwords; w += kWords * stride) {
    uint4 a[kWords], b[kWords];
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int wj = w + j * stride;
      if (wj < nwords) {
        a[j] = __ldg(base + wj);
        if (!kAligned) {
          b[j] = wj + 1 <= last ? __ldg(base + wj + 1) : make_uint4(0, 0, 0, 0);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      const int wj = w + j * stride;
      if (wj < nwords) {
        uint4 o;
        if constexpr (kAligned) {
          o = a[j];
        } else {
          o = realign(a[j], b[j], q, sh);
        }
        const int rem = nbytes - 16 * wj;
        if (rem >= 16) {
          dst[wj] = o;
        } else {
          store_head(dst + wj, o, rem);
        }
      }
    }
  }
}

template <int kCap>
__global__ void __launch_bounds__(kThreads)
    halo_ring_kernel(const __grid_constant__ HaloParams<kCap> p) {
  const HaloPair pr = p.pair[blockIdx.y];
  const uintptr_t s = reinterpret_cast<uintptr_t>(pr.src);
  const unsigned off = static_cast<unsigned>(s & 15u);
  const uint4* base = reinterpret_cast<const uint4*>(s - off);
  uint4* dst = static_cast<uint4*>(pr.dst);
  const int nbytes = p.nbytes;
  const int last = static_cast<int>((off + nbytes - 1) >> 4);
  const int w0 = blockIdx.x * kThreads + threadIdx.x;
  const int stride = gridDim.x * kThreads;
  if (off == 0) {
    copy_pair<true>(base, dst, nbytes, last, 0, 0, w0, stride);
  } else {
    copy_pair<false>(base, dst, nbytes, last, off >> 2, 8u * (off & 3u), w0,
                     stride);
  }
}

// Blocks of kThreads that the card holds at once for this instantiation,
// from the occupancy query, once per device.
template <int kCap>
int resident_blocks() {
  static int cached[kMaxDevices] = {0};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices) {
    return 0;
  }
  if (cached[dev] == 0) {
    int per_sm = 0, sms = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &per_sm, halo_ring_kernel<kCap>, kThreads, 0) != cudaSuccess ||
        cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
            cudaSuccess) {
      return 0;
    }
    cached[dev] = per_sm * sms;
  }
  return cached[dev];
}

template <int kCap>
cudaError_t launch(const void* const* ptrs, int npairs, long long nbytes,
                   cudaStream_t stream) {
  HaloParams<kCap> p;
  for (int i = 0; i < npairs; ++i) {
    p.pair[i].src = ptrs[i];
    p.pair[i].dst = const_cast<void*>(ptrs[npairs + i]);
  }
  for (int i = npairs; i < kCap; ++i) {
    p.pair[i].src = nullptr;
    p.pair[i].dst = nullptr;
  }
  p.nbytes = static_cast<int>(nbytes);
  const int resident = resident_blocks<kCap>();
  if (resident <= 0) return cudaErrorInvalidDevice;
  const long long nwords = (nbytes + 15) >> 4;
  long long bx = (nwords + kThreads * kWords - 1) / (kThreads * kWords);
  const long long cap = resident / npairs > 0 ? resident / npairs : 1;
  if (bx > cap) bx = cap;
  const dim3 grid(static_cast<unsigned>(bx), static_cast<unsigned>(npairs));
  halo_ring_kernel<kCap><<<grid, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

// The launch floor: an empty kernel with a parameter block of K12's
// 128-pair size or of 16 bytes, for timing the launch alone.
struct FloorBig {
  unsigned char b[sizeof(HaloParams<kMaxPairs>)];
};
struct FloorSmall {
  long long a, b;
};

template <typename P>
__global__ void halo_ring_floor_kernel(const __grid_constant__ P p) {}

}  // namespace

extern "C" int halo_ring_max_pairs() { return kMaxPairs; }

// C entry for ctypes.  ptrs: a host array of 2 * npairs device pointers,
// the sources, then the destinations (1 <= npairs <= 128), naming byte
// ranges of `nbytes` each (1 <= nbytes < 2^31) on the current device; every
// destination starts 16-byte aligned and overlaps no source.  Launches one copy kernel on
// `stream` without synchronising; returns cudaGetLastError().
extern "C" int halo_ring_launch(const void* const* ptrs, int npairs,
                                long long nbytes, void* stream) {
  if (npairs < 1 || npairs > kMaxPairs || nbytes < 1 ||
      nbytes >= (1LL << 31)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  uintptr_t bits = 0;
  for (int i = 0; i < npairs; ++i) {
    bits |= reinterpret_cast<uintptr_t>(ptrs[npairs + i]);
  }
  if (bits & 15u) return static_cast<int>(cudaErrorMisalignedAddress);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(npairs <= kSmallPairs
                              ? launch<kSmallPairs>(ptrs, npairs, nbytes, s)
                              : launch<kMaxPairs>(ptrs, npairs, nbytes, s));
}

// C entry for ctypes: launches the empty kernel on `stream` with `blocks`
// blocks of 256 threads and a parameter block of K12's 128-pair size
// (big != 0, 2,056 bytes) or of 16 bytes; returns cudaGetLastError().
extern "C" int halo_ring_floor_launch(int big, int blocks, void* stream) {
  if (blocks < 1) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (big) {
    FloorBig p = {};
    halo_ring_floor_kernel<FloorBig><<<blocks, kThreads, 0, s>>>(p);
  } else {
    FloorSmall p = {0, 0};
    halo_ring_floor_kernel<FloorSmall><<<blocks, kThreads, 0, s>>>(p);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---- The cross-process form (parallel.multihost: one process a rank).
// The ranks are separate processes, each with its own CUDA context, as
// the TPU kernel's ranks are separate programs.  The remote copy becomes
// the same kernel writing into a window of the neighbour's memory mapped
// through CUDA IPC (on the same card, or on a peer card by lazy peer
// access).  The barrier semaphore becomes interprocess events and a host
// barrier (kernels/halo_ring.py sets out the order): no kernel spins on a
// flag, since two contexts on one card run by time-slicing.  Windows are
// allocated here with cudaMalloc, not by PyTorch's caching allocator,
// whose expandable segments export no IPC handle.  Each entry returns its
// cudaError_t; handles are the 64-byte cudaIpc*Handle_t, copied in and
// out as bytes.

extern "C" int halo_ipc_handle_bytes() {
  return static_cast<int>(sizeof(cudaIpcMemHandle_t));
}

// A receive window of `nbytes` on the current device and its IPC handle.
extern "C" int halo_ipc_window_alloc(long long nbytes, void** ptr,
                                     void* handle) {
  *ptr = nullptr;
  if (nbytes < 1) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = cudaMalloc(ptr, static_cast<size_t>(nbytes));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaIpcGetMemHandle(static_cast<cudaIpcMemHandle_t*>(handle), *ptr);
  if (e != cudaSuccess) {
    cudaFree(*ptr);
    *ptr = nullptr;
  }
  return static_cast<int>(e);
}

// Another process's window, mapped into this one.
extern "C" int halo_ipc_window_open(const void* handle, void** ptr) {
  cudaIpcMemHandle_t h;
  memcpy(&h, handle, sizeof(h));
  return static_cast<int>(
      cudaIpcOpenMemHandle(ptr, h, cudaIpcMemLazyEnablePeerAccess));
}

extern "C" int halo_ipc_window_close(void* ptr) {
  return static_cast<int>(cudaIpcCloseMemHandle(ptr));
}

extern "C" int halo_ipc_window_free(void* ptr) {
  return static_cast<int>(cudaFree(ptr));
}

// An interprocess event (no timing) and its IPC handle.
extern "C" int halo_ipc_event_create(void** ev, void* handle) {
  cudaEvent_t e = nullptr;
  *ev = nullptr;
  cudaError_t r = cudaEventCreateWithFlags(
      &e, cudaEventInterprocess | cudaEventDisableTiming);
  if (r != cudaSuccess) return static_cast<int>(r);
  r = cudaIpcGetEventHandle(static_cast<cudaIpcEventHandle_t*>(handle), e);
  if (r != cudaSuccess) {
    cudaEventDestroy(e);
    return static_cast<int>(r);
  }
  *ev = e;
  return 0;
}

// Another process's event, opened in this one.
extern "C" int halo_ipc_event_open(const void* handle, void** ev) {
  cudaIpcEventHandle_t h;
  memcpy(&h, handle, sizeof(h));
  cudaEvent_t e = nullptr;
  const cudaError_t r = cudaIpcOpenEventHandle(&e, h);
  *ev = e;
  return static_cast<int>(r);
}

extern "C" int halo_ipc_event_destroy(void* ev) {
  return static_cast<int>(cudaEventDestroy(static_cast<cudaEvent_t>(ev)));
}

// `stream` waits for every event of `evs` (an event's latest record in
// any process), then records `ev` when not null.
extern "C" int halo_ipc_wait_record(void* const* evs, int n, void* ev,
                                    void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  for (int i = 0; i < n; ++i) {
    const cudaError_t r =
        cudaStreamWaitEvent(s, static_cast<cudaEvent_t>(evs[i]), 0);
    if (r != cudaSuccess) return static_cast<int>(r);
  }
  if (ev != nullptr) {
    return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(ev), s));
  }
  return 0;
}

// The receiving side: `stream` waits for the sender's `written` event,
// copies `nbytes` of the window out to `dst`, and records `freed` (the
// sender waits on it before it writes this window again).
extern "C" int halo_ipc_copy_out(void* written, const void* window,
                                 void* dst, long long nbytes, void* freed,
                                 void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t r = cudaStreamWaitEvent(s, static_cast<cudaEvent_t>(written), 0);
  if (r != cudaSuccess) return static_cast<int>(r);
  r = cudaMemcpyAsync(dst, window, static_cast<size_t>(nbytes),
                      cudaMemcpyDeviceToDevice, s);
  if (r != cudaSuccess) return static_cast<int>(r);
  return static_cast<int>(cudaEventRecord(static_cast<cudaEvent_t>(freed), s));
}
