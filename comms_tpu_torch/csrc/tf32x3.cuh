// float32 products on the tensor cores at float32 accuracy: 3xTF32.
//
// The port's counterpart of comms_tpu/kernels/_bf16.py (device_split,
// dot3): one definition, so that the kernels on the tensor cores cannot
// drift apart in precision.  x = hi + lo with hi = tf32(x) and lo =
// tf32(x - hi), both rounded to nearest, ties away from zero; a*b ~
// hi_a*hi_b + hi_a*lo_b + lo_a*hi_b, the lo*lo term (~2^-22 |ab|)
// dropped.  TF32 keeps 10 explicit mantissa bits, so hi + lo holds x to
// ~2^-22 relative (about 21 bits, against bf16x3's 16).
// kernels/_tf32.py mirrors the split in torch for the CPU tests.
//
// The products run as Hopper warpgroup MMAs (wgmma, sm_90a): A from
// registers, B from shared memory, where a TF32 operand must be K-major
// (each row holds consecutive k).

#pragma once

#include <stdint.h>

namespace tf32x3 {

// Round to TF32, nearest, ties away from zero (cvt.rna).  The low 13 bits
// are cleared, so that x - hi below is the exact residual.
__device__ __forceinline__ uint32_t round_tf32(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(x));
  return r & 0xffffe000u;
}

// x -> (hi, lo): the operand halves of the three products.  The
// residual x - hi is finite and small, so lo rounds by integer ops on its
// bits (half a unit added, the low 13 bits cleared: two instructions,
// where cvt.rna compiles to a compare and a select besides).  For x =
// +-inf the residual is NaN and lo comes out as +-0, which is right: hi
// carries the infinity.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = round_tf32(x);
  lo = (__float_as_uint(__fsub_rn(x, __uint_as_float(hi))) + 0x1000u) &
       0xffffe000u;
}

// Shared-memory matrix descriptor of a K-major operand in the 128-byte
// swizzle: rows of 32 TF32 values (128 bytes), 8-row atoms of 1024 bytes
// `sbo` bytes apart, the 16-byte chunk c of row i stored at chunk c ^ (i %
// 8); the atoms 1024-byte aligned.  `addr` may point k values into the
// rows (4 bytes each): the hardware applies the swizzle to the address.
__device__ __forceinline__ uint64_t smem_desc_sw128(uint32_t addr,
                                                    uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3ffff) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// d (+)= a * b for one warpgroup: m64n128k8, A (64 x 8) from registers
// in the m16n8k8 layout of mma.sync (warp w holds rows 16w .. 16w + 15:
// a0 = A[g][t], a1 = A[g+8][t], a2 = A[g][t+4], a3 = A[g+8][t+4], g =
// lane / 4, t = lane % 4), B^T (128 x 8) from shared memory (a
// descriptor, K-major), float32 accumulators in the m16n8 layout
// repeated over 16 n8 tiles (d[4j .. 4j+3]).  scale_d 0 starts the sum
// anew.  Asynchronous: the registers of a and d must not be touched
// until wgmma_wait().
__device__ __forceinline__ void wgmma_m64n128k8(float (&d)[64],
                                                const uint32_t (&a)[4],
                                                uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// d (+)= a * b in 3xTF32: the two small cross terms first, then hi * hi.
__device__ __forceinline__ void wgmma_tf32x3(float (&d)[64],
                                             const uint32_t (&ah)[4],
                                             const uint32_t (&al)[4],
                                             uint64_t bh, uint64_t bl,
                                             int scale_d) {
  wgmma_m64n128k8(d, al, bh, scale_d);
  wgmma_m64n128k8(d, ah, bl, 1);
  wgmma_m64n128k8(d, ah, bh, 1);
}

// Before the first wgmma of a batch (orders the warpgroup's register and
// shared-memory accesses before it).
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// Waits until every committed batch of this warpgroup is done.
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keeps the compiler from moving accesses to registers that a wgmma
// reads or writes across the asynchronous window between its issue and
// wgmma_wait(), and from reusing them before.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// Generic-proxy writes to shared memory made visible to wgmma's reads.
__device__ __forceinline__ void fence_smem_for_wgmma() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

}  // namespace tf32x3
