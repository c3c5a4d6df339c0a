// Warpgroup bf16 tensor-core products for Hopper (sm_90a): wgmma.mma_async
// m64n32k16 with bf16 operands read from shared memory through matrix
// descriptors and f32 accumulators in registers, and the fences that order
// them. Kernel B2w-bf16 (conv4head_bwd_w_bf16.cu) runs every product on it.
//
// Shared-memory layout: no swizzle. wgmma reads an operand as 8 x 8 "core
// matrices" of bf16, each 8 rows of 16 contiguous bytes stored contiguously
// (128 bytes). Every time-major buffer of the kernel is stored in chunks of
// 8 channels, [chunk][row][8], so the core matrix at (row r, chunk j) is
// the 128 bytes from j * chunk_stride + r * 16, and
//  * read with channels along K (a "K-major" operand) it is an 8 (rows) x
//    8 (K) tile: the next 8 rows are +128 bytes, the next 8 channels
//    +chunk_stride;
//  * read with rows along K (an "MN-major" operand: the same bytes, the
//    channels along M or N) it is an 8 (K) x 8 (M or N) tile: the next 8
//    K rows are +128 bytes, the next 8 channels +chunk_stride.
// A shift of one row is +16 bytes, a legal descriptor start (16-byte
// units), so a conv's taps are only other start addresses.
//
// Descriptor (PTX ISA, "Matrix Descriptor Format"): bits 0-13 the start
// address >> 4, 16-29 the leading-dimension byte offset >> 4, 32-45 the
// stride-dimension byte offset >> 4, 49-51 the base offset (0), 62-63 the
// swizzle mode (0: none). With no swizzle the leading offset is the step
// between core matrices along K and the stride offset the step along M or
// N, for both majors (CUTLASS's make_gmma_desc, INTERLEAVE); the one-tile
// self-tests in wgmma_selftest.cu hold each form against a plain product
// on the card.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace isd {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// A no-swizzle matrix descriptor: start (shared-memory byte address), the
// byte step between core matrices along K and along M (or N).
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t start, uint32_t k_step,
                                               uint32_t mn_step) {
  return static_cast<uint64_t>((start >> 4) & 0x3FFFu) |
         (static_cast<uint64_t>((k_step >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((mn_step >> 4) & 0x3FFFu) << 32);
}

// d (+)= A (64 x 16) * B (16 x 32): bf16 operands in shared memory, f32
// accumulators; kTransA / kTransB 0 for a K-major operand, 1 for an
// MN-major one; scale_d 0 overwrites d. Accumulator layout (per warp w of
// the warpgroup, g = lane / 4, q = lane % 4): d[4j + 2h + e] is row
// 16 w + 8 h + g, column 8 j + 2 q + e.
template <int kTransA, int kTransB>
__device__ __forceinline__ void wgmma_m64n32k16(float (&d)[16], uint64_t a, uint64_t b,
                                                int scale_d) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %19, %20;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTransA), "n"(kTransB));
}

// Orders this warpgroup's earlier register and shared-memory accesses
// before the wgmma that follow.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Waits until at most kPending of this warpgroup's committed groups are in flight.
template <int kPending>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(kPending) : "memory");
}

// Keeps the compiler from moving accesses of an accumulator across a
// wgmma issue or wait (the asm statements order only memory otherwise).
__device__ __forceinline__ void fence_operand(float (&d)[16]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Makes this thread's generic-proxy stores to shared memory visible to the
// async proxy (wgmma's operand reads); a barrier must follow before another
// thread's wgmma reads them.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

}  // namespace isd
