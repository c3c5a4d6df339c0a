// Warp-level bf16 tensor-core products for Hopper (sm_90a): mma.sync
// m16n8k16 with bf16 operands and f32 accumulators, their fragments by
// ldmatrix, and the packing of two f32 values into one bf16x2 word.
//
// One pass per product, nothing split: a bf16 x bf16 product is exact in
// f32, so the only rounding is that of the f32 sums (as in the Pallas
// kernel's dot with preferred_element_type=f32).
//
// Fragment layout of m16n8k16 .bf16 (PTX ISA), with g = lane / 4 and
// q = lane % 4; each 32-bit register holds two elements consecutive along
// the reduction axis k, the lower index in the low half:
//   A (16 x 16, row): a0 (g, 2q..2q+1), a1 (g + 8, 2q..), a2 (g, 2q+8..), a3 (g + 8, 2q+8..)
//   B (16 x 8, col):  b0 (2q..2q+1, g), b1 (2q+8..2q+9, g)
//   C (16 x 8):       c0, c1 (g, 2q..2q+1), c2, c3 (g + 8, 2q..2q+1)
// ldmatrix .x4 hands lane l the pair (row l/4, columns 2(l%4)..) of each
// of four 8 x 8 b16 matrices whose row addresses lanes 8i..8i+7 give;
// .trans hands it the pair (rows 2(l%4)..2(l%4)+1, column l/4) instead.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace isd {

// d += a * b on one 16 x 8 x 16 tile: bf16 operands, f32 accumulators.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// Two matrices: lanes 0..15 give the row addresses (the others' are ignored).
__device__ __forceinline__ void ldsm_x2_t(uint32_t (&r)[2], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(row)));
}

// bf16(lo) in the low half, bf16(hi) in the high half; round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ uint16_t bf16_bits(float v) {
  const __nv_bfloat16 b = __float2bfloat16_rn(v);
  return *reinterpret_cast<const uint16_t*>(&b);
}

// 4 bytes global -> shared by cp.async: dst and src 4-byte aligned.
__device__ __forceinline__ void cp_async4_b32(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

}  // namespace isd
