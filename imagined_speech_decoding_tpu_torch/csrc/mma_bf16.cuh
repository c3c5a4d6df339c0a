// bf16 helpers of the head kernels for Hopper (sm_90a): ldmatrix .trans
// and stmatrix (B2f-bf16 transposes the channel-major x into its
// time-major chunks with them), the packing of two f32 values into one bf16x2 word, and the 4-byte
// cp.async.
//
// ldmatrix .x4 hands lane l the pair (row l/4, columns 2(l%4)..) of each
// of four 8 x 8 b16 matrices whose row addresses lanes 8i..8i+7 give;
// .trans hands it the pair (rows 2(l%4)..2(l%4)+1, column l/4) instead,
// the lower row in the low half.

#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace isd {

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// Four 8 x 8 b16 matrices, transposed; lane l gives the address of row l % 8
// of matrix l / 8.
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(row)));
}

// Four 8 x 8 b16 matrices from registers, in ldmatrix's (untransposed)
// fragment layout; lane l gives the address of row l % 8 of matrix l / 8.
__device__ __forceinline__ void stsm_x4(void* row, const uint32_t (&r)[4]) {
  asm volatile("stmatrix.sync.aligned.m8n8.x4.shared.b16 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   smem_addr(row)),
               "r"(r[0]), "r"(r[1]), "r"(r[2]), "r"(r[3])
               : "memory");
}

// bf16(lo) in the low half, bf16(hi) in the high half; round to nearest even.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 bytes global -> shared by cp.async: dst and src 4-byte aligned.
__device__ __forceinline__ void cp_async4_b32(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

}  // namespace isd
