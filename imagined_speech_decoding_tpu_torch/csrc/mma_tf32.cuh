// Warp-level tensor-core products in f32 accuracy for Hopper (sm_90a):
// mma.sync m16n8k8 with TF32 operands, each f32 operand split in registers
// into two TF32 halves (3xTF32).
//
// TF32 keeps 10 mantissa bits, so one TF32 product carries ~3 decimal
// digits. Split v = hi + lo with hi = v with its low 13 mantissa bits
// cleared (a TF32 value) and lo = v - hi, exact in f32 and below 2^-10 |v|.
// The tensor core reads a .tf32 operand's top 19 bits and ignores the low
// 13 (CUTLASS's round_toward_zero float -> tfloat32_t conversion is a plain
// bit cast for this reason), so lo enters as lo truncated to TF32, off by
// less than 2^-10 |lo| < 2^-20 |v|. Then
//   a * b = a_hi b_hi + a_hi b_lo + a_lo b_hi + a_lo b_lo,
// the last term below 2^-20 |a b|, is dropped; the three others go into
// the same f32 accumulators, the small ones first. The split is one
// logical op and one f32 subtraction: cvt.rna.tf32.f32 lowers to a
// sequence of five or more instructions on sm_90a, which cost a quarter of
// B2w's time when the split used it.
//
// Fragment layout of m16n8k8 .tf32 (PTX ISA; CUTLASS's
// SM80_16x8x8_F32TF32TF32F32_TN), with g = lane / 4 and q = lane % 4:
//   A (16 x 8, row): a0 (g, q), a1 (g + 8, q), a2 (g, q + 4), a3 (g + 8, q + 4)
//   B (8 x 8, col):  b0 (q, g), b1 (q + 4, g)
//   C (16 x 8):      c0 (g, 2q), c1 (g, 2q + 1), c2 (g + 8, 2q), c3 (g + 8, 2q + 1)

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace isd {

__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(v) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

// d += a * b on one 16 x 8 x 8 tile: TF32 operands, f32 accumulators.
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// acc[i][j] += A_i * B_j over one reduction step of 8, in 3xTF32, for MT
// 16-row tiles A_i and NT 8-column tiles B_j: a[i] holds this lane's four
// values of A_i (a0..a3 above), b[j] its two of B_j (b0, b1). Every tile
// is computed, so the step is one basic block and no mma is predicated.
// Each pass runs over all tiles before the next: the three dependent
// products of one accumulator are MT * NT mma apart.
template <int MT, int NT>
__device__ __forceinline__ void mma3_step(float (&acc)[MT][NT][4], const float (&a)[MT][4],
                                          const float (&b)[NT][2]) {
  uint32_t ah[MT][4], al[MT][4], bh[NT][2], bl[NT][2];
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int e = 0; e < 4; ++e) split_tf32(a[i][e], ah[i][e], al[i][e]);
  }
#pragma unroll
  for (int j = 0; j < NT; ++j) {
    split_tf32(b[j][0], bh[j][0], bl[j][0]);
    split_tf32(b[j][1], bh[j][1], bl[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], al[i], bh[j][0], bh[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bl[j][0], bl[j][1]);
  }
#pragma unroll
  for (int i = 0; i < MT; ++i) {
#pragma unroll
    for (int j = 0; j < NT; ++j) mma_tf32(acc[i][j], ah[i], bh[j][0], bh[j][1]);
  }
}

// This lane's A fragment (a0..a3 above) of the 16 x 8 tile whose row r
// starts at p + r * ld in shared memory, by one ldmatrix (rows 16-byte
// aligned): matrix i of ldmatrix .x4 is the 8 x 4 block (rows 8 (i % 2),
// columns 4 (i / 2)), whose row g, word q goes to lane 4g + q.
__device__ __forceinline__ void ldmatrix_a(float (&a)[4], const float* p, int ld) {
  const int lane = threadIdx.x & 31;
  const float* row = p + ((lane & 7) + 8 * ((lane >> 3) & 1)) * ld + 4 * (lane >> 4);
  uint32_t r[4];
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(static_cast<unsigned>(__cvta_generic_to_shared(row))));
#pragma unroll
  for (int e = 0; e < 4; ++e) a[e] = __uint_as_float(r[e]);
}

// Asynchronous global -> shared copies (cp.async; sm_80 and later).
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// 16 bytes: dst and src 16-byte aligned.
__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   static_cast<unsigned>(__cvta_generic_to_shared(dst))),
               "l"(src)
               : "memory");
}

// Wait for every cp.async this thread issued.
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

}  // namespace isd
