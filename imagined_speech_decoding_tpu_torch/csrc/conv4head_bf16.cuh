// Small pieces shared by the bf16 Conv4Layers head kernels B2f-bf16
// (conv4head_fwd_bf16.cu), B2w-bf16 (conv4head_bwd_w_bf16.cu) and B2x-bf16
// (conv4head_bwd_x_bf16.cu), all on wgmma (conv4head_wgmma.cuh): the block size, the fixed-order sum of
// per-warp column sums, and zero fill. The bf16 packing, the 4-byte
// cp.async and ldmatrix.trans are in mma_bf16.cuh; cp.async's wait in
// mma_tf32.cuh; GELU and its derivative in conv4head_common.cuh.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "conv4head_common.cuh"
#include "mma_bf16.cuh"
#include "mma_tf32.cuh"

namespace isd {

constexpr int kWarpsB = 16;  // a bf16 head block: 16 warps (4 warpgroups), one block per SM

// sum_w red[w * 32 + o] in warp order.
__device__ inline float sum_warps(const float* red, int o) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarpsB; ++w) s += red[w * 32 + o];
  return s;
}

// Zeros in `words` 32-bit words from p.
__device__ inline void zero_words(uint32_t* p, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) p[i] = 0u;
}

// Zeros rows [r0, r0 + n) of `chunks` consecutive chunks of 8 channels (cs
// bytes apart, 16 bytes a row) from buf.
__device__ inline void zero_rows(char* buf, int cs, int chunks, int r0, int n) {
  for (int i = threadIdx.x; i < chunks * n; i += blockDim.x) {
    const int ch = i / n;
    *reinterpret_cast<uint4*>(buf + ch * cs + 16 * (r0 + i - ch * n)) = make_uint4(0, 0, 0, 0);
  }
}

}  // namespace isd
