// Device helpers of the Conv4Layers head kernels (conv4head.cu,
// conv4head_bwd.cu, conv4head_bwd_w_bf16.cu): GELU and its derivative,
// small integer helpers of the shared-memory plans, and the column tiles of
// the weight-gradient kernels.

#pragma once

#include <cuda_runtime.h>

namespace isd {

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

constexpr int kMaxSmemBytes = 232448;  // a block's dynamic shared memory on Hopper

__host__ __device__ inline int round_up4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int max_int(int a, int b) { return a > b ? a : b; }

// Column tiles (B2w and B2w-bf16): a window whose plan does not fit a block
// runs in tiles of at most kColSpan conv rows, tile j from the window's conv
// row kColStep * j. The two 'same' convs and their transposes reach two rows
// each, so dh1 is exact kColHalo rows inside an interior edge: tile j owns
// rows [kColHalo, kColSpan - kColHalo) of its own (from 0 in the first tile,
// up to t1 in the last), and only those enter the weight gradients.
// ops/cuda/conv4head.py mirrors them (col_tiles).
constexpr int kColSpan = 256;
constexpr int kColHalo = 8;
constexpr int kColStep = kColSpan - 2 * kColHalo;  // 240

// Column tiles of a window of t1 conv rows: 1 up to kColSpan, else
// ceil((t1 - 2 kColHalo) / kColStep).
__host__ __device__ inline int col_tile_count(int t1) {
  return t1 <= kColSpan ? 1 : (t1 - 2 * kColHalo + kColStep - 1) / kColStep;
}

__device__ inline float gelu(float v) { return 0.5f * v * (1.f + erff(v * kInvSqrt2)); }

// d/dv [v * Phi(v)] = Phi(v) + v * phi(v)
__device__ inline float gelu_grad(float v) {
  return 0.5f * (1.f + erff(v * kInvSqrt2)) + v * kInvSqrt2Pi * expf(-0.5f * v * v);
}

}  // namespace isd
