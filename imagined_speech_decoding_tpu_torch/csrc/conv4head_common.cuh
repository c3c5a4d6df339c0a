// Device helpers of the Conv4Layers head kernels (conv4head.cu,
// conv4head_bwd.cu): GELU and its derivative, and small integer helpers of
// the shared-memory plans.

#pragma once

#include <cuda_runtime.h>

namespace isd {

constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__host__ __device__ inline int round_up4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int max_int(int a, int b) { return a > b ? a : b; }

__device__ inline float gelu(float v) { return 0.5f * v * (1.f + erff(v * kInvSqrt2)); }

// d/dv [v * Phi(v)] = Phi(v) + v * phi(v)
__device__ inline float gelu_grad(float v) {
  return 0.5f * (1.f + erff(v * kInvSqrt2)) + v * kInvSqrt2Pi * expf(-0.5f * v * v);
}

}  // namespace isd
