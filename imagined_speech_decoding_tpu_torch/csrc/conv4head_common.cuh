// Device helpers of the Conv4Layers head kernels: GELU and its derivative
// (B2f, B2w), and the CUDA-core convs of B2x (conv4head_bwd.cu).
// Activations live in shared memory as (rows, ld) arrays; weights are
// staged into shared memory either transposed (o innermost, so one
// 16-byte broadcast load feeds four FMAs of a thread's output row) or as
// stored (for the transposed convs, whose innermost index is the input
// channel).

#pragma once

#include <cuda_runtime.h>

namespace isd {

constexpr int kThreads = 256;
constexpr float kInvSqrt2 = 0.70710678118654752f;
constexpr float kInvSqrt2Pi = 0.39894228040143268f;

__host__ __device__ inline int round_up4(int v) { return (v + 3) & ~3; }
__host__ __device__ inline int max_int(int a, int b) { return a > b ? a : b; }

__device__ inline float gelu(float v) { return 0.5f * v * (1.f + erff(v * kInvSqrt2)); }

// d/dv [v * Phi(v)] = Phi(v) + v * phi(v)
__device__ inline float gelu_grad(float v) {
  return 0.5f * (1.f + erff(v * kInvSqrt2)) + v * kInvSqrt2Pi * expf(-0.5f * v * v);
}

// Stage rows [row0, row0 + O) of a (rows, cols) matrix into dst as
// (cols, O): dst[q * O + o] = src[(row0 + o) * cols + q].
__device__ inline void stage_transposed(float* dst, const float* __restrict__ src, int row0,
                                        int O, int cols) {
  for (int i = threadIdx.x; i < O * cols; i += blockDim.x) {
    const int o = i / cols, q = i - o * cols;
    dst[q * O + o] = src[static_cast<size_t>(row0 + o) * cols + q];
  }
}

__device__ inline void stage_copy(float* dst, const float* __restrict__ src, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) dst[i] = src[i];
}

// acc[j] += w[j] * v for j < O (w 16-byte aligned, broadcast to the warp).
template <int O>
__device__ inline void axpy_row(float (&acc)[O], const float* w, float v) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < O / 4; ++j) {
    const float4 q = w4[j];
    acc[4 * j + 0] += q.x * v;
    acc[4 * j + 1] += q.y * v;
    acc[4 * j + 2] += q.z * v;
    acc[4 * j + 3] += q.w * v;
  }
}

// Fused temporal x zone-scattered spatial conv (valid) + bias, one zone:
// dst[o * ld + t] = bias[o] + sum_{k, c} wT[(k * C + c) * O + o] * xs[c * lx + t + k].
template <int O>
__device__ inline void first_conv(float* dst, int ld, const float* xs, int lx, const float* wT,
                                  const float* __restrict__ bias, int C, int K, int t1) {
  for (int t = threadIdx.x; t < t1; t += blockDim.x) {
    float acc[O];
#pragma unroll
    for (int o = 0; o < O; ++o) acc[o] = bias[o];
    for (int k = 0; k < K; ++k) {
      for (int c = 0; c < C; ++c) axpy_row<O>(acc, wT + (k * C + c) * O, xs[c * lx + t + k]);
    }
#pragma unroll
    for (int o = 0; o < O; ++o) dst[o * ld + t] = acc[o];
  }
}

// One 'same' K-tap conv over time on (O, ld) activations, zero outside [0, t1).
//   forward    (kTranspose false): dst[o, t] = sum_{k, i} w[(k * O + i) * O + o] * src[i, t + k - K/2]
//              with w staged transposed (stage_transposed of the (O, K*O) weight);
//   transposed (kTranspose true):  dst[i, t] = sum_{k, o} w[(o * K + k) * O + i] * src[o, t - k + K/2]
//              with w staged as stored, (O, K*O) tap-major: the input-gradient of the forward conv.
template <int O, bool kTranspose>
__device__ inline void same_conv(float* dst, const float* src, int ld, const float* w, int K,
                                 int t1) {
  const int pad = K / 2;
  for (int t = threadIdx.x; t < t1; t += blockDim.x) {
    float acc[O];
#pragma unroll
    for (int o = 0; o < O; ++o) acc[o] = 0.f;
    for (int k = 0; k < K; ++k) {
      const int tt = kTranspose ? t - k + pad : t + k - pad;
      if (tt < 0 || tt >= t1) continue;
      for (int j = 0; j < O; ++j) {
        const float* row = kTranspose ? w + (j * K + k) * O : w + (k * O + j) * O;
        axpy_row<O>(acc, row, src[j * ld + tt]);
      }
    }
#pragma unroll
    for (int o = 0; o < O; ++o) dst[o * ld + t] = acc[o];
  }
}

}  // namespace isd
