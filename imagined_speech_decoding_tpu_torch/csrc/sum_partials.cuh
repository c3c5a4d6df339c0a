// The deterministic second pass of the head's backward kernels (B2w and
// B2x in conv4head_bwd.cu, B2w-bf16 in conv4head_bwd_w_bf16.cu, B2x-bf16
// in conv4head_bwd_x_bf16.cu): blocks
// write private partials, and this pass sums them in a fixed order, so no
// atomics are needed and reruns are bit-identical.

#pragma once

#include <cuda_runtime.h>

namespace isd {

// out[m, l] = sum_p part[m, p, l] for l < L, in a fixed order.
static __global__ void sum_partials_kernel(const float* __restrict__ part,
                                           float* __restrict__ out, int M, int P, int L) {
  const size_t total = static_cast<size_t>(M) * L;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t m = i / L, l = i - m * L;
    const float* src = part + m * P * L + l;
    float acc = 0.f;
    for (int q = 0; q < P; ++q) acc += src[static_cast<size_t>(q) * L];
    out[i] = acc;
  }
}

inline cudaError_t sum_partials(const float* part, float* out, int M, int P, int L,
                                cudaStream_t st) {
  const long long total = static_cast<long long>(M) * L;
  const int blocks = static_cast<int>((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  sum_partials_kernel<<<blocks, 256, 0, st>>>(part, out, M, P, L);
  return cudaGetLastError();
}

}  // namespace isd
