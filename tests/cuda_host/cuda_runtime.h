// A stand-in for the CUDA runtime header, for building the device code of
// the port's kernels with the host compiler (tests/cuda_host/
// general_host.cpp): the qualifiers vanish, __shared__ variables become
// function statics (one block runs at a time), and threadIdx, blockIdx,
// gridDim, blockDim and __syncthreads come from the harness.

#pragma once

#include <math.h>
#include <stddef.h>
#include <stdint.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __shared__ static
#define __align__(n) __attribute__((aligned(n)))

struct dim3 {
  unsigned int x, y, z;
};
extern dim3 threadIdx, blockIdx, blockDim, gridDim;
void __syncthreads();

struct alignas(8) float2 {
  float x, y;
};
struct alignas(16) float4 {
  float x, y, z, w;
};
