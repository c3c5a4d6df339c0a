// One-tile self-test of the wgmma pieces in wgmma_bf16.cuh, for the card
// tests (tests/test_torch_cuda.py): a byte image of shared memory laid out
// by the caller, a list of k16 steps (each a start address for A and for
// B), and the byte steps of each operand's descriptor. One warpgroup
// copies the image in, issues wgmma.mma_async m64n32k16 over the steps
// (A and B K-major or MN-major, as asked) into one accumulator tile, and
// writes the 64 x 32 f32 result row-major through the accumulator layout.
// The tests build each descriptor form that kernel B2w-bf16 issues from
// the Python mirror of its plan and hold the result against a plain
// product of the same bf16 values.

#include <cstdint>

#include <cuda_runtime.h>

#include "wgmma_bf16.cuh"

namespace {

constexpr int kMaxSteps = 64;

struct Steps {
  int a[kMaxSteps], b[kMaxSteps];  // start byte offsets in the image
};

template <int kTransA, int kTransB>
__global__ void __launch_bounds__(128, 1)
wgmma_selftest_kernel(const uint4* __restrict__ image, int n16, Steps steps, int n_steps,
                      int a_k, int a_mn, int b_k, int b_mn, float* __restrict__ d) {
  extern __shared__ uint4 smem[];
  for (int i = threadIdx.x; i < n16; i += blockDim.x) smem[i] = image[i];
  isd::fence_proxy_async();
  __syncthreads();
  const uint32_t base = isd::smem_u32(smem);
  float acc[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) acc[i] = 0.f;
  isd::wgmma_fence();
  for (int s = 0; s < n_steps; ++s) {
    isd::wgmma_m64n32k16<kTransA, kTransB>(acc, isd::wgmma_desc(base + steps.a[s], a_k, a_mn),
                                           isd::wgmma_desc(base + steps.b[s], b_k, b_mn), s > 0);
  }
  isd::wgmma_commit();
  isd::wgmma_wait<0>();
  isd::fence_operand(acc);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int i = 0; i < 16; ++i) {
    const int j = i >> 2, h = (i >> 1) & 1, e = i & 1;
    d[(16 * warp + 8 * h + g) * 32 + 8 * j + 2 * q + e] = acc[i];
  }
}

}  // namespace

// d (64 x 32, f32, row-major) = sum over the steps of A (64 x 16) * B
// (16 x 32), read from a copy of `image` (n_bytes, a multiple of 16) in
// shared memory: step s reads A at byte a_starts[s] and B at b_starts[s]
// of the image, with core-matrix steps (a_k, a_mn) and (b_k, b_mn) bytes
// along K and along M or N; trans_a / trans_b 1 for an MN-major operand.
extern "C" int isd_wgmma_selftest(const void* image, int n_bytes, const int* a_starts,
                                  const int* b_starts, int n_steps, int a_k, int a_mn, int b_k,
                                  int b_mn, int trans_a, int trans_b, float* d, void* stream) {
  if (n_bytes % 16 != 0 || n_bytes > 227 * 1024 || n_steps < 1 || n_steps > kMaxSteps) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Steps steps;
  for (int s = 0; s < n_steps; ++s) {
    if (a_starts[s] % 16 || b_starts[s] % 16) return static_cast<int>(cudaErrorInvalidValue);
    steps.a[s] = a_starts[s];
    steps.b[s] = b_starts[s];
  }
  const auto kernel = trans_a
                          ? (trans_b ? wgmma_selftest_kernel<1, 1> : wgmma_selftest_kernel<1, 0>)
                          : (trans_b ? wgmma_selftest_kernel<0, 1> : wgmma_selftest_kernel<0, 0>);
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, n_bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<1, 128, n_bytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint4*>(image), n_bytes / 16, steps, n_steps, a_k, a_mn, b_k, b_mn, d);
  return static_cast<int>(cudaGetLastError());
}
