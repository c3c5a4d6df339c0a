// The device code of csrc/conv4head_general.cu (B2f-g, B2w-g, B2x-g), built
// with the host compiler and run on the CPU, for the tests: each block's
// 256 threads are fibers on one OS thread, switched at every
// __syncthreads (a barrier is a round in which every fiber runs up to its
// next one), blocks one after another. The kernels' arithmetic is the
// card's: fmaf in the same order, the same bf16 roundings; GELU's erff and
// expf are the host's. Built by tests/test_torch_conv4head_general.py:
//   g++ -O2 -std=c++17 -fno-strict-aliasing -fPIC -shared -I tests/cuda_host
//       -I imagined_speech_decoding_tpu_torch/csrc tests/cuda_host/general_host.cpp -o <lib>

#include <ucontext.h>

#include <functional>
#include <vector>

#include "cuda_runtime.h"

dim3 threadIdx, blockIdx, blockDim, gridDim;

namespace host {

constexpr int kFibers = 256;
constexpr size_t kStack = 256 * 1024;

ucontext_t scheduler;
ucontext_t fibers[kFibers];
bool done[kFibers];
int current = 0;
std::function<void()> body;

void trampoline() {
  body();
  done[current] = true;  // then uc_link resumes the scheduler
}

// body() once per thread of each block; 0, or -1 when some threads of a
// block ended while others waited at a barrier.
int run_blocks(int grid, std::function<void()> fn) {
  static std::vector<std::vector<char>> stacks(kFibers, std::vector<char>(kStack));
  body = std::move(fn);
  gridDim = {static_cast<unsigned>(grid), 1, 1};
  blockDim = {kFibers, 1, 1};
  for (int b = 0; b < grid; ++b) {
    blockIdx = {static_cast<unsigned>(b), 0, 0};
    for (int t = 0; t < kFibers; ++t) {
      getcontext(&fibers[t]);
      fibers[t].uc_stack.ss_sp = stacks[t].data();
      fibers[t].uc_stack.ss_size = kStack;
      fibers[t].uc_link = &scheduler;
      makecontext(&fibers[t], trampoline, 0);
      done[t] = false;
    }
    for (;;) {
      for (int t = 0; t < kFibers; ++t) {
        current = t;
        threadIdx = {static_cast<unsigned>(t), 0, 0};
        swapcontext(&scheduler, &fibers[t]);
      }
      int finished = 0;
      for (int t = 0; t < kFibers; ++t) finished += done[t];
      if (finished == kFibers) break;
      if (finished) return -1;
    }
  }
  return 0;
}

}  // namespace host

void __syncthreads() { swapcontext(&host::fibers[host::current], &host::scheduler); }

#include "conv4head_general.cu"

extern "C" {

int emu_fwd_general(int bf16, const void* x, const float* w12, const float* b12, const float* w3,
                    const float* w4, float* out, float* work, int M, int B, int C, int T, int Z,
                    int O, int W, int step, int N, int grid) {
  return host::run_blocks(grid, [=] {
    if (bf16) {
      conv4head_fwd_general_kernel<true>(static_cast<const __nv_bfloat16*>(x), w12, b12, w3, w4,
                                         out, work, M, B, C, T, Z, O, W, step, N);
    } else {
      conv4head_fwd_general_kernel<false>(static_cast<const float*>(x), w12, b12, w3, w4, out,
                                          work, M, B, C, T, Z, O, W, step, N);
    }
  });
}

int emu_bwd_w_general(int bf16, const float* g, const void* x, const float* w12, const float* b12,
                      const float* w3, const float* w4, float* pw12, float* pb12, float* pw3,
                      float* pw4, float* work, int M, int B, int C, int T, int Z, int O, int W,
                      int step, int N, int S, int grid) {
  return host::run_blocks(grid, [=] {
    if (bf16) {
      conv4head_bwd_w_general_kernel<true>(g, static_cast<const __nv_bfloat16*>(x), w12, b12, w3,
                                           w4, pw12, pb12, pw3, pw4, work, M, B, C, T, Z, O, W,
                                           step, N, S);
    } else {
      conv4head_bwd_w_general_kernel<false>(g, static_cast<const float*>(x), w12, b12, w3, w4,
                                            pw12, pb12, pw3, pw4, work, M, B, C, T, Z, O, W, step,
                                            N, S);
    }
  });
}

int emu_bwd_x_general(int bf16, const float* g, const void* x, const float* w12, const float* b12,
                      const float* w3, const float* w4, float* dxw, float* work, int M, int B,
                      int C, int T, int Z, int O, int W, int step, int N, int grid) {
  return host::run_blocks(grid, [=] {
    if (bf16) {
      conv4head_bwd_x_general_kernel<true>(g, static_cast<const __nv_bfloat16*>(x), w12, b12, w3,
                                           w4, dxw, work, M, B, C, T, Z, O, W, step, N);
    } else {
      conv4head_bwd_x_general_kernel<false>(g, static_cast<const float*>(x), w12, b12, w3, w4,
                                            dxw, work, M, B, C, T, Z, O, W, step, N);
    }
  });
}

}  // extern "C"
