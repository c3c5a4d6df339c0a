// Per-phase clock counters for the debug instantiations of kernels
// B2w-bf16 (conv4head_bwd_w_bf16.cu), B2f-bf16 (conv4head_fwd_bf16.cu) and
// B2x-bf16 (conv4head_bwd_x_bf16.cu), kClock = true; b2w_timing.py,
// b2f_timing.py and b2x_timing.py read them. The shipped instantiations
// compile them out.
//
// Each warp adds the clock64() cycles since its previous mark to the slot
// of the phase that just ended, in shared memory ([warp][phase],
// 8 bytes each, after the kernel's own plan). At the block's end the slots
// are summed over warps and added to the device counters: one per phase,
// then the block's cycles and its nanoseconds (%globaltimer), so the caller
// can read cycles per (trial, window, zone) unit and the SM clock.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

namespace isd {

// The phases of B2w-bf16's trial loop, in the order of
// ops/cuda/conv4head.py's BWD_W_BF16_PHASES.
enum BwdWPhase {
  kPhWait,       // the next window's copy, the last trial's products, the barrier
  kPhTranspose,  // the window's transpose into its time-major chunks, g / t1
  kPhConv1,      // h1 and its epilogue
  kPhConv2,      // h2
  kPhConv3,      // h3 and dh3 = g / t1 * gelu'(h3)
  kPhConv4T,     // dh2 = conv4^T(dh3)
  kPhDw4,        // dw4's products (issued; they run on under the next epilogues)
  kPhConv3T,     // dh1 = conv3^T(dh2) and its f32 column sums
  kPhDw3,        // dw3's products
  kPhDw12,       // dw12's products
  kPhDb12,       // db12's sum over warps
  kPhBarrier,    // every other __syncthreads
  kPhases
};

constexpr int kClockWarps = 16;

// The shared-memory slots of kN phases (the last one the barriers).
template <int kN = kPhases>
constexpr int clock_bytes() {
  return kClockWarps * kN * 8;
}

template <bool kOn, int kN = kPhases>
struct PhaseClock {
  unsigned long long* slots;
  long long last = 0, start = 0;
  unsigned long long ns = 0;

  // Zeroes the slots at `s` (a barrier must follow before the first mark).
  __device__ explicit PhaseClock(void* s) : slots(static_cast<unsigned long long*>(s)) {
    if constexpr (kOn) {
      for (int i = threadIdx.x; i < kClockWarps * kN; i += blockDim.x) slots[i] = 0;
      asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(ns));
      last = start = clock64();
    }
  }

  // Every lane adds the same cycles to its warp's slot (one load and one
  // store for the warp): no branch, which would serialise the kernel's wgmma.
  __device__ void mark(int phase) {
    if constexpr (kOn) {
      const long long now = clock64();
      slots[(threadIdx.x >> 5) * kN + phase] += now - last;
      last = now;
    }
  }

  // The phase that just ended, then a block-wide barrier, counted as the
  // last phase (kPhBarrier for B2w-bf16).
  __device__ void sync(int phase) {
    mark(phase);
    __syncthreads();
    mark(kN - 1);
  }

  // Adds the block's sums to out[0, kN + 2).
  __device__ void finish(unsigned long long* out) {
    if constexpr (kOn) {
      __syncthreads();
      for (int p = threadIdx.x; p < kN; p += blockDim.x) {
        unsigned long long sum = 0;
        for (int w = 0; w < kClockWarps; ++w) sum += slots[w * kN + p];
        atomicAdd(out + p, sum);
      }
      if (threadIdx.x == 0) {
        unsigned long long now_ns;
        asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(now_ns));
        atomicAdd(out + kN, static_cast<unsigned long long>(clock64() - start));
        atomicAdd(out + kN + 1, now_ns - ns);
      }
    }
  }
};

}  // namespace isd
