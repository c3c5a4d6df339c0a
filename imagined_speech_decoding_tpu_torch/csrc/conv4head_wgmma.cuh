// Pieces of the Conv4Layers head kernels on wgmma (B2w-bf16,
// conv4head_bwd_w_bf16.cu; B2f-bf16, conv4head_fwd_bf16.cu; B2x-bf16,
// conv4head_bwd_x_bf16.cu): the chunked
// core-matrix layout of their time-major buffers and staged weights, a
// 64-row conv tile issued as wgmma m64n32k16 from shared memory, its
// accumulator epilogue and the per-warp column sums. wgmma_bf16.cuh says
// what the layout and the descriptors are.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "conv4head_bf16.cuh"
#include "wgmma_bf16.cuh"

namespace isd {

constexpr int kRows = 64;             // rows of a wgmma tile
constexpr int kGroups = kWarpsB / 4;  // warpgroups a block

__host__ __device__ inline int round16(int v) { return (v + 15) & ~15; }

// Bytes of (row, channel) from the start of a chunked buffer.
__host__ __device__ inline int chunk_off(int cs, int row, int ch) {
  return (ch >> 3) * cs + 16 * row + 2 * (ch & 7);
}

// Rows o < O of w (f32, K taps of Ch channels, row stride K*Ch) to bf16 at
// dst, [chunk of (tap, channel)][o][8] (chunks 16 O bytes apart), channels
// Ch..chp-1 zero (chp a multiple of 8).
__device__ inline void stage_weights_wg(char* dst, const float* __restrict__ w, int O, int K,
                                        int Ch, int chp) {
  const int pairs = K * chp / 2;
  for (int i = threadIdx.x; i < O * pairs; i += blockDim.x) {
    const int o = i / pairs, j = 2 * (i - o * pairs), k = j / chp, c = j - k * chp;
    const float* row = w + static_cast<size_t>(o) * K * Ch + k * Ch;
    *reinterpret_cast<uint32_t*>(dst + chunk_off(16 * O, o, j)) =
        pack_bf16(c < Ch ? row[c] : 0.f, c + 1 < Ch ? row[c + 1] : 0.f);
  }
}

// Issues one 64-row tile of D[t, o] into acc (overwriting it): over the K
// taps and the k16 steps of Ch channels, A = src from row 64 tile + tap
// (kT: + K-1-tap), K-major; B = w, K-major [o][(tap, c)] for a conv, or for
// a conv^T (kT, Ch = O) w[o'][tap * O + o] read MN-major.
template <int K, int O, bool kT>
__device__ inline void conv_issue(float (&acc)[16], uint32_t src, int cs, uint32_t w, int Ch,
                                  int tile) {
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const uint32_t a_row = src + 16 * (kRows * tile + (kT ? K - 1 - k : k));
#pragma unroll
    for (int c0 = 0; c0 < Ch; c0 += 16) {
      const uint64_t a = wgmma_desc(a_row + (c0 >> 3) * cs, cs, 128);
      if (kT) {
        const uint64_t b = wgmma_desc(w + k * 2 * O * O + 16 * c0, 128, 16 * O);
        wgmma_m64n32k16<0, 1>(acc, a, b, k | c0);
      } else {
        const uint64_t b = wgmma_desc(w + ((k * Ch + c0) >> 3) * 16 * O, 16 * O, 128);
        wgmma_m64n32k16<0, 0>(acc, a, b, k | c0);
      }
    }
  }
}

// red[warp * 32 + o] = the sum over this warp's rows of s[j][e], o = 8j +
// 2q + e: every lane stores (the eight lanes of one o the same value), so
// no branch runs while the weight gradients' wgmma are in flight (a
// divergent path there makes ptxas serialise every wgmma of the kernel).
__device__ inline void col_sums(float* red, const float (&s)[4][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = s[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      red[warp * 32 + 8 * j + 2 * (lane & 3) + e] = v;
    }
  }
}

// Hands each accumulator pair of a conv tile to out(j, t, o, v0, v1):
// row t, columns o, o + 1 (j = o / 8).
template <class Out>
__device__ inline void conv_epilogue(const float (&acc)[16], int tile, Out out) {
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, g = lane >> 2, q = lane & 3;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      out(j, kRows * tile + 16 * w + 8 * h + g, 8 * j + 2 * q, acc[4 * j + 2 * h],
          acc[4 * j + 2 * h + 1]);
    }
  }
}

}  // namespace isd
