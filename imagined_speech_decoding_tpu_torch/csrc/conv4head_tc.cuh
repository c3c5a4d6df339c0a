// Tensor-core pieces shared by the Conv4Layers head kernels B2f
// (conv4head.cu), B2w and B2x (conv4head_bwd.cu): row strides, staging by
// cp.async, and conv_tc, one conv of the head (or the input gradient of
// a 'same' conv) as a 3xTF32 mma.sync GEMM with an implicit im2col.
//
// Layout in shared memory: the window x[c, 0:W] is stored from column 0
// with zeros after it; an activation row from column K/2 with zero
// columns around it, so a tap's shift never leaves the row and fragment
// loads need no branch (B2x writes dh1 from column K - 1 instead: its
// input gradient reaches K - 1 columns left of it). t1 runs to nt8 columns (whole 8-column tiles);
// every epilogue writes exact zeros in the columns t1..nt8-1. Row strides
// are 4 mod 8, so the A fragments (rows g, columns q) fall in 32 distinct
// banks; the B fragments of a conv (rows q, columns g) take two
// wavefronts.

#pragma once

#include <cuda_runtime.h>

#include "conv4head_common.cuh"
#include "mma_tf32.cuh"

namespace isd {

constexpr int kUnrollTc = 2;  // reduction steps per iteration of the mma loops

// The least stride >= n that is 4 mod 8: rows g = 0..7 at columns q = 0..3
// (the A fragments, and the B fragments of the weight gradients) then fall
// in 32 distinct banks.
__host__ __device__ inline int stride_4mod8(int n) { return ((n + 3) & ~7) + 4; }

// Row strides of a tensor-core head block, in floats, for Ch channels per
// tap of the first conv (a multiple of 8).
struct TcStrides {
  int nt8;      // t1 rounded up to whole 8-column tiles
  int ld;       // window and activation rows: >= nt8 + K - 1, the farthest column a tap reaches
  int lw1, lw;  // staged w12 rows (K * Ch) and w3 / w4 rows (K * O)
};

__host__ __device__ inline TcStrides tc_strides(int Ch, int W, int O, int K) {
  TcStrides s;
  s.nt8 = (W - K + 1 + 7) & ~7;
  s.ld = stride_4mod8(s.nt8 + K - 1);
  s.lw1 = stride_4mod8(K * Ch);
  s.lw = stride_4mod8(K * O);
  return s;
}

// The window x[c, 0:W] (rows at stride T) to dst[c * ld + j] by cp.async,
// and zeros in its columns W..ld-1 (the conv's reach past the window).
template <int kWarps>
__device__ inline void stage_window_async(float* dst, int ld, const float* __restrict__ x, int C,
                                          int T, int W) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < C; c += kWarps) {
    const float* src = x + static_cast<size_t>(c) * T;
    float* row = dst + c * ld;
    for (int j = lane; j < W; j += 32) cp_async4(row + j, src + j);
    for (int j = W + lane; j < ld; j += 32) row[j] = 0.f;
  }
}

// Rows o < 16 of w (O = 32 rows of `cols` floats, 16-byte aligned) to
// lo[o * ld], rows 16..31 to hi[(o - 16) * ld], by 16-byte cp.async.
template <int kWarps>
__device__ inline void stage_rows_async(float* lo, float* hi, int ld, const float* __restrict__ w,
                                        int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = warp; o < 32; o += kWarps) {
    float* row = o < 16 ? lo + o * ld : hi + (o - 16) * ld;
    const float* src = w + static_cast<size_t>(o) * cols;
    for (int j = 4 * lane; j < cols; j += 128) cp_async16(row + j, src + j);
  }
}

// The zone's O rows of w12 (K taps of C channels each) to
// dst[o * ld + k * cp + c], zeros for c in [C, cp), by 4-byte cp.async
// (any C, any alignment).
template <int O, int K, int kWarps>
__device__ inline void stage_w12_async(float* dst, int ld, const float* __restrict__ w, int C,
                                       int cp) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = warp; o < O; o += kWarps) {
    for (int j = lane; j < K * cp; j += 32) {
      const int k = j / cp, c = j - k * cp;
      if (c < C) {
        cp_async4(dst + o * ld + j, w + static_cast<size_t>(o) * K * C + k * C + c);
      } else {
        dst[o * ld + j] = 0.f;
      }
    }
  }
}

// Zeros in the pad columns [0, kOff) and [kOff + nt8, ld) of O activation
// rows stored from column kOff: the 'same' convs' zero padding. Thread i
// of a team of `threads`.
template <int O, int K, int kOff = K / 2>
__device__ inline void zero_pads(float* dst, int ld, int nt8, int i, int threads) {
  const int tail = ld - kOff - nt8;
  const int per_row = kOff + tail;
  for (int e = i; e < O * per_row; e += threads) {
    const int o = e / per_row, j = e - o * per_row;
    dst[o * ld + (j < kOff ? j : nt8 + j)] = 0.f;
  }
}

// dst[o, kOff + t] = epi(o, t, sum_r A[o, r] * src[c, t + shift]) for the
// nt8 columns t, r = k * Ch + c over K * Ch, and zeros in dst's pad
// columns (dst is stored from column kOff: K/2, or K - 1 for B2x's dh1).
// src is the window (stored from column 0) or an activation (from column
// K/2, so a 'same' conv's shift is the tap k too).
//  * kT false (a conv): A[o, k*Ch + c] = a_i[(o - 16 i) * lda + k*Ch + c] for
//    the row halves i = 0, 1 (a1 may be anywhere), and shift = k.
//  * kT true (the input gradient of a 'same' conv with weight w at a0,
//    w[o', k*O + o] at a0[o' * lda + k*O + o], Ch = O): A[o, k*O + o'] =
//    w[o', k*O + o] read in place, and shift = K - 1 - k.
// A team of kTeam warps (tw its warp) covers both 16-row tiles of the
// 8-column tiles tw, tw + kTeam, ... (NT at a time; a tile past the end is
// computed as the last one and not stored).
template <int K, bool kT, int NT, int kTeam, int kOff = K / 2, class Epi>
__device__ inline void conv_tc(float* dst, int ld, const float* a0, const float* a1, int lda,
                               const float* src, int lds, int Ch, int nt8, int tw, Epi epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int tiles = nt8 >> 3;
  zero_pads<32, K, kOff>(dst, ld, nt8, tw * 32 + lane, kTeam * 32);
  for (int base = tw; base < tiles; base += kTeam * NT) {
    int col[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) col[j] = 8 * min(base + kTeam * j, tiles - 1) + g;
    float acc[2][NT][4] = {};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int shift = kT ? K - 1 - k : k;
      const float* pb = src + q * lds + shift;
      const float* pa0 = kT ? a0 + q * lda + k * 32 + g : a0 + g * lda + k * Ch + q;
      const float* pa1 = kT ? pa0 + 16 : a1 + g * lda + k * Ch + q;
      const int a_row8 = kT ? 8 : 8 * lda;  // a1 - a0 (rows g + 8)
      const int a_col4 = kT ? 4 * lda : 4;  // a2 - a0 (reduction q + 4)
      const int a_step = kT ? 8 * lda : 8;  // one reduction step
#pragma unroll kUnrollTc
      for (int c0 = 0; c0 < Ch; c0 += 8) {
        float a[2][4], b[NT][2];
        if (kT) {
          const float* p0 = pa0 + (c0 / 8) * a_step;
          const float* p1 = pa1 + (c0 / 8) * a_step;
          a[0][0] = p0[0];
          a[0][1] = p0[a_row8];
          a[0][2] = p0[a_col4];
          a[0][3] = p0[a_row8 + a_col4];
          a[1][0] = p1[0];
          a[1][1] = p1[a_row8];
          a[1][2] = p1[a_col4];
          a[1][3] = p1[a_row8 + a_col4];
        } else {
          ldmatrix_a(a[0], a0 + k * Ch + c0, lda);
          ldmatrix_a(a[1], a1 + k * Ch + c0, lda);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* p = pb + c0 * lds + col[j];
          b[j][0] = p[0];
          b[j][1] = p[4 * lds];
        }
        mma3_step<2, NT>(acc, a, b);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (base + kTeam * j < tiles) {
        const int c = col[j] - g + 2 * q;
#pragma unroll
        for (int i = 0; i < 2; ++i) {
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = 16 * i + 8 * h + g;
            *reinterpret_cast<float2*>(dst + row * ld + kOff + c) =
                make_float2(epi(row, c, acc[i][j][2 * h]), epi(row, c + 1, acc[i][j][2 * h + 1]));
          }
        }
      }
    }
  }
}

}  // namespace isd
