// bf16 pieces of the Conv4Layers head kernels B2f-bf16
// (conv4head_fwd_bf16.cu) and B2w-bf16 (conv4head_bwd_w_bf16.cu): the
// shared-memory plan, staging, and the two GEMM shapes of the head on
// mma.sync m16n8k16 (mma_bf16.cuh).
//
// Layout: TIME-MAJOR. A bf16 fragment register holds two elements that are
// consecutive along the reduction axis, so every operand must have that
// axis contiguous in shared memory or be reached by ldmatrix(.trans).
//  * The convs reduce over (tap k, channel c). A tap shifts along time, and
//    a shift of one 2-byte column would split the pairs of a
//    channel-major row. Stored [t][c], channels contiguous, a tap is a
//    whole-row offset and the im2col operand src[t + k][c] is a row-major
//    A tile that ldmatrix reads as it is. So the convs are computed
//    transposed, D[t, o] = sum_r src[t + shift][r] * w[o][r]: M = time
//    (16-row tiles), N = O = 32 (four 8-column tiles), and the output pair
//    (t, o..o+1) is one bf16x2 word of the time-major result.
//  * B of a conv is w[o][k*Ch + c] ([n][k], k contiguous): ldmatrix. B of
//    a conv^T is w[o'][k*O + o] ([k][n]): ldmatrix.trans, so w3 and w4 are
//    staged once, untransposed.
//  * The weight gradients reduce over time: dw[o, (k, i)] = sum_t
//    d[t][o] * src[t + k][i]. Both operands are [t][...], time in rows:
//    ldmatrix.trans turns them into A = d^T and B fragments.
// Row strides are 4 mod 8 words, so the eight 16-byte rows of every
// ldmatrix matrix fall in distinct banks.
//
// The window: x is bf16 in device memory, channel-major. It is copied raw
// by 4-byte cp.async (T even: every row's window starts at the same
// parity, so the copy starts at the even element at or before it) into a
// staging buffer while the previous trial computes, then transposed into
// the time-major window at the top of the trial. Weights come in as f32
// and are rounded to bf16 (round to nearest even) as they are staged, as
// w.astype(x.dtype) does in the Pallas kernel; C is padded with zero
// channels to a multiple of 16, so a reduction step never straddles taps.

#pragma once

#include <cstdint>

#include <cuda_runtime.h>

#include "conv4head_common.cuh"
#include "conv4head_tc.cuh"
#include "mma_bf16.cuh"

namespace isd {

constexpr int kWarpsB = 16;  // a bf16 head block: 16 warps, one block per SM

// Shared-memory plan of a bf16 head block, in 32-bit words; every region
// starts 16-byte aligned. Window and activations have `rows` rows: time
// rows 0..W-1 of the window, activation time t at row K/2 + t, zero rows
// around them up to the farthest row a tap reaches (nt16 + K - 2).
struct Bf16Plan {
  int cp;    // channels of the staged window: C rounded up to 16
  int nt16;  // t1 rounded up to whole 16-row tiles
  int rows;  // nt16 + K - 1
  int ldx;   // window row stride (cp / 2 words)
  int lda;   // activation row stride (O / 2 words)
  int lw1;   // staged w12 row stride (K * cp / 2 words)
  int lw;    // staged w3 / w4 row stride (K * O / 2 words)
  int rw;    // raw window row stride, in bf16 elements (even, >= W + 1)
  int xs, raw, act[3], w12, w3, w4, bias, gz, red, total;
};

__host__ __device__ inline Bf16Plan bf16_plan(int C, int W, int O, int K, int n_act) {
  Bf16Plan p;
  p.cp = (C + 15) & ~15;
  p.nt16 = (W - K + 1 + 15) & ~15;
  p.rows = p.nt16 + K - 1;
  p.ldx = stride_4mod8(p.cp / 2);
  p.lda = stride_4mod8(O / 2);
  p.lw1 = stride_4mod8(K * p.cp / 2);
  p.lw = stride_4mod8(K * O / 2);
  p.rw = (W + 2) & ~1;
  int off = 0;
  p.xs = off;
  off += round_up4(p.rows * p.ldx);
  p.raw = off;
  off += round_up4((C * p.rw + 1) / 2);
  for (int i = 0; i < 3; ++i) {
    p.act[i] = off;
    if (i < n_act) off += round_up4(p.rows * p.lda);
  }
  p.w12 = off;
  off += round_up4(O * p.lw1);
  p.w3 = off;
  off += round_up4(O * p.lw);
  p.w4 = off;
  off += round_up4(O * p.lw);
  p.bias = off;
  off += round_up4(O);
  p.gz = off;
  off += round_up4(O);
  p.red = off;
  off += kWarpsB * O;
  p.total = off;
  return p;
}

// Rows o < O of w (f32, K taps of C channels each, row stride K*C) to
// dst[o * ld + (k * cp + c) / 2], rounded to bf16 pairs, zero for c in
// [C, cp) (cp even).
__device__ inline void stage_weights_bf16(uint32_t* dst, int ld, const float* __restrict__ w,
                                          int O, int K, int C, int cp) {
  const int half = K * cp / 2;
  for (int i = threadIdx.x; i < O * half; i += blockDim.x) {
    const int o = i / half, j = 2 * (i - o * half), k = j / cp, c = j - k * cp;
    const float* row = w + static_cast<size_t>(o) * K * C + k * C;
    dst[o * ld + j / 2] = pack_bf16(c < C ? row[c] : 0.f, c + 1 < C ? row[c + 1] : 0.f);
  }
}

// The C rows of a window of W samples, from x0 (the even element at or
// before the window's start in row 0; rows at stride T, T even), to
// raw[c * rw + j] by 4-byte cp.async: off + W elements rounded up to even,
// the window starting at j = off.
__device__ inline void stage_raw_async(uint16_t* raw, int rw, const uint16_t* __restrict__ x0,
                                       int C, int T, int W, int off) {
  const int words = (off + W + 1) >> 1;
  for (int i = threadIdx.x; i < C * words; i += blockDim.x) {
    const int c = i / words, j = 2 * (i - c * words);
    cp_async4_b32(raw + c * rw + j, x0 + static_cast<size_t>(c) * T + j);
  }
}

// The time-major window: xs[t * ldx + c / 2] = (x[c, t], x[c + 1, t]) for
// t < W from the raw rows; the pad channel of an odd C gets 0. Rows W.. and
// the words of channels cp.. are not written (zero from the block's start).
__device__ inline void raw_to_window(uint32_t* xs, int ldx, const uint16_t* raw, int rw, int off,
                                     int C, int W) {
  const int pairs = (C + 1) >> 1;
  for (int i = threadIdx.x; i < pairs * W; i += blockDim.x) {
    const int cw = i / W, t = i - cw * W, c = 2 * cw;
    const uint32_t lo = raw[c * rw + off + t];
    const uint32_t hi = c + 1 < C ? raw[(c + 1) * rw + off + t] : 0u;
    xs[t * ldx + cw] = lo | (hi << 16);
  }
}

// D[t, o] for t over the 16-row tiles and O = 32 columns o:
//   kT false (a conv, w staged [o][k*Ch + c]): sum_{k, c < Ch} src[t + k][c] * w[o][k*Ch + c]
//   kT true (the input gradient of a 'same' conv, Ch = O):
//     sum_{k, o'} src[t + K-1-k][o'] * w[o'][k*O + o]
// src time-major at row stride lds words (a window from row 0, an
// activation from row K/2, so a 'same' conv's shift is the tap k too).
// Warp tw of a team of kTeam takes the 16-row tiles tw, tw + kTeam, ...
// and all four 8-column tiles, and hands each pair of results (row t,
// columns o, o + 1) to out(j, t, o, v0, v1), j = o / 8, in f32.
template <int K, bool kT, int kTeam, class Out>
__device__ inline void conv_bf16(const uint32_t* src, int lds, const uint32_t* w, int lw, int Ch,
                                 int tiles, int tw, Out out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int r8 = lane & 7, mat = lane >> 3;
  for (int tile = tw; tile < tiles; tile += kTeam) {
    const int t0 = 16 * tile;
    float acc[4][4] = {};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int shift = kT ? K - 1 - k : k;
      // A: rows t0 + shift + (0..15), columns c0 + (0..15); matrix i of
      // ldmatrix .x4 is (rows 8 (i % 2), columns 8 (i / 2)): a0..a3.
      const uint16_t* pa =
          reinterpret_cast<const uint16_t*>(src + (t0 + shift + r8 + 8 * (mat & 1)) * lds) +
          8 * (mat >> 1);
      // B of two 8-column tiles a load: matrices (b0, b1) of columns 0..7,
      // then of columns 8..15.
      const uint16_t* pb =
          kT ? reinterpret_cast<const uint16_t*>(w + (r8 + 8 * (mat & 1)) * lw) + k * 32 +
                   8 * (mat >> 1)
             : reinterpret_cast<const uint16_t*>(w + (r8 + 8 * (mat >> 1)) * lw) + k * Ch +
                   8 * (mat & 1);
#pragma unroll 2
      for (int c0 = 0; c0 < Ch; c0 += 16) {
        uint32_t a[4], b0[4], b1[4];
        ldsm_x4(a, pa + c0);
        if (kT) {
          ldsm_x4_t(b0, pb + c0 * 2 * lw);
          ldsm_x4_t(b1, pb + c0 * 2 * lw + 16);
        } else {
          ldsm_x4(b0, pb + c0);
          ldsm_x4(b1, pb + c0 + 32 * lw);
        }
        mma_bf16(acc[0], a, b0[0], b0[1]);
        mma_bf16(acc[1], a, b0[2], b0[3]);
        mma_bf16(acc[2], a, b1[0], b1[1]);
        mma_bf16(acc[3], a, b1[2], b1[3]);
      }
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      out(j, t0 + g, 8 * j + 2 * q, acc[j][0], acc[j][1]);
      out(j, t0 + g + 8, 8 * j + 2 * q, acc[j][2], acc[j][3]);
    }
  }
}

// red[warp * 32 + o] = sum over this warp's lanes of s[j][e], o = 8j + 2q + e:
// the per-warp column sums of a conv_bf16 epilogue, summed over warps in a
// fixed order afterwards (no atomics).
__device__ inline void warp_col_sums(float* red, const float (&s)[4][2]) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      float v = s[j][e];
      v += __shfl_xor_sync(0xffffffffu, v, 4);
      v += __shfl_xor_sync(0xffffffffu, v, 8);
      v += __shfl_xor_sync(0xffffffffu, v, 16);
      if (lane < 4) red[warp * 32 + 8 * j + 2 * lane + e] = v;
    }
  }
}

// sum_w red[w * 32 + o] in warp order.
__device__ inline float sum_warps(const float* red, int o) {
  float s = 0.f;
#pragma unroll
  for (int w = 0; w < kWarpsB; ++w) s += red[w * 32 + o];
  return s;
}

// dw[o * ldw + k * Cg + i] (+)= sum_{t < nt16} d[K/2 + t][o] * src[t + k][i]
// for o < 32, k < K, i < Cg: the weight gradient of a conv whose input is
// src (time-major, Ch staged channels a row, i >= Cg zero padding and not
// stored) and whose output gradient is d (time-major from row K/2, zero
// from t1 on). Warp tw of a team of kTeam owns the 16-row tile tw % 2 of o
// and the 8-column tiles tw / 2, tw / 2 + kTeam / 2, ... (NT at a time; a
// tile past the end is computed as the last one and not stored); each lane
// adds its fragments into fixed elements of dw, or writes them if first.
template <int K, int NT, int kTeam>
__device__ inline void weight_grad_bf16(float* __restrict__ dw, int ldw, int Cg, bool first,
                                        const uint32_t* d, int ldd, const uint32_t* src, int lds,
                                        int Ch, int tiles16, int tw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int r8 = lane & 7, mat = lane >> 3;
  const int mt = tw & 1, group = tw >> 1;
  constexpr int kGroups = kTeam / 2;
  const int tiles = K * Ch / 8;
  // A = d^T by ldmatrix.trans: matrix i holds rows t 8 (i / 2).., columns o 16 mt + 8 (i % 2)..
  const uint16_t* pa = reinterpret_cast<const uint16_t*>(d + (K / 2 + r8 + 8 * (mat >> 1)) * ldd) +
                       16 * mt + 8 * (mat & 1);
  for (int base = group; base < tiles; base += kGroups * NT) {
    const uint16_t* pb[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n0 = 8 * min(base + kGroups * j, tiles - 1), k = n0 / Ch;
      // B by ldmatrix.x2.trans: rows t + k (8 (lane / 8 % 2)..), columns i0..i0+7.
      pb[j] = reinterpret_cast<const uint16_t*>(src + (k + r8 + 8 * (mat & 1)) * lds) + n0 - k * Ch;
    }
    float acc[NT][4] = {};
    for (int tt = 0; tt < tiles16; ++tt) {
      uint32_t a[4];
      ldsm_x4_t(a, pa + tt * 32 * ldd);
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        uint32_t b[2];
        ldsm_x2_t(b, pb[j] + tt * 32 * lds);
        mma_bf16(acc[j], a, b[0], b[1]);
      }
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (base + kGroups * j >= tiles) continue;
      const int n = 8 * (base + kGroups * j) + 2 * q, k = n / Ch, i = n - k * Ch;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float* row = dw + static_cast<size_t>(16 * mt + 8 * h + g) * ldw + k * Cg + i;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          if (i + e < Cg) row[e] = (first ? 0.f : row[e]) + acc[j][2 * h + e];
        }
      }
    }
  }
}

// Zeros in `words` 32-bit words from p.
__device__ inline void zero_words(uint32_t* p, int words) {
  for (int i = threadIdx.x; i < words; i += blockDim.x) p[i] = 0u;
}

}  // namespace isd
