// Forward of the fused sliding-window Conv4Layers zone head in bf16, for
// Hopper (kernel B2f-bf16): the training path's default precision.
//
// Replaces the forward Pallas kernel of
// imagined_speech_decoding_tpu/ops/pallas/conv4head.py (_fwd_kernel, called
// by _fwd_impl) when x is bf16 (dt = xt.dtype there), and rounds where it
// rounds (_fwd_kernel :151-162): x is bf16, w12, w3 and w4 are rounded to
// bf16, and every product accumulates in f32:
//   h1 = bf16(acc(w12 . p) + b12)      (b12 added in f32 before the rounding)
//   h2 = bf16(acc(w3 . pad(h1)))       (each window's 'same' conv: zero pads
//   h3 = acc(w4 . pad(h2))  f32         at the window's edges)
//   out[m, b, n, z*O + o] = mean_t gelu(h3[o, t])   (GELU in f32)
// Operand layouts are conv4head.cu's: x (M, B, C, T) bf16; w12 (M, Z*O,
// K*C), b12 (M, Z*O), w3 / w4 (M, Z, O, K*O), all f32; out f32.
//
// What bounds it on the H100: work. The Pallas kernel's products are
// 5.04 M multiply-adds a (trial, window, zone) at full width, 0.97 T for a
// training step of 75 models at batch 64: 1.96 ms at the data sheet's 989
// TFLOP/s dense bf16. This kernel runs the first conv once per (trial,
// zone) over the (N-1) * step + t1 = 746 h1 columns the windows use
// (N * t1 = 1,230 before): 20% fewer products. On this route the
// shared-memory operands bound it first: a m64n32k16 reads 3 KB for 32 K
// multiply-adds and peaks at 653 TFLOP/s on the card (mma_tf32_ceiling.py
// --mode wgmma).
//
// The design:
//  * A persistent grid, one block per SM (16 warps = 4 warpgroups), each
//    a contiguous run of (model, zone, trial) items in that order: the
//    zone's weights are staged when the run reaches a new (model, zone),
//    and every output is written by the one block that owns its item.
//  * Every product is a warpgroup GEMM, wgmma.mma_async m64n32k16 with both
//    operands in shared memory (wgmma_bf16.cuh, conv4head_wgmma.cuh), M =
//    time, N = O = 32, K = (tap, channel); buffers in chunks of 8 channels,
//    [chunk][row][8], so that a tap is a row (+16 bytes).
//  * h1 over the sequence: sub-blocks of 256 columns, a 64-row tile a
//    warpgroup. x streams in channel-major by 16-byte cp.async one
//    sub-block ahead (the next trial's first behind the last), issued
//    while h1's products of the sub-block before are in flight, and is
//    turned time-major by ldmatrix.trans and stmatrix; the next trial's
//    rows are asked into L2 an item ahead. 96 KB of x a trial would leave
//    no room for h1; a sub-block is 33 KB.
//  * Window rows: a window's 'same' conv2 must read zeros, not its
//    neighbours' columns, at its edges. So the h1 epilogue stores each
//    column into every window that holds it (one or two at step 125),
//    stacked window after window with K-1 zero rows between them; conv2
//    of a window reads its own rows (the tile rows past t1 read the next
//    window's and are dropped).
//  * The windows by two teams of two warpgroups, a phase apart: in phase p
//    team A writes h2 of window p into one of two buffers, team B runs h3
//    of window p - 1 from the other and keeps it in registers for its GELU
//    at the start of phase p + 1, while team A's products are in flight.
//    (In lockstep, every warpgroup issuing, then every one running GELU,
//    the tensor pipe idled through the GELU.) GELU is branch-free (a branch
//    while a wgmma is in flight makes ptxas serialise every wgmma of the
//    kernel): max(v, 0) - |v| erfc(|v|/sqrt 2) / 2, erfc from a polynomial
//    in the exponent (|err| <= 7.5e-7; ops/cuda/conv4head.py, gelu_fit).
//  * h3 never leaves the registers: each lane sums GELU over its rows, team
//    B's per-warp column sums go to shared memory and are added in warp order,
//    so reruns are bit-identical.
//  * Each phase's generic stores that a wgmma reads are fenced for the
//    async proxy (fence.proxy.async) before the barrier that ends it.
// O and K are template arguments, instantiated for O = 32, K = 5; the
// shipped geometry (C = 64, W = 250, step 125, N = 5) gets compile-time
// strides beside a generic instantiation, and a debug instantiation
// (kClock) adds per-phase clock counters (phase_clock.cuh). The shared
// memory (224,640 bytes at full width, 226,048 with the counters, of
// 232,448) holds a trial's N windows up to C = 64 at windows of 250; the
// wrapper runs a longer trial or more channels in groups of windows (C up
// to 104 at windows of 250, one a launch). Windows past t1 = 256 take the
// generic instantiation's rounds of four tiles. T even.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "conv4head_bf16.cuh"
#include "conv4head_wgmma.cuh"
#include "phase_clock.cuh"
#include "wgmma_bf16.cuh"

namespace {

using isd::chunk_off;
using isd::kGroups;
using isd::kRows;
using isd::kWarpsB;
using isd::round16;

constexpr int kSb = kGroups * kRows;  // h1 columns a sub-block: a 64-row tile a warpgroup
constexpr int kTeamWarps = kWarpsB / 2;  // the warps of a window team (two warpgroups)

// The phases of the debug instantiation's counters, in the order of
// ops/cuda/conv4head.py's FWD_BF16_PHASES.
enum FwdPhase {
  kFwStage,   // the wait for x's sub-block, its transpose, the weights' staging
  kFwCopy,    // h1's products and the next sub-block's cp.async issued
  kFwH1,      // the wait for h1's products
  kFwH1Epi,   // h1's epilogue into the windows' rows
  kFwIssue,   // a window phase's products issued (team A: h2; team B: h3)
  kFwH3Wait,  // team B: the wait for h3
  kFwGelu,    // team B: GELU of the h3 it holds, summed over its rows
  kFwH2Wait,  // team A: the wait for h2
  kFwH2Epi,   // team A: h2's epilogue
  kFwOut,     // team B's per-warp column sums; warp 0's outputs from them
  kFwBarrier,  // every __syncthreads, with the wait for the other team
  kFwPhases
};

// B2f-bf16's GELU exponent: erfc(a / sqrt 2) / 2 = 2^(a * P(a) - 1), a <
// kGeluClamp (ops/cuda/conv4head.py, GELU_EXP2_POLY and GELU_CLAMP).
constexpr float kGeluClamp = 5.656854152679443f;
__constant__ float kGeluP[5] = {-1.1509909629821777f, -0.4596169888973236f,
                                -0.05213385075330734f, 0.007197307422757149f,
                                -0.0004884926602244377f};

__device__ __forceinline__ float ex2_approx(float v) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(v));
  return r;
}

// gelu(v) = v Phi(v) = max(v, 0) - |v| erfc(|v| / sqrt 2) / 2, branch-free;
// past the clamp erfc is held at erfc(4) < 2e-8.
__device__ __forceinline__ float gelu_fit(float v) {
  const float a = fabsf(v), ac = fminf(a, kGeluClamp);
  float p = kGeluP[4];
#pragma unroll
  for (int i = 3; i >= 0; --i) p = fmaf(p, ac, kGeluP[i]);
  return fmaf(-a, ex2_approx(fmaf(p, ac, -1.f)), fmaxf(v, 0.f));
}

// Asks for the C rows of a trial's first `cnt` samples (x0: its row 0, rows
// at stride T) to be brought into L2, a 128-byte line a thread.
__device__ inline void prefetch_l2(const uint16_t* __restrict__ x0, int C, int T, int cnt) {
  const int lines = (cnt + 63) >> 6;
  for (int i = threadIdx.x; i < C * lines; i += blockDim.x) {
    const int c = i / lines;
    asm volatile("prefetch.global.L2 [%0];\n" ::"l"(x0 + static_cast<size_t>(c) * T +
                                                   64 * (i - c * lines)));
  }
}

// Shared-memory plan of a block, in bytes; mirrored by fwd_bf16_plan in
// ops/cuda/conv4head.py, which says what each field is.
struct FwdPlan {
  int cp, t1, nt, lh, nsb, lx, xr, rs, cs_x, cs_h1, cs_h2;
  int xs, raw, h1, h2, w12, w3, w4, bias, red, total;
};

__host__ __device__ inline FwdPlan fwd_plan(int C, int W, int step, int N, int O, int K) {
  FwdPlan p;
  p.cp = round16(C);
  p.t1 = W - K + 1;
  p.nt = (p.t1 + kRows - 1) / kRows * kRows;
  p.lh = (N - 1) * step + p.t1;
  p.nsb = (p.lh + kSb - 1) / kSb;
  p.lx = (N - 1) * step + W;
  p.xr = (kSb + K - 1 + 7) & ~7;
  p.rs = p.t1 + K - 1;
  p.cs_x = 16 * p.xr;
  p.cs_h1 = 16 * ((N - 1) * p.rs + p.nt + K - 1);
  p.cs_h2 = 16 * (p.nt + K - 1);
  int off = 0;
  p.xs = off;  // chunks up to a multiple of 4 (raw_to_xs stores 4 at a time)
  off += round16((p.cp + 31) / 32 * 4 * p.cs_x);
  p.raw = off;
  off += round16(2 * C * p.xr);
  p.h1 = off;
  off += round16(O / 8 * p.cs_h1);
  p.h2 = off;  // two buffers
  off += round16(2 * (O / 8) * p.cs_h2);
  p.w12 = off;
  off += round16(2 * K * p.cp * O);
  p.w3 = off;
  off += round16(2 * K * O * O);
  p.w4 = off;
  off += round16(2 * K * O * O);
  p.bias = off;
  off += round16(4 * O);
  p.red = off;  // two slots of team B's per-warp column sums
  off += round16(2 * 4 * kTeamWarps * O);
  p.total = off;
  return p;
}

// Samples [s0, s0 + cnt) of the C rows of a trial (x0: its row 0, rows at
// stride T, s0 even, T even) to raw[c * xr + j] by cp.async: 16 bytes a
// copy where every row's start is 16-byte aligned and cnt rounded up to 8
// stays inside the row (vec: T % 8 == 0, s0 % 8 == 0), else 4 bytes, cnt
// rounded up to even. Warp w copies rows w, w + 16, ...; a round past a
// row's end repeats its last copy.
__device__ inline void stage_raw(uint16_t* raw, int xr, const uint16_t* __restrict__ x0, int C,
                                 int T, int s0, int cnt, bool vec, int warp) {
  const int lane = threadIdx.x & 31;
  if (vec) {
    const int n16 = (cnt + 7) >> 3;
    for (int c = warp; c < C; c += kWarpsB) {
      for (int j0 = 0; j0 < n16; j0 += 32) {
        const int j = 8 * min(j0 + lane, n16 - 1);
        isd::cp_async16(reinterpret_cast<float*>(raw + c * xr + j),
                        reinterpret_cast<const float*>(x0 + static_cast<size_t>(c) * T + s0 + j));
      }
    }
  } else {
    const int words = (cnt + 1) >> 1;
    for (int c = warp; c < C; c += kWarpsB) {
      for (int j0 = 0; j0 < words; j0 += 32) {
        const int j = 2 * min(j0 + lane, words - 1);
        isd::cp_async4_b32(raw + c * xr + j, x0 + static_cast<size_t>(c) * T + s0 + j);
      }
    }
  }
}

// stage_raw's 16-byte copies with compile-time trip counts and no branch,
// for the shipped instantiation to issue while h1's products are in flight
// (a branch there serialises every wgmma): warp w copies rows w + 16 k,
// k < kC / 16, each in kRounds rounds of 32 copies, a round past the row's
// n16 copies repeating its last.
template <int kC, int kRounds>
__device__ __forceinline__ void stage_raw_unrolled(uint16_t* raw, int xr,
                                                   const uint16_t* __restrict__ x0, int T, int s0,
                                                   int n16, int warp) {
  static_assert(kC % kWarpsB == 0, "every warp takes the same rows");
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kC / kWarpsB; ++k) {
    const int c = warp + kWarpsB * k;
#pragma unroll
    for (int r = 0; r < kRounds; ++r) {
      const int j = 8 * min(32 * r + lane, n16 - 1);
      isd::cp_async16(reinterpret_cast<float*>(raw + c * xr + j),
                      reinterpret_cast<const float*>(x0 + static_cast<size_t>(c) * T + s0 + j));
    }
  }
}

// The raw sub-block into its time-major chunks: xs (row t, channel c) =
// raw[c * xr + t] for t < xr, channels C..cp-1 zero (and the chunks past
// cp / 8, up to a multiple of 4). A warp takes 8 rows of 4 chunks at a
// time: ldmatrix.trans of the four 8 x 8 (channel, time) matrices hands
// each lane the channel pair of one row, which is stmatrix's fragment of
// the four (time, channel) core matrices.
__device__ inline void raw_to_xs(char* xs, int cs, const uint16_t* raw, int xr, int C, int cp,
                                 int warp) {
  const int lane = threadIdx.x & 31, tblocks = xr >> 3, groups = (cp + 31) >> 5;
  const int c_pair = 2 * (lane & 3);  // + 8 chunk: this lane's channels in every matrix
  for (int grp = 0; grp < groups; ++grp) {
    const int c = min(8 * (4 * grp + (lane >> 3)) + (lane & 7), C - 1);
    for (int tb = warp; tb < tblocks; tb += kWarpsB) {
      uint32_t v[4];
      isd::ldsm_x4_t(v, raw + c * xr + 8 * tb);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c0 = 8 * (4 * grp + i) + c_pair;
        v[i] = c0 + 1 < C ? v[i] : (c0 < C ? v[i] & 0xFFFFu : 0u);
      }
      isd::stsm_x4(xs + (4 * grp + (lane >> 3)) * cs + 16 * (8 * tb + (lane & 7)), v);
    }
  }
}

template <int O, int K, int kC, int kW, int kStep, int kN, bool kClock>
__global__ void __launch_bounds__(kWarpsB * 32, 1)
conv4head_fwd_bf16_kernel(const uint16_t* __restrict__ x, const float* __restrict__ w12,
                          const float* __restrict__ b12, const float* __restrict__ w3,
                          const float* __restrict__ w4, float* __restrict__ out, int B, int C_arg,
                          int T, int Z, int N_arg, int W_arg, int step_arg, int items,
                          unsigned long long* __restrict__ clk) {
  static_assert(O == 32, "four 8-channel chunks of O: one m64n32 tile");
  // The shipped geometry (launched only where the 16-byte copies apply).
  constexpr bool kShipped = kC > 0;
  const int C = kC > 0 ? kC : C_arg, W = kW > 0 ? kW : W_arg;
  const int step = kStep > 0 ? kStep : step_arg, N = kN > 0 ? kN : N_arg;
  extern __shared__ uint4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const uint32_t base = isd::smem_u32(smem);
  const FwdPlan plan = fwd_plan(C, W, step, N, O, K);
  const int t1 = plan.t1, tiles = plan.nt / kRows;
  // The warpgroup, through a shuffle so that the compiler knows it is the
  // same across the warp: every branch on it is then warp-uniform.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int wg = warp >> 2, lane = threadIdx.x & 31;
  uint16_t* raw = reinterpret_cast<uint16_t*>(smem + plan.raw);
  const float* bias = reinterpret_cast<const float*>(smem + plan.bias);
  float* red = reinterpret_cast<float*>(smem + plan.red);
  isd::PhaseClock<kClock, kFwPhases> clock(smem + plan.total);
  const int lo = static_cast<int>(static_cast<long long>(items) * blockIdx.x / gridDim.x);
  const int hi = static_cast<int>(static_cast<long long>(items) * (blockIdx.x + 1) / gridDim.x);
  // 16-byte copies where x's rows start on 16 bytes and the last sub-block's
  // copy, rounded up to 8 samples, stays inside a row.
  const bool vec = T % 8 == 0 && ((plan.lx + 7) & ~7) <= T;
  const auto stage_sb = [&](const uint16_t* x0, int sb) {
    stage_raw(raw, plan.xr, x0, C, T, kSb * sb, min(plan.xr, plan.lx - kSb * sb), vec, warp);
  };
  // Item it = (mz, b), mz = m * Z + z: x's row 0 of its trial.
  const auto trial = [&](int mz, int b) {
    return x + (static_cast<size_t>(mz / Z) * B + b) * C * T;
  };

  isd::zero_words(reinterpret_cast<uint32_t*>(smem), plan.w12 / 4);  // x, h1, h2: pads stay 0
  __syncthreads();
  if (lo < hi) stage_sb(trial(lo / B, lo % B), 0);

  // Accumulator tiles: h1's in 0; team A's h2 tiles in 0-1, team B's h3
  // tiles in 2-3. Each is defined by its first wgmma (scale-d 0) only.
  float acc[4][16];
  float* pending = nullptr;  // the outputs of a window whose column sums wait in red
  int pending_slot = 0;
  // Warp 0 adds the pending window's per-warp sums (team B's 8 warps) in
  // warp order and stores its 32 outputs. Called where no wgmma is in flight.
  const auto flush = [&] {
    if (pending != nullptr && warp == 0) {
      const float* slot = red + pending_slot * kTeamWarps * O;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kTeamWarps; ++w) sum += slot[w * 32 + lane];
      pending[lane] = sum / t1;
    }
    pending = nullptr;
  };
  const auto put = [&](int buf, int cs, int row, int o, uint32_t v) {
    *reinterpret_cast<uint32_t*>(smem + buf + chunk_off(cs, row, o)) = v;
  };

  int zone = -1;  // the (model, zone) whose weights are staged
  int mz = lo / B, b = lo - mz * B;  // the item's (model, zone) and trial
  for (int it = lo; it < hi; ++it, b = b + 1 < B ? b + 1 : 0, mz += b == 0) {
    const int z = mz % Z;
    const size_t m = static_cast<size_t>(mz / Z);
    const uint16_t* x_item = x + (m * B + b) * C * T;
    const uint16_t* x_next = b + 1 < B ? x_item + static_cast<size_t>(C) * T : trial(mz + 1, 0);
    float* out_b = out + ((m * B + b) * N) * Z * O + z * O;
    if (mz != zone) {  // the previous item's products are done (its last phase's wait and barrier)
      const size_t zo = static_cast<size_t>(mz) * O;
      isd::stage_weights_wg(smem + plan.w12, w12 + zo * K * C, O, K, C, plan.cp);
      isd::stage_weights_wg(smem + plan.w3, w3 + zo * K * O, O, K, O, O);
      isd::stage_weights_wg(smem + plan.w4, w4 + zo * K * O, O, K, O, O);
      if (threadIdx.x < O) {
        reinterpret_cast<float*>(smem + plan.bias)[threadIdx.x] = b12[zo + threadIdx.x];
      }
      zone = mz;
    }
    if (it + 1 < hi) prefetch_l2(x_next, C, T, plan.lx);  // read a trial from now

    // h1 = bf16(w12 . p + b12) over the used columns, into the windows' rows.
    for (int sb = 0; sb < plan.nsb; ++sb) {
      isd::cp_async_wait_all();
      flush();
      clock.sync(kFwStage);
      raw_to_xs(smem + plan.xs, plan.cs_x, raw, plan.xr, C, plan.cp, warp);
      isd::fence_proxy_async();  // the transpose, and the weights on a new zone
      clock.sync(kFwStage);
      // The raw buffer is free: the next sub-block streams in (this item's
      // next, or the next item's first; after the block's last, a harmless
      // copy of this item's first). The shipped instantiation issues it
      // under h1's products, branch-free.
      const bool more = sb + 1 < plan.nsb;
      const uint16_t* next_x = more ? x_item : (it + 1 < hi ? x_next : x_item);
      const int next_s0 = more ? kSb * (sb + 1) : 0;
      const auto copy_next = [&] {
        if constexpr (kShipped) {
          stage_raw_unrolled<kC, (kSb + K - 1 + 7) / 8 / 32 + 1>(
              raw, plan.xr, next_x, T, next_s0, (min(plan.xr, plan.lx - next_s0) + 7) >> 3, warp);
        } else if (more || it + 1 < hi) {
          stage_sb(next_x, next_s0 / kSb);
        }
      };
      const int u0 = kSb * sb + kRows * wg;  // this warpgroup's first h1 column
      if constexpr (!kShipped) copy_next();
      if (u0 < plan.lh) {
        isd::wgmma_fence();
        isd::conv_issue<K, O, false>(acc[0], base + plan.xs, plan.cs_x, base + plan.w12, plan.cp,
                                     wg);
        isd::wgmma_commit();
        if constexpr (kShipped) copy_next();
        clock.mark(kFwCopy);
        isd::wgmma_wait<0>();
        isd::fence_operand(acc[0]);
        clock.mark(kFwH1);
        const int w = warp & 3, g = lane >> 2, q = lane & 3;
        uint32_t packed[2][4];
#pragma unroll
        for (int h = 0; h < 2; ++h) {
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int o = 8 * j + 2 * q;
            packed[h][j] = isd::pack_bf16(acc[0][4 * j + 2 * h] + bias[o],
                                          acc[0][4 * j + 2 * h + 1] + bias[o + 1]);
          }
        }
        // Column u = u0 + 16 w + 8 h + g into every window i that holds it,
        // row i * rs + K/2 + u - i * step: channels o..o+1 of chunk j at
        // byte 16 row + 4 q + j * cs_h1.
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int u = u0 + 16 * w + 8 * h + g;
          if (u >= plan.lh) continue;
          for (int i = min(u / step, N - 1); i >= 0 && u - i * step < t1; --i) {
            char* dst = smem + plan.h1 + 16 * (i * (plan.rs - step) + K / 2 + u) + 4 * q;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              *reinterpret_cast<uint32_t*>(dst + j * plan.cs_h1) = packed[h][j];
            }
          }
        }
      } else if constexpr (kShipped) {
        copy_next();
      }
      isd::fence_proxy_async();
      clock.mark(kFwH1Epi);
    }
    clock.sync(kFwH1Epi);

    // The windows, by two teams of two warpgroups a phase apart: in phase p
    // team A (warpgroups 0-1) writes h2 of window p into buffer p % 2, and
    // team B (2-3) runs h3 of window p - 1 from the other buffer and keeps it
    // in registers until phase p + 1, where its GELU runs while team A's
    // products are in flight. A warpgroup takes time tiles 4 q + r and 4 q +
    // r + 2 of a window in round q: one round up to t1 = 256 (the shipped
    // instantiation's only), more for longer windows, each of team B's
    // rounds but the last taken through GELU in its own phase.
    const bool team_a = wg < 2;
    const int r = wg & 1;
    const int rounds = kShipped ? 1 : (tiles + 3) / 4;
    float carry[4][2] = {};  // team B: GELU sums of a window's earlier rounds
    // Team B: GELU of its h3 tiles of round q, summed over their rows into s.
    const auto gelu_round = [&](int q, float (&s)[4][2]) {
#pragma unroll
      for (int tt = 0; tt < 2; ++tt) {
        const int tile = 4 * q + r + 2 * tt;
        if (tile < tiles) {
          isd::conv_epilogue(acc[2 + tt], tile, [&](int jj, int t, int, float v0, float v1) {
            const float keep = t < t1 ? 1.f : 0.f;
            s[jj][0] = fmaf(gelu_fit(v0), keep, s[jj][0]);
            s[jj][1] = fmaf(gelu_fit(v1), keep, s[jj][1]);
          });
        }
      }
    };
    // Team B: its last round of window j through GELU, and its warps' column
    // sums into red's slot j % 2 ([warp - 8][o]).
    const auto gelu_sums = [&](int j) {
      gelu_round(rounds - 1, carry);
      isd::col_sums(red + (j & 1) * kTeamWarps * O - kTeamWarps * 32, carry);
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) carry[jj][0] = carry[jj][1] = 0.f;
    };
    for (int p = 0; p <= N; ++p) {
      flush();
      clock.mark(kFwOut);
      if (team_a && p < N) {
        const int h2_out = plan.h2 + (p & 1) * (O / 8) * plan.cs_h2;
        for (int q = 0; q < rounds; ++q) {
          isd::wgmma_fence();
#pragma unroll
          for (int tt = 0; tt < 2; ++tt) {
            if (4 * q + r + 2 * tt < tiles) {
              isd::conv_issue<K, O, false>(acc[tt], base + plan.h1 + 16 * p * plan.rs,
                                           plan.cs_h1, base + plan.w3, O, 4 * q + r + 2 * tt);
            }
          }
          isd::wgmma_commit();
          clock.mark(kFwIssue);
          isd::wgmma_wait<0>();
          isd::fence_operand(acc[0]);
          isd::fence_operand(acc[1]);
          clock.mark(kFwH2Wait);
#pragma unroll
          for (int tt = 0; tt < 2; ++tt) {
            if (4 * q + r + 2 * tt < tiles) {
              isd::conv_epilogue(acc[tt], 4 * q + r + 2 * tt,
                                 [&](int, int t, int o, float v0, float v1) {
                put(h2_out, plan.cs_h2, K / 2 + t, o, t < t1 ? isd::pack_bf16(v0, v1) : 0u);
              });
            }
          }
        }
        isd::fence_proxy_async();
        clock.mark(kFwH2Epi);
      } else if (!team_a && p >= 1) {
        if (p >= 2) {
          gelu_sums(p - 2);
          clock.mark(kFwGelu);
        }
        const int h2_in = plan.h2 + ((p - 1) & 1) * (O / 8) * plan.cs_h2;
        for (int q = 0; q < rounds; ++q) {
          if (q > 0) {  // the round before through GELU (never in the shipped instantiation)
            gelu_round(q - 1, carry);
            clock.mark(kFwGelu);
          }
          isd::wgmma_fence();
#pragma unroll
          for (int tt = 0; tt < 2; ++tt) {
            if (4 * q + r + 2 * tt < tiles) {
              isd::conv_issue<K, O, false>(acc[2 + tt], base + h2_in, plan.cs_h2, base + plan.w4,
                                           O, 4 * q + r + 2 * tt);
            }
          }
          isd::wgmma_commit();
          clock.mark(kFwIssue);
          isd::wgmma_wait<0>();
          isd::fence_operand(acc[2]);
          isd::fence_operand(acc[3]);
          clock.mark(kFwH3Wait);
        }
      }
      if (p >= 2) {
        pending = out_b + static_cast<size_t>(p - 2) * Z * O;
        pending_slot = (p - 2) & 1;
      }
      clock.sync(kFwBarrier);
    }
    flush();
    if (!team_a) {  // the last window's GELU
      gelu_sums(N - 1);
      clock.mark(kFwGelu);
    }
    pending = out_b + static_cast<size_t>(N - 1) * Z * O;
    pending_slot = (N - 1) & 1;
    clock.sync(kFwBarrier);
  }
  flush();  // after the last window's barrier
  clock.finish(clk);
}

template <int O, int K, bool kClock>
cudaError_t launch_f(const uint16_t* x, const float* w12, const float* b12, const float* w3,
                     const float* w4, float* out, int M, int B, int C, int T, int Z, int W,
                     int step, int N, int G, unsigned long long* clk, cudaStream_t st) {
  const FwdPlan plan = fwd_plan(C, W, step, N, O, K);
  const int smem_bytes = plan.total + (kClock ? isd::clock_bytes<kFwPhases>() : 0);
  if (smem_bytes > isd::kMaxSmemBytes) return cudaErrorInvalidValue;
  // The shipped model's geometry gets compile-time strides.
  const bool vec = T % 8 == 0 && ((plan.lx + 7) & ~7) <= T;  // the kernel's 16-byte copies
  const auto kernel = (C == 64 && W == 250 && step == 125 && N == 5 && vec)
                          ? conv4head_fwd_bf16_kernel<O, K, 64, 250, 125, 5, kClock>
                          : conv4head_fwd_bf16_kernel<O, K, 0, 0, 0, 0, kClock>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  if (err != cudaSuccess) return err;
  const int items = M * Z * B;  // fwd_bf16 checks that it fits an int
  kernel<<<G, kWarpsB * 32, smem_bytes, st>>>(x, w12, b12, w3, w4, out, B, C, T, Z, N, W, step,
                                              items, clk);
  return cudaGetLastError();
}

// B2f-bf16 on G blocks. `clk` null launches the shipped instantiation;
// otherwise the debug one, which adds its counters to clk[0, kFwPhases + 2).
int fwd_bf16(const void* x, const float* w12, const float* b12, const float* w3, const float* w4,
             float* out, int M, int B, int C, int T, int Z, int O, int K1, int K2, int W, int step,
             int N, int G, unsigned long long* clk, void* stream) {
  if (M < 1 || B < 1 || C < 1 || Z < 1 || N < 1 || K1 < 1 || K2 < 1 || W < K1 || step < 1 ||
      (N - 1) * step + W > T || T % 2 != 0 || G < 1 ||
      static_cast<long long>(M) * Z * B > 0x7fffffff || G > M * Z * B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint16_t* xb = static_cast<const uint16_t*>(x);
  if (O == 32 && K1 == 5 && K2 == 5) {
    return clk ? launch_f<32, 5, true>(xb, w12, b12, w3, w4, out, M, B, C, T, Z, W, step, N, G,
                                       clk, st)
               : launch_f<32, 5, false>(xb, w12, b12, w3, w4, out, M, B, C, T, Z, W, step, N, G,
                                        clk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dynamic shared memory of one B2f-bf16 block (shipped instantiation) for N
// windows of a trial, in bytes (fwd_bf16_plan in ops/cuda/conv4head.py).
extern "C" int isd_conv4head_fwd_bf16_smem_bytes(int C, int W, int step, int N, int O, int K) {
  return fwd_plan(C, W, step, N, O, K).total;
}

// x (M, B, C, T) bf16 (T even, 4-byte aligned), w12 (M, Z*O, K1*C),
// b12 (M, Z*O), w3/w4 (M, Z, O, K2*O), out (M, B, N, Z*O) f32; contiguous,
// on the device. G blocks, 1 <= G <= M*Z*B (one per SM at most is meant).
// K1 must equal K2. Returns a cudaError_t (0 on success).
extern "C" int isd_conv4head_fwd_bf16(const void* x, const float* w12, const float* b12,
                                      const float* w3, const float* w4, float* out, int M, int B,
                                      int C, int T, int Z, int O, int K1, int K2, int W, int step,
                                      int N, int G, void* stream) {
  return fwd_bf16(x, w12, b12, w3, w4, out, M, B, C, T, Z, O, K1, K2, W, step, N, G, nullptr,
                  stream);
}

// The debug instantiation: as isd_conv4head_fwd_bf16, adding its phase
// counters to clk (kFwPhases + 2 zeros on the device, see phase_clock.cuh).
extern "C" int isd_conv4head_fwd_bf16_phases(const void* x, const float* w12, const float* b12,
                                             const float* w3, const float* w4, float* out, int M,
                                             int B, int C, int T, int Z, int O, int K1, int K2,
                                             int W, int step, int N, int G, void* clk,
                                             void* stream) {
  if (clk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return fwd_bf16(x, w12, b12, w3, w4, out, M, B, C, T, Z, O, K1, K2, W, step, N, G,
                  static_cast<unsigned long long*>(clk), stream);
}
