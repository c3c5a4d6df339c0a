// Forward of the fused sliding-window Conv4Layers zone head, for Hopper
// (kernel B2f).
//
// Replaces the forward Pallas kernel of
// imagined_speech_decoding_tpu/ops/pallas/conv4head.py (_fwd_kernel, called
// by _fwd_impl). Per model m, trial b, window n and zone z it computes
//
//   h1[o, t] = b12[m, z*O + o] + sum_{k, c} w12[m, z*O + o, k*C + c] * x[m, b, c, n*step + t + k]
//   h2 = 'same' K-tap conv of h1 with w3[m, z]   (zero padding at the window edges)
//   h3 = 'same' K-tap conv of h2 with w4[m, z]
//   out[m, b, n, z*O + o] = mean_t gelu(h3[o, t])  (exact erf GELU)
//
// for t in [0, t1), t1 = W - K + 1. The operand layouts are the ones that
// imagined_speech_decoding_tpu_torch.models.heads.Conv4LayersHead
// .fused_weights returns, with a leading model axis M: w12
// (M, Z*O, K*C) and w3, w4 (M, Z, O, K*O), all tap-major. x is
// (M, B, C, T): each model trains on its own batch. The Pallas kernel gets
// the model axis from jax.vmap as an outer grid dimension; here it is the
// grid's z index. Its channel-major input and its 246 -> 256 lane padding
// were Mosaic constraints and are gone.
//
// What bounds it on the H100: work. At full width (C = 64, O = 32, K = 5,
// t1 = 246) one (trial, window, zone) costs 5.04 M FMAs (h1 2.52 M, h2 and
// h3 1.26 M each) against a 64 KB window that every product reuses from
// shared memory; a training step of 75 models at batch 64 is 0.97 T FMAs.
// Its bound is the fastest f32-accurate route, three TF32 tensor-core
// passes at 495 TFLOP/s: 11.7 ms for that step's forward.
//
// The design: the three products of B2w's recompute, through the same
// helper (conv4head_tc.cuh), then GELU and the mean:
//   h1 = w12z . P + b12z    32 x nt8 x K*Cp   P[k*Cp + c, t] = xs[c, t + k]
//   h2 = conv3(h1)          32 x nt8 x K*O    ('same')
//   g3 = gelu(conv4(h2))    32 x nt8 x K*O    into h1's buffer, dead by then
//   out[o] = sum_{t < t1} g3[o, t] / t1      one warp per row
//  * Every product is an mma.sync m16n8k8 TF32 with each f32 operand split
//    in registers into hi + lo, lo*hi + hi*lo + hi*hi into f32
//    accumulators (mma_tf32.cuh): f32 accuracy at the plain version's
//    tolerances.
//  * One block per (zone, window, trial range), 16 warps, one block per SM.
//    The zone's w12, w3 and w4 and the bias stay resident for the range.
//    The window has one buffer: it is dead once h1 is done, so the next
//    trial's window streams in by cp.async during h2, h3 and the mean.
//    The wrapper picks S trial ranges per (zone, window) so that serving
//    (M = 1, a few trials) still gives every SM a block.
//  * Any C: the window is staged with zero rows C..Cp-1 (Cp = C rounded up
//    to 8; written once, never restaged) and w12 with per-tap stride Cp and
//    zero columns, so a reduction step of 8 never straddles two taps. t1
//    that is not a multiple of 8 is handled by the epilogues' zeros.
//  * Each output element is written once, by one block: no partials, no
//    atomics, and reruns are bit-identical.
//  * Tried on an H100 and no faster: row strides of 8 mod 32 (which make
//    the convs' B fragments free of bank conflicts) and 8 warps of 2 x 4
//    tiles each. wgmma and TMA are left to a later step, as in B2w.
//  * Long windows: the plan holds a whole window up to 284 samples at C =
//    64 (228,992 B), 260 at C = 72 and 636 at C = 8 (the card allows
//    232,448). Past that a unit runs its window in column tiles of 256
//    conv rows (conv4head_common.cuh, B2w's geometry): tile j stages the
//    window's columns [240 j, 240 j + 260) on the plan of windows of 260
//    samples (216,704 B at C <= 64, 230,144 B at C = 72; C = 80 fits
//    neither plan), computes h1, h2 and gelu(h3) over its rows (zero from
//    the window's end on, so the convs keep their zero padding there), and
//    adds to the mean only the rows it owns, [8, 248) at an interior edge:
//    the two 'same' convs reach two rows each, so gelu(h3) is exact 4 rows
//    inside an edge, and the 8-row halo keeps one tile geometry for B2f,
//    B2w and B2w-bf16. The mean is the only state across tiles: each lane
//    keeps its share of its warp's two rows in registers over a trial's
//    tiles, in order, and the warp writes sum / t1 once, after the last.
//    A block's units are then (trial, tile) pairs; the next unit's columns
//    stream in during h2, gelu(h3) and the mean, as the next trial's window
//    does. At windows of 500 a unit computes 2 x 256 rows for 496.
// O and K are template arguments, instantiated only for the shipped
// model's O = 32, K = 5; C = 64 with W = 250 (the shipped geometry) gets
// compile-time strides beside a generic instantiation, and column tiles
// get their own at C = 64 and at any C (one layout for every window).
// ops/cuda/conv4head.py mirrors the plans and tiles (fwd_smem_bytes,
// fwd_col_tiles).

#include <cuda_runtime.h>

#include "conv4head_common.cuh"
#include "conv4head_tc.cuh"

namespace {

using isd::round_up4;

constexpr int kWarpsF = 16;          // B2f's block: 16 warps, one block per SM
constexpr int kNtF = 32 / kWarpsF;  // 8-column tiles per warp (31 time tiles at full width)

// Shared-memory plan of a B2f block, in floats; every region starts
// 16-byte aligned: the window (Cp rows), h1 (later gelu(h3)) and h2 (O
// rows each, at stride ld), then the resident w12 (O rows of K*Cp at
// stride lw1), w3, w4 (O rows of K*O at stride lw) and the bias.
struct FwdPlan : isd::TcStrides {
  int cp;  // C rounded up to a multiple of 8
  int xs, ha, hb, w12, w3, w4, bias, total;
};

__host__ __device__ inline FwdPlan fwd_plan(int C, int W, int O, int K) {
  FwdPlan p;
  p.cp = (C + 7) & ~7;
  static_cast<isd::TcStrides&>(p) = isd::tc_strides(p.cp, W, O, K);
  p.xs = 0;
  p.ha = round_up4(p.cp * p.ld);
  p.hb = p.ha + round_up4(O * p.ld);
  p.w12 = p.hb + round_up4(O * p.ld);
  p.w3 = p.w12 + round_up4(O * p.lw1);
  p.w4 = p.w3 + round_up4(O * p.lw);
  p.bias = p.w4 + round_up4(O * p.lw);
  p.total = p.bias + round_up4(O);
  return p;
}

// The plan a B2f launch takes for windows of W: the whole window where it
// fits a block, else column tiles (isd::kColSpan, conv4head_common.cuh),
// each staging kColSpan + K - 1 window columns on the plan of windows of
// that length, whatever W is (mirrored by fwd_smem_bytes in
// ops/cuda/conv4head.py).
__host__ __device__ inline bool f_tiled(int C, int W, int O, int K) {
  return static_cast<int>(sizeof(float)) * fwd_plan(C, W, O, K).total > isd::kMaxSmemBytes;
}

__host__ __device__ inline FwdPlan f_plan(int C, int W, int O, int K) {
  return fwd_plan(C, f_tiled(C, W, O, K) ? isd::kColSpan + K - 1 : W, O, K);
}

// B2f: block (z, p = n * S + s, m) covers trials [s*B/S, (s+1)*B/S) of
// window n of model m. Per unit, four phases between barriers (h1 | h2,
// the next unit's cp.async | gelu(h3) | the mean). A unit is a trial, or
// in column tiles (kW < 0) a (trial, tile) pair, the tiles of a trial in
// turn: tile j stages the window's columns [s, s + kColSpan + K - 1), s =
// kColStep j, computes rows [0, nt8) of its own (row t is the window's s +
// t; zero from the window's end e = t1 - s on), and adds to the mean the
// rows it owns, [kColHalo, kColSpan - kColHalo) at interior edges. kC > 0
// fixes C at compile time, kW > 0 W (the shipped model's geometry); in
// column tiles the plan is one layout for every W, so kC alone fixes it;
// 0 takes them from the arguments.
template <int O, int K, int kC, int kW>
__global__ void __launch_bounds__(kWarpsF * 32, 1)
conv4head_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w12,
                     const float* __restrict__ b12, const float* __restrict__ w3,
                     const float* __restrict__ w4, float* __restrict__ out, int B, int C_arg,
                     int T, int Z, int N, int W_arg, int step, int S) {
  static_assert(O == 32, "two 16-row tiles of O");
  constexpr bool kTiled = kW < 0;
  constexpr int kSpanCols = isd::kColSpan + K - 1;  // a column tile's window columns
  constexpr int kRows = O / kWarpsF;                // rows of the mean a warp owns
  const int C = kC > 0 ? kC : C_arg, W = kW > 0 ? kW : W_arg;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int z = blockIdx.x, p = blockIdx.y, m = blockIdx.z;
  const int n = p / S, s = p - n * S;
  const int t1 = W - K + 1;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const FwdPlan plan = fwd_plan(C, kTiled ? kSpanCols : W, O, K);
  const int ld = plan.ld, cp = plan.cp, lw1 = plan.lw1, lw = plan.lw;
  const int tiles = kTiled ? isd::col_tile_count(t1) : 1;
  float* xs = smem + plan.xs;
  float* ha = smem + plan.ha;
  float* hb = smem + plan.hb;
  float* w12s = smem + plan.w12;
  float* w3s = smem + plan.w3;
  float* w4s = smem + plan.w4;
  float* bias = smem + plan.bias;
  const size_t zo = (static_cast<size_t>(m) * Z + z) * O;  // the zone's first row in model m
  const size_t x_win = static_cast<size_t>(n) * step;
  const int b0 = s * B / S, b1 = (s + 1) * B / S;
  const int units = (b1 - b0) * tiles;
  // Unit u's window columns: its trial's window from the tile's first column.
  const auto unit_x = [&](int u) {
    const int bi = kTiled ? u / tiles : u;
    return x + (static_cast<size_t>(m) * B + b0 + bi) * C * T + x_win +
           (kTiled ? (u - bi * tiles) * isd::kColStep : 0);
  };
  const auto unit_cols = [&](int u) {
    return kTiled ? min(kSpanCols, W - (u % tiles) * isd::kColStep) : W;
  };

  isd::stage_w12_async<O, K, kWarpsF>(w12s, lw1, w12 + zo * K * C, C, cp);
  isd::stage_rows_async<kWarpsF>(w3s, w3s + 16 * lw, lw, w3 + zo * K * O, K * O);
  isd::stage_rows_async<kWarpsF>(w4s, w4s + 16 * lw, lw, w4 + zo * K * O, K * O);
  isd::stage_window_async<kWarpsF>(xs, ld, unit_x(0), C, T, unit_cols(0));
  for (int i = threadIdx.x; i < (cp - C) * ld; i += blockDim.x) xs[C * ld + i] = 0.f;
  if (threadIdx.x < O) bias[threadIdx.x] = b12[zo + threadIdx.x];
  isd::cp_async_wait_all();
  __syncthreads();

  float sum[kRows] = {};  // this lane's share of rows warp, warp + kWarpsF over a trial's tiles
  for (int u = 0; u < units; ++u) {
    const int bi = kTiled ? u / tiles : u, j = kTiled ? u - bi * tiles : 0;
    const size_t mb = static_cast<size_t>(m) * B + b0 + bi;
    // The tile's rows: e = the window's end; nt8 computed (whole 8-row
    // tiles); [r0, r1) owned (rows from e on are zero).
    const int e = t1 - j * isd::kColStep;
    const int nt8 = kTiled ? min((e + 7) & ~7, plan.nt8) : plan.nt8;
    const int r0 = j > 0 ? isd::kColHalo : 0;
    const int r1 = j + 1 < tiles ? isd::kColSpan - isd::kColHalo : e;
    const auto same = [&](int, int t, float v) { return t < e ? v : 0.f; };
    isd::conv_tc<K, false, kNtF, kWarpsF>(  // h1
        ha, ld, w12s, w12s + 16 * lw1, lw1, xs, ld, cp, nt8, warp,
        [&](int o, int t, float v) { return t < e ? v + bias[o] : 0.f; });
    __syncthreads();
    if (u + 1 < units) {  // the window is dead: the next unit's columns stream in meanwhile
      isd::stage_window_async<kWarpsF>(xs, ld, unit_x(u + 1), C, T, unit_cols(u + 1));
    }
    isd::conv_tc<K, false, kNtF, kWarpsF>(  // h2
        hb, ld, w3s, w3s + 16 * lw, lw, ha, ld, O, nt8, warp, same);
    __syncthreads();
    isd::conv_tc<K, false, kNtF, kWarpsF>(  // gelu(h3), into h1's buffer
        ha, ld, w4s, w4s + 16 * lw, lw, hb, ld, O, nt8, warp,
        [&](int, int t, float v) { return t < e ? isd::gelu(v) : 0.f; });
    __syncthreads();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {  // the mean over the rows the unit owns
      const float* row = ha + (warp + i * kWarpsF) * ld + K / 2;
      for (int t = r0 + lane; t < r1; t += 32) sum[i] += row[t];
    }
    if (j + 1 == tiles) {  // the trial's last unit: each row's mean over its t1 real steps
#pragma unroll
      for (int i = 0; i < kRows; ++i) {
        float v = sum[i];
#pragma unroll
        for (int off = 16; off > 0; off /= 2) v += __shfl_down_sync(0xffffffffu, v, off);
        if (lane == 0) out[(mb * N + n) * Z * O + z * O + warp + i * kWarpsF] = v / t1;
        sum[i] = 0.f;
      }
    }
    isd::cp_async_wait_all();
    __syncthreads();
  }
}

template <int O, int K>
cudaError_t launch(const float* x, const float* w12, const float* b12, const float* w3,
                   const float* w4, float* out, int M, int B, int C, int T, int Z, int W,
                   int step, int N, int S, cudaStream_t st) {
  const size_t smem_bytes = sizeof(float) * f_plan(C, W, O, K).total;
  // The shipped model's geometry (64 channels, windows of 250) gets compile-time strides,
  // and so do column tiles at 64 channels (one layout for every W).
  const auto kernel = !f_tiled(C, W, O, K)
                          ? ((C == 64 && W == 250) ? conv4head_fwd_kernel<O, K, 64, 250>
                                                   : conv4head_fwd_kernel<O, K, 0, 0>)
                          : (C == 64 ? conv4head_fwd_kernel<O, K, 64, -1>
                                     : conv4head_fwd_kernel<O, K, 0, -1>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Z, N * S, M), kWarpsF * 32, smem_bytes, st>>>(x, w12, b12, w3, w4, out, B, C, T,
                                                              Z, N, W, step, S);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one B2f block, in bytes: the whole window's
// plan where it fits a block, else the column tiles' (the wrapper checks
// it against the card's per-block limit before launching).
extern "C" int isd_conv4head_smem_bytes(int C, int W, int O, int K) {
  return static_cast<int>(sizeof(float)) * f_plan(C, W, O, K).total;
}

// Units of one (trial, window) in B2f: 1 where the whole window's plan
// fits a block, else its column tiles.
extern "C" int isd_conv4head_fwd_col_tiles(int C, int W, int O, int K) {
  return f_tiled(C, W, O, K) ? isd::col_tile_count(W - K + 1) : 1;
}

// x (M, B, C, T), w12 (M, Z*O, K1*C), b12 (M, Z*O), w3/w4 (M, Z, O, K2*O)
// (w3 and w4 16-byte aligned), out (M, B, N, Z*O); all f32, contiguous, on
// the device. S trial ranges per (zone, window), 1 <= S <= B. K1 must
// equal K2. Returns a cudaError_t (0 on success).
extern "C" int isd_conv4head_fwd(const float* x, const float* w12, const float* b12,
                                 const float* w3, const float* w4, float* out, int M, int B,
                                 int C, int T, int Z, int O, int K1, int K2, int W, int step,
                                 int N, int S, void* stream) {
  if (M < 1 || B < 1 || C < 1 || Z < 1 || N < 1 || K1 < 1 || K2 < 1 || W < K1 || step < 1 ||
      (N - 1) * step + W > T || S < 1 || S > B || M > 65535 ||
      static_cast<long long>(N) * S > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O == 32 && K1 == 5 && K2 == 5) {
    return launch<32, 5>(x, w12, b12, w3, w4, out, M, B, C, T, Z, W, step, N, S, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
