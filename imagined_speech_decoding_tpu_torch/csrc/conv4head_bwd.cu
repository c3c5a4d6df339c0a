// Backward of the fused sliding-window Conv4Layers zone head, for Hopper:
// kernel B2w (weight gradients) and kernel B2x (input gradient).
//
// Replaces the backward Pallas kernels of
// imagined_speech_decoding_tpu/ops/pallas/conv4head.py, called by _bwd_rule:
// _bwd_w_kernel (B2w) and _bwd_x_kernel (B2x), with the zone helper
// _bwd_zone. As there, nothing of the forward is kept: per (model m,
// trial b, window n, zone z) the kernels recompute
//
//   h1 = w12z * patches(x window) + b12z,  h2 = conv3(h1),  h3 = conv4(h2)
//
// and backpropagate the cotangent g[m, b, n, z*O + o] of the time-mean:
//
//   dh3 = g / t1 * gelu'(h3)           (over the real t1 steps only: there is no pad)
//   dw4 += dh3 (x) h2,  dh2 = conv4^T(dh3)
//   dw3 += dh2 (x) h1,  dh1 = conv3^T(dh2)
//   db12 += sum_t dh1,  dw12 += dh1 (x) patches      (B2w)
//   dxw[c, w] += sum_{o, k} w12z[o, k*C + c] * dh1[o, w - k]    (B2x)
//
// Layouts are the forward's (conv4head.cu) with the model axis leading.
//
// What bounds it on the H100: work. At full width (C = 64, O = 32, K = 5,
// t1 = 246) one (trial, window, zone) costs ~12.6 M FMAs in B2w (the 5.0 M
// recompute, then dh2, dh1, dw4, dw3 at 1.26 M each and dw12 at 2.52 M) and
// 10.08 M in B2x (the recompute, dh2, dh1 and dx at 2.52 M); one training
// step of 75 models at batch 64 is ~2.4 T FMAs of B2w, one attribution
// step at 100 trials 40 G FMAs of B2x. All operands are reused hundreds
// of times from shared memory, so both are compute-bound. Their bound is
// the fastest f32-accurate route, three TF32 tensor-core passes at 495
// TFLOP/s: 29.3 ms for the training step's B2w (on the CUDA cores in f32,
// 67 TFLOP/s, it would be 72.2 ms), 0.49 ms for the attribution step's B2x.
//
// B2w: every product on the tensor cores, f32-exact (mma_tf32.cuh); the
// convs go through conv_tc (conv4head_tc.cuh), which B2f shares.
// The unit is eight small GEMMs with one side O = 32, plus GELU' and a
// row sum; t1 runs to nt8 = 248 columns (31 tiles of 8):
//   h1  = w12z . P + b12z   32 x nt8 x K*C   P[k*C + c, t] = xs[c, t + k]
//   h2  = conv3(h1), h3 = conv4(h2)          32 x nt8 x K*O each ('same')
//   dh3 = g / t1 * gelu'(h3)                 elementwise
//   dw4 += dh3 . im2col(h2)^T                32 x K*O x nt8
//   dh2 = conv4^T(dh3), dh1 = conv3^T(dh2)   32 x nt8 x K*O each
//   dw3 += dh2 . im2col(h1)^T                32 x K*O x nt8
//   dw12 += dh1 . P^T, db12 += sum_t dh1     32 x K*C x nt8
// What the design does about it:
//  * mma.sync m16n8k8 TF32 with each f32 operand split into hi + lo in
//    registers (one logical op and one subtraction) and lo*hi + hi*lo +
//    hi*hi into f32 accumulators: f32 accuracy at the tolerances of the
//    plain f32 version, where one TF32 pass keeps ~3 digits.
//  * Warp-level mma.sync and not wgmma: every B operand is an implicit
//    im2col, a view of a row of the window or of an activation shifted by
//    the tap. mma.sync fragments are loaded by the threads, so the shift is
//    index arithmetic. wgmma reads B from shared memory in its canonical
//    layout (K-major only for tf32) in 64-row tiles, while O = 32: it would
//    need the im2col written out. wgmma, TMA and warp specialisation are
//    left to a later step.
//  * 16 warps per block and one block per SM (200 KB of shared memory):
//    four warps per scheduler to hide the latency of the fragment loads
//    and of the mma chains. Each phase splits its 8-column tiles over the
//    warps; dw3 and dh1 run side by side on two teams of eight.
//  * Nothing is staged on the critical path but w12: the zone's w3 and w4
//    stay resident (conv^T reads them transposed in place), and the next
//    unit's window columns stream in by cp.async during the dw12 phase, into
//    the region whose activations are dead by then; the two regions swap
//    roles every unit. w12's halves go into space conv1 leaves free.
//  * Long windows: the plan holds a whole window up to 292 samples at C <=
//    64 (229,120 B) and 268 at C = 72 (230,912 B; the card allows
//    232,448). Past that a unit runs its window in column tiles of 256 conv
//    rows (conv4head_common.cuh, B2w-bf16's geometry): tile j stages the
//    window's columns [240 j, 240 j + 260) on the plan of windows of 260
//    samples (208,640 B at C <= 64, 225,280 B at C = 72; C = 80 fits
//    neither plan), recomputes the forward and the cotangents over its
//    rows, and adds to the weight gradients only the rows it owns, [8, 248)
//    at an interior edge: conv3, conv4 and their transposes reach two rows
//    each, so dh1 is exact 8 rows inside an edge. The reduction over time
//    runs in steps of 8, so an owned edge only moves its bounds. The
//    epilogues zero rows from the window's end on, and gz is g / t1 of the
//    window. A block's units are then (trial, tile) pairs; 32 time tiles
//    of 8 are exactly kNtConv a warp. At windows of 500 a unit computes 2
//    x 256 rows for 496; 0 spills, 117 registers (C = 64: compile-time
//    strides, one layout for every window) and 119 (any C), H100.
//  * Padding: activations are stored from column K/2 with zero columns
//    around them, the window from column 0 with zeros after it, so a tap's
//    shift never leaves the row and fragment loads need no branch. Every
//    epilogue writes exact zeros in the columns t1..nt8-1 (the 'same'
//    convs' zero padding; the sums over t of the weight gradients and db12
//    run over them) and in the row's pad columns.
//  * Row strides are 4 mod 8, so the A fragments (rows g, columns q) and
//    the B fragments of the weight gradients (rows g, columns q) are free
//    of bank conflicts; the B fragments of the convs (rows q, columns g)
//    and conv^T's A fragments take two wavefronts.
//  * Blocks run concurrently, so the TPU kernel's accumulation into output
//    blocks that every grid cell revisits does not carry over. Rows
//    z*O..(z+1)*O of dw12 and db12, and dw3[z], dw4[z], depend on zone z
//    alone, so a B2w block owns one (model, zone, window, trial range) and
//    accumulates into its own slice of a partial buffer (P = N * S
//    partials per model, S trial ranges chosen by the wrapper to fill the
//    SMs); a second, deterministic pass sums the P partials. Each lane adds
//    its accumulator fragments into fixed elements of the slice once per
//    unit (a trial, or a trial's column tile). No atomics: the result is
//    bit-identical from run to run.
//
// B2x: the same route from the same pieces. A unit is B2w's first six
// phases and one GEMM more, the input gradient:
//   h1, h2, h3 -> dh3, dh2, dh1             as B2w (conv_tc)
//   dxw += A . B   Cp x wp x K*O   A[c, k*O + o] = w12z[o, k*C + c],
//                                  B[k*O + o, w] = dh1[o, w - k]
// over the window's wp = W rounded up to 8 columns (256 at full width).
// Where the trouble lay, and what the design does about it:
//  * conv_tc has 32 output rows; dx has C. input_grad_tc is a GEMM of its
//    own: a warp owns two 16-row tiles of c and four 8-column tiles of w
//    (32 accumulators a lane), A read in place from the staged w12 rows
//    (rows c of A are columns k*Cp + c of w12z; the fragment loads take
//    two wavefronts, as conv^T's A does), B a view of dh1 shifted by the tap.
//  * dh1's reach: dx at w in [0, wp) reads dh1 at t = w - k from -(K - 1)
//    to wp - 1, past the K/2 zero columns and the row end of the other
//    activations. conv3^T writes dh1 from column K - 1 (conv_tc's kOff)
//    into a wider row (stride ldx >= K - 1 + wp: 260 floats against 252 at
//    full width, 1 KB), zeros on both sides, so the fragment loads need no
//    predicate; predicating the edge tiles would have put a select on
//    every B load of the loop, or split it in two.
//  * Where dx accumulates across zones: in the block's own slice of dxw in
//    global memory (L2 traffic, 64 KB a unit at full width): the block's
//    first zone writes, the later ones add, each lane into fixed elements.
//    Holding the C x wp tile in registers across the zones would take 32
//    more registers a thread beside the convs' fragments.
//  * Grid fill at M = 1: a block is one (trial, window, zone range) of a
//    model, 16 warps and 213,760 bytes of shared memory, one block per SM;
//    5 windows of 16 trials are 80 blocks for 132 SMs. The wrapper splits
//    the 8 zones into SZ ranges by counting waves of blocks
//    (ops/cuda/conv4head.py::_bwd_x_zone_splits: SZ = 8 at 16 trials, 1
//    at 100); with SZ > 1 each block writes a partial and B2w's
//    fixed-order pass sums them. No atomics: reruns are bit-identical.
//  * Staging: the window once per block, each zone's w12, w3 and w4 once
//    per zone. Blocks of several trials, with the next window streamed in
//    by cp.async behind the compute, were no faster on the card (1.645
//    against 1.522 ms at M = 1, B = 100, H100 80GB HBM3, 700 W; PERF.md).
//    Two activation buffers suffice: h1, dh3 and dh1 in a, h2 and dh2 in
//    b, each phase reading one and writing the other.
//  * Any C: the window gets zero rows C..Cp-1 and w12 zero columns, with
//    Cp = C rounded up to 32 (a pair of dx's row tiles), so a reduction
//    step of 8 never straddles two taps and every row of A that a warp
//    reads lies inside its tap.
//  * Long windows: the plan holds a whole window up to 284 samples at C =
//    64 (230,144 B; 217,856 B at windows of 260). Past that a unit runs its
//    window in B2w's column tiles (conv4head_common.cuh): tile j stages
//    the window's columns [240 j, 240 j + 260) on the plan of windows of
//    260 samples, recomputes h1 .. dh1 over its 256 rows (zero from the
//    window's end on; gz is g / t1 of the whole window) and keeps in dh1
//    only the rows it owns, [8, 248) at interior edges, exact zeros
//    elsewhere: a halo row kept would be counted twice. dx at window
//    column w reads dh1 rows w - 4 .. w, so the owned rows [lo, hi) reach
//    dx columns [lo, hi + K - 1), and two neighbouring tiles both reach
//    the K - 1 = 4 seam columns [240 j + 8, 240 j + 12) between them; dh1
//    is exact only 8 rows inside an edge, so no tile can take them alone.
//    The seam is summed in one block, in a fixed order, without atomics:
//    a block runs its zones in turn and each zone's tiles in turn, every
//    tile adds into the block's dxw slice, the seam columns always add, and
//    only the first zone writes, its other columns. Zones outside the
//    tiles, and not tiles outside the zones: a zone's 80 KB of weights is
//    then staged once (tiles outside would stage it once a tile), and the
//    66.5 KB window tile staged per (zone, tile) streams in by cp.async
//    behind the phases after h1 (the window is dead once h1 has read it).
//    At windows of 500 a (trial, window, zone) computes 2 x 256 rows and
//    2 x 256 dx columns, against 248 and 256 at the shipped windows: the
//    tiles are bound, as the whole window is, by the products on the
//    tensor cores, 2.05x the shipped unit's. C = 65-96 (Cp = 96) fits
//    neither plan (271,616 B tiled) and stays on B2x-g.
// Both kernels take O and K as template arguments, instantiated only for
// the shipped model's O = 32, K1 = K2 = 5, with compile-time strides for
// its C = 64, W = 250 beside a generic instantiation, and column tiles at
// C = 64 and at any C; B2w also needs C % 8 == 0 (a reduction step of 8
// rows never straddles two taps). ops/cuda/conv4head.py mirrors both plans
// and tiles (bwd_w_smem_bytes, bwd_w_col_tiles, bwd_x_smem_bytes,
// bwd_x_col_tiles).

#include <cuda_runtime.h>

#include "conv4head_common.cuh"
#include "conv4head_tc.cuh"
#include "sum_partials.cuh"

namespace {

using isd::round_up4;

// Per-model operand pointers.
struct Operands {
  const float* w12;  // (Z*O, K*C)
  const float* b12;  // (Z*O)
  const float* w3;   // (Z, O, K*O)
  const float* w4;
};

__device__ inline Operands model_operands(const float* w12, const float* b12, const float* w3,
                                          const float* w4, int m, int Z, int O, int K, int C) {
  Operands op;
  op.w12 = w12 + static_cast<size_t>(m) * Z * O * K * C;
  op.b12 = b12 + static_cast<size_t>(m) * Z * O;
  op.w3 = w3 + static_cast<size_t>(m) * Z * O * K * O;
  op.w4 = w4 + static_cast<size_t>(m) * Z * O * K * O;
  return op;
}

// ---- B2w on the tensor cores ----

using isd::conv_tc;
using isd::kUnrollTc;
using isd::stage_rows_async;
using isd::stage_window_async;
using isd::sum_partials;

constexpr int kWarpsW = 16;  // B2w's block: 16 warps, one block per SM

// 8-column tiles per warp in each phase, for the shipped geometry's 31 time
// tiles (32 in a column tile), K*O/8 = 20 column tiles of dw3/dw4 and K*C/8
// = 40 of dw12 (other geometries loop over more tiles, or compute some twice
// and store once).
constexpr int kNtConv = 32 / kWarpsW;                          // all warps, both row tiles
constexpr int kNtConvHalf = 64 / kWarpsW;                      // dh1 on half the warps
constexpr int kNtDw4 = (20 + kWarpsW / 2 - 1) / (kWarpsW / 2);  // all warps, one row tile
constexpr int kNtDw3 = 20 / (kWarpsW / 4);                     // half the warps
constexpr int kNtDw12 = 40 / (kWarpsW / 2);

// Shared-memory plan of a B2w block, in floats (strides from
// conv4head_tc.cuh, with Ch = C). Two regions r[0], r[1] take turns: one
// holds the (trial's) window, C rows at stride ld from column 0; the other
// the activations h1 (rows 0..O-1) and h2 (from O*ld), each row stored
// from column K/2. A third activation buffer c, the zone's w3 and w4
// (resident for the whole block), the cotangent row g/t1 and the bias
// follow. w12's 32 rows are staged per trial in two halves of 16 (row
// stride lw1) into h2's and c's space, which conv1 leaves free.
struct TcPlan : isd::TcStrides {
  int hsz;  // floats of one activation buffer, which also holds 16 rows of w12
  int r[2], c, w3, w4, gz, bias, total;
};

__host__ __device__ inline TcPlan tc_plan(int C, int W, int O, int K) {
  TcPlan p;
  static_cast<isd::TcStrides&>(p) = isd::tc_strides(C, W, O, K);
  p.hsz = round_up4(isd::max_int(O * p.ld, 16 * p.lw1));
  const int rsz = round_up4(isd::max_int(C * p.ld, O * p.ld + p.hsz));
  p.r[0] = 0;
  p.r[1] = rsz;
  p.c = 2 * rsz;
  p.w3 = p.c + p.hsz;
  p.w4 = p.w3 + round_up4(O * p.lw);
  p.gz = p.w4 + round_up4(O * p.lw);
  p.bias = p.gz + round_up4(O);
  p.total = p.bias + round_up4(O);
  return p;
}

// The plan a B2w launch takes for windows of W: the whole window where it
// fits a block, else column tiles (isd::kColSpan, conv4head_common.cuh),
// each staging kColSpan + K - 1 window columns on the plan of windows of
// that length, whatever W is (mirrored by bwd_w_smem_bytes in
// ops/cuda/conv4head.py).
__host__ __device__ inline bool w_tiled(int C, int W, int O, int K) {
  return static_cast<int>(sizeof(float)) * tc_plan(C, W, O, K).total > isd::kMaxSmemBytes;
}

__host__ __device__ inline TcPlan w_plan(int C, int W, int O, int K) {
  return tc_plan(C, w_tiled(C, W, O, K) ? isd::kColSpan + K - 1 : W, O, K);
}

// dw[o * ldw + n] (+)= sum_{r0 <= t < r1} d[o, K/2 + t] * src[i, t + k]
// for n = k * Ch + i < K * Ch: the weight gradient of a conv whose input is
// the window (src from column 0) or an activation (from column K/2), over
// the rows [r0, r1) (multiples of 8) that the unit owns. d is zero from the
// window's end on. A team of kTeam warps: warp tw owns the
// 16-row tile tw % 2 and the 8-column tiles tw / 2, tw / 2 + kTeam / 2, ...
// (NT at a time; a tile past the end is computed as the last one and not
// stored); each lane adds its fragments into fixed elements of dw.
template <int K, int NT, int kTeam>
__device__ inline void weight_grad_tc(float* __restrict__ dw, int ldw, bool first, const float* d,
                                      int ld, const float* src, int lds, int Ch, int r0, int r1,
                                      int tw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int mt = tw & 1, group = tw >> 1;
  constexpr int kGroups = kTeam / 2;
  const int tiles = K * Ch / 8;
  const float* arow = d + (16 * mt + g) * ld + K / 2 + q;
  for (int base = group; base < tiles; base += kGroups * NT) {
    const float* pb[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      const int n0 = 8 * min(base + kGroups * j, tiles - 1), k = n0 / Ch;
      pb[j] = src + (n0 - k * Ch + g) * lds + q + k;
    }
    float acc[1][NT][4] = {};
#pragma unroll kUnrollTc
    for (int t0 = r0; t0 < r1; t0 += 8) {
      float a[1][4], b[NT][2];
      a[0][0] = arow[t0];
      a[0][1] = arow[t0 + 8 * ld];
      a[0][2] = arow[t0 + 4];
      a[0][3] = arow[t0 + 8 * ld + 4];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        b[j][0] = pb[j][t0];
        b[j][1] = pb[j][t0 + 4];
      }
      isd::mma3_step<1, NT>(acc, a, b);
    }
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (base + kGroups * j < tiles) {
        const int col = 8 * (base + kGroups * j) + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2* p =
              reinterpret_cast<float2*>(dw + static_cast<size_t>(16 * mt + 8 * h + g) * ldw + col);
          float2 v = first ? make_float2(0.f, 0.f) : *p;
          v.x += acc[0][j][2 * h];
          v.y += acc[0][j][2 * h + 1];
          *p = v;
        }
      }
    }
  }
}

// db[o] (+)= sum_{r0 <= t < r1} d[o, K/2 + t], one warp per row at a time.
template <int K>
__device__ inline void bias_grad(float* __restrict__ db, bool first, const float* d, int ld,
                                 int O, int r0, int r1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = warp; o < O; o += kWarpsW) {
    float s = 0.f;
    for (int t = r0 + lane; t < r1; t += 32) s += d[o * ld + K / 2 + t];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) db[o] = (first ? 0.f : db[o]) + s;
  }
}

// B2w: block (z, p = n * S + s, m) covers trials [s*B/S, (s+1)*B/S) of
// window n and writes partial p of model m's zone-z gradients. Per unit,
// seven phases between barriers (h1 | h2 | h3, dh3 | dw4 | dh2 | dw3 and
// dh1 by two teams of eight warps | dw12, db12); the next unit's columns
// stream in by cp.async during the last phase. A unit is a trial, or in
// column tiles (kW < 0) a (trial, tile) pair, the tiles of a trial in
// turn: tile j stages the window's columns [s, s + kColSpan + K - 1), s =
// kColStep j, computes rows [0, nt8) of its own (row t is the window's s +
// t; zero from the window's end e = t1 - s on), and adds to the weight
// gradients the rows it owns, [kColHalo, kColSpan - kColHalo) at interior
// edges. kC > 0 fixes C at compile time, kW > 0 W (the shipped model's
// geometry), so every stride and trip count is a constant; in column tiles
// the plan is one layout for every W, so kC alone fixes it; 0 takes them
// from the arguments.
template <int O, int K, int kC, int kW>
__global__ void __launch_bounds__(kWarpsW * 32, 1)
conv4head_bwd_w_kernel(const float* __restrict__ g, const float* __restrict__ x,
                       const float* __restrict__ w12, const float* __restrict__ b12,
                       const float* __restrict__ w3, const float* __restrict__ w4,
                       float* __restrict__ pw12, float* __restrict__ pb12,
                       float* __restrict__ pw3, float* __restrict__ pw4, int B, int C_arg,
                       int T, int Z, int N, int W_arg, int step, int S) {
  static_assert(O == 32, "two 16-row tiles of O");
  constexpr bool kTiled = kW < 0;
  constexpr int kSpanCols = isd::kColSpan + K - 1;  // a column tile's window columns
  const int C = kC > 0 ? kC : C_arg, W = kW > 0 ? kW : W_arg;
  constexpr int kHalf = kWarpsW / 2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int z = blockIdx.x, p = blockIdx.y, m = blockIdx.z;
  const int n = p / S, s = p - n * S, P = N * S;
  const int t1 = W - K + 1;
  const int warp = threadIdx.x >> 5;
  const TcPlan plan = tc_plan(C, kTiled ? kSpanCols : W, O, K);
  const int ld = plan.ld, lw = plan.lw, lw1 = plan.lw1;
  const int tiles = kTiled ? isd::col_tile_count(t1) : 1;
  const Operands op = model_operands(w12, b12, w3, w4, m, Z, O, K, C);
  const size_t mp = static_cast<size_t>(m) * P + p;
  float* dw12z = pw12 + (mp * Z * O + static_cast<size_t>(z) * O) * K * C;
  float* db12z = pb12 + mp * Z * O + static_cast<size_t>(z) * O;
  float* dw3z = pw3 + (mp * Z + z) * O * K * O;
  float* dw4z = pw4 + (mp * Z + z) * O * K * O;
  const float* w12z = op.w12 + static_cast<size_t>(z) * O * K * C;
  float* hc = smem + plan.c;
  float* w3s = smem + plan.w3;
  float* w4s = smem + plan.w4;
  float* gz = smem + plan.gz;
  float* bias = smem + plan.bias;
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

  stage_rows_async<kWarpsW>(w3s, w3s + 16 * lw, lw, op.w3 + static_cast<size_t>(z) * O * K * O,
                            K * O);
  stage_rows_async<kWarpsW>(w4s, w4s + 16 * lw, lw, op.w4 + static_cast<size_t>(z) * O * K * O,
                            K * O);
  stage_window_async<kWarpsW>(smem + plan.r[0], ld, unit_x(0), C, T, unit_cols(0));
  stage_rows_async<kWarpsW>(smem + plan.r[1] + O * ld, hc, lw1, w12z, K * C);
  if (threadIdx.x < O) bias[threadIdx.x] = op.b12[z * O + threadIdx.x];
  isd::cp_async_wait_all();
  __syncthreads();

  for (int u = 0; u < units; ++u) {
    const int bi = kTiled ? u / tiles : u, j = kTiled ? u - bi * tiles : 0;
    const size_t mb = static_cast<size_t>(m) * B + b0 + bi;
    const bool first = u == 0;
    const bool odd = u & 1;
    // The tile's rows: e = the window's end; nt8 computed (whole 8-row
    // tiles); [r0, r1) owned, in whole 8-row steps (rows from e on are zero).
    const int e = t1 - j * isd::kColStep;
    const int nt8 = kTiled ? min((e + 7) & ~7, plan.nt8) : plan.nt8;
    const int r0 = j > 0 ? isd::kColHalo : 0;
    const int r1 = j + 1 < tiles ? isd::kColSpan - isd::kColHalo : nt8;
    float* xs = smem + (odd ? plan.r[1] : plan.r[0]);
    float* ha = smem + (odd ? plan.r[0] : plan.r[1]);
    float* hb = ha + O * ld;
    const auto same = [&](int, int t, float v) { return t < e ? v : 0.f; };
    if (threadIdx.x < O) gz[threadIdx.x] = g[(mb * N + n) * Z * O + z * O + threadIdx.x] / t1;
    conv_tc<K, false, kNtConv, kWarpsW>(  // h1
        ha, ld, hb, hc, lw1, xs, ld, C, nt8, warp,
        [&](int o, int t, float v) { return t < e ? v + bias[o] : 0.f; });
    __syncthreads();
    conv_tc<K, false, kNtConv, kWarpsW>(  // h2
        hb, ld, w3s, w3s + 16 * lw, lw, ha, ld, O, nt8, warp, same);
    __syncthreads();
    conv_tc<K, false, kNtConv, kWarpsW>(  // h3 -> dh3
        hc, ld, w4s, w4s + 16 * lw, lw, hb, ld, O, nt8, warp,
        [&](int o, int t, float v) { return t < e ? gz[o] * isd::gelu_grad(v) : 0.f; });
    __syncthreads();
    weight_grad_tc<K, kNtDw4, kWarpsW>(dw4z, K * O, first, hc, ld, hb, ld, O, r0, r1, warp);
    __syncthreads();
    conv_tc<K, true, kNtConv, kWarpsW>(  // dh2 = conv4^T(dh3)
        hb, ld, w4s, nullptr, lw, hc, ld, O, nt8, warp, same);
    __syncthreads();
    if (warp < kHalf) {
      weight_grad_tc<K, kNtDw3, kHalf>(dw3z, K * O, first, hb, ld, ha, ld, O, r0, r1, warp);
    } else {
      conv_tc<K, true, kNtConvHalf, kHalf>(  // dh1 = conv3^T(dh2)
          hc, ld, w3s, nullptr, lw, hb, ld, O, nt8, warp - kHalf, same);
    }
    __syncthreads();
    if (u + 1 < units) {
      stage_window_async<kWarpsW>(ha, ld, unit_x(u + 1), C, T, unit_cols(u + 1));
    }
    weight_grad_tc<K, kNtDw12, kWarpsW>(dw12z, K * C, first, hc, ld, xs, ld, C, r0, r1, warp);
    bias_grad<K>(db12z, first, hc, ld, O, r0, r1);
    __syncthreads();
    if (u + 1 < units) {  // the next unit's w12 halves, into its h2's and c's space
      stage_rows_async<kWarpsW>(xs + O * ld, hc, lw1, w12z, K * C);
      isd::cp_async_wait_all();
      __syncthreads();
    }
  }
}

// ---- B2x on the tensor cores ----

constexpr int kWarpsX = 16;  // B2x's block: 16 warps, one block per SM
constexpr int kNtDx = 4;     // 8-column tiles per warp in dx (beside two 16-row tiles)
static_assert(kWarpsX == kWarpsW, "B2x's convs take B2w's tiles a warp (kNtConv)");

// Shared-memory plan of a B2x block, in floats (strides from
// conv4head_tc.cuh, with Ch = Cp): the window (Cp rows at stride ld), the
// activation buffer a (h1, dh3 at stride ld; dh1 at stride ldx from column
// K - 1), b (h2, dh2), the zone's w12 (O rows of K*Cp at stride lw1), w3
// and w4 (O rows of K*O at stride lw), the cotangent row g/t1 and the bias.
struct XPlan : isd::TcStrides {
  int cp;   // C rounded up to 32
  int wp;   // W rounded up to 8: dx's columns
  int ldx;  // dh1's row stride, >= K - 1 + wp
  int xs, a, b, w12, w3, w4, gz, bias, total;
};

__host__ __device__ inline XPlan x_plan(int C, int W, int O, int K) {
  XPlan p;
  p.cp = (C + 31) & ~31;
  static_cast<isd::TcStrides&>(p) = isd::tc_strides(p.cp, W, O, K);
  p.wp = (W + 7) & ~7;
  p.ldx = isd::stride_4mod8(p.wp + K - 1);
  p.xs = 0;
  p.a = round_up4(p.cp * p.ld);
  p.b = p.a + round_up4(isd::max_int(O * p.ld, O * p.ldx));
  p.w12 = p.b + round_up4(O * p.ld);
  p.w3 = p.w12 + round_up4(O * p.lw1);
  p.w4 = p.w3 + round_up4(O * p.lw);
  p.gz = p.w4 + round_up4(O * p.lw);
  p.bias = p.gz + round_up4(O);
  p.total = p.bias + round_up4(O);
  return p;
}

// dx[c * ldo + w] (+)= sum_{k, o} w12z[o, k*C + c] * dh1[o, w - k] for c < C
// and w in [w0, w1) (w0 a multiple of 8): a GEMM of Cp x (w1 - w0, rounded
// up to 8) over K*O, with w12z staged as a[o * lda + k * cp + c] and
// dh1[o, t] at d[o * ldd + K - 1 + t], zero for t outside the rows that
// enter dx. A[c, k*O + o] = a[o * lda + k * cp + c] is read in place and
// B[k*O + o, w] = d[o * ldd + K - 1 - k + w] is dh1 shifted by the tap
// (conv_tc's kT pattern, with the tap's stride cp and C rows). Warp tw of
// a team of kTeam takes the units tw, tw + kTeam, ...: a unit is a pair of
// 16-row tiles and NT consecutive 8-column tiles (a tile past the end is
// computed as the last one and not stored). Each lane adds its
// accumulators into fixed elements of dx; `first` writes instead in the
// columns from wf on (even: a lane's two columns lie on one side of it).
template <int O, int K, int NT, int kTeam>
__device__ inline void input_grad_tc(float* __restrict__ dx, int ldo, bool first, int w0, int wf,
                                     int w1, const float* d, int ldd, const float* a, int lda,
                                     int C, int cp, int tw) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int pairs = cp >> 5, t0 = w0 >> 3, tiles = ((w1 + 7) >> 3) - t0;
  const int units = pairs * ((tiles + NT - 1) / NT);
  for (int u = tw; u < units; u += kTeam) {
    const int r0 = 32 * (u % pairs), base = NT * (u / pairs);
    int col[NT];
#pragma unroll
    for (int j = 0; j < NT; ++j) col[j] = 8 * (t0 + min(base + j, tiles - 1)) + g;
    float acc[2][NT][4] = {};
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const float* pa = a + q * lda + k * cp + r0 + g;
      const float* pb = d + q * ldd + K - 1 - k;
#pragma unroll kUnrollTc
      for (int o0 = 0; o0 < O; o0 += 8) {
        float av[2][4], bv[NT][2];
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float* p = pa + o0 * lda + 16 * i;
          av[i][0] = p[0];             // (row g, column q)
          av[i][1] = p[8];             // (g + 8, q)
          av[i][2] = p[4 * lda];       // (g, q + 4)
          av[i][3] = p[4 * lda + 8];   // (g + 8, q + 4)
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* p = pb + o0 * ldd + col[j];
          bv[j][0] = p[0];
          bv[j][1] = p[4 * ldd];
        }
        isd::mma3_step<2, NT>(acc, av, bv);
      }
    }
    const bool pairs_fit = (ldo & 1) == 0;  // float2 stores stay 8-byte aligned
#pragma unroll
    for (int j = 0; j < NT; ++j) {
      if (base + j >= tiles) continue;
      const int w = 8 * (t0 + base + j) + 2 * q;
      const bool wr = first && w >= wf;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int c = r0 + 16 * i + 8 * h + g;
          if (c >= C) continue;
          float* p = dx + static_cast<size_t>(c) * ldo + w;
          const float v0 = acc[i][j][2 * h], v1 = acc[i][j][2 * h + 1];
          if (pairs_fit && w + 1 < w1) {
            float2 v = wr ? make_float2(0.f, 0.f) : *reinterpret_cast<float2*>(p);
            v.x += v0;
            v.y += v1;
            *reinterpret_cast<float2*>(p) = v;
          } else {
            if (w < w1) p[0] = (wr ? 0.f : p[0]) + v0;
            if (w + 1 < w1) p[1] = (wr ? 0.f : p[1]) + v1;
          }
        }
      }
    }
  }
}

// The plan a B2x launch takes for windows of W: the whole window where it
// fits a block, else column tiles on the plan of windows of kColSpan + K -
// 1 samples, whatever W is (mirrored by bwd_x_smem_bytes in
// ops/cuda/conv4head.py).
__host__ __device__ inline bool x_tiled(int C, int W, int O, int K) {
  return static_cast<int>(sizeof(float)) * x_plan(C, W, O, K).total > isd::kMaxSmemBytes;
}

__host__ __device__ inline XPlan x_block_plan(int C, int W, int O, int K) {
  return x_plan(C, x_tiled(C, W, O, K) ? isd::kColSpan + K - 1 : W, O, K);
}

// B2x: block (n * SZ + zs, b, m) covers zones [zs*Z/SZ, (zs+1)*Z/SZ) of
// trial b's window n in model m, and writes their sum of the window's
// input gradient (C x W) to out + ((m*B + b)*N + n)*SZ + zs. A unit is a
// zone, or in column tiles (kW < 0) a (zone, tile) pair, the tiles of a
// zone in turn; per unit six phases between barriers (h1 | h2 | h3 -> dh3
// | dh2 | dh1 | dx). Tile j stages the window's columns [s, s + kColSpan +
// K - 1), s = kColStep j (the next unit's stream in by cp.async once h1 has
// read them), computes rows [0, nt8) of its own (row t is the window's s +
// t; zero from the window's end e = t1 - s on), keeps in dh1 only the rows
// it owns, [lo, hi) ([kColHalo, kColSpan - kColHalo) at interior edges),
// and adds their reach, dx columns [lo, hi + K - 1), into the window's
// columns from s + lo: the K - 1 columns from lo, which tile j - 1 reached
// too, always add; the block's first zone writes the rest. kC > 0 fixes C
// at compile time, kW > 0 W (the shipped model's geometry), so every stride
// and trip count is a constant; in column tiles the plan is one layout for
// every W, so kC alone fixes it; 0 takes them from the arguments.
template <int O, int K, int kC, int kW>
__global__ void __launch_bounds__(kWarpsX * 32, 1)
conv4head_bwd_x_kernel(const float* __restrict__ g, const float* __restrict__ x,
                       const float* __restrict__ w12, const float* __restrict__ b12,
                       const float* __restrict__ w3, const float* __restrict__ w4,
                       float* __restrict__ out, int B, int C_arg, int T, int Z, int N, int W_arg,
                       int step, int SZ) {
  static_assert(O == 32, "two 16-row tiles of O");
  constexpr bool kTiled = kW < 0;
  constexpr int kSpanCols = isd::kColSpan + K - 1;  // a column tile's window columns
  const int C = kC > 0 ? kC : C_arg, W = kW > 0 ? kW : W_arg;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = blockIdx.x / SZ, zs = blockIdx.x - n * SZ, b = blockIdx.y, m = blockIdx.z;
  const int t1 = W - K + 1;
  const int warp = threadIdx.x >> 5;
  const XPlan plan = x_plan(C, kTiled ? kSpanCols : W, O, K);
  const int ld = plan.ld, cp = plan.cp, lw1 = plan.lw1, lw = plan.lw;
  const int tiles = kTiled ? isd::col_tile_count(t1) : 1;
  float* xs = smem + plan.xs;
  float* ha = smem + plan.a;
  float* hb = smem + plan.b;
  float* w12s = smem + plan.w12;
  float* w3s = smem + plan.w3;
  float* w4s = smem + plan.w4;
  float* gz = smem + plan.gz;
  float* bias = smem + plan.bias;
  const Operands op = model_operands(w12, b12, w3, w4, m, Z, O, K, C);
  const size_t mbn = (static_cast<size_t>(m) * B + b) * N + n;
  float* dxw = out + (mbn * SZ + zs) * C * W;
  const int z0 = zs * Z / SZ, z1 = (zs + 1) * Z / SZ;
  const float* xw = x + (static_cast<size_t>(m) * B + b) * C * T + static_cast<size_t>(n) * step;
  const auto tile_cols = [&](int j) {
    return kTiled ? min(kSpanCols, W - j * isd::kColStep) : W;
  };

  for (int i = threadIdx.x; i < (cp - C) * ld; i += blockDim.x) xs[C * ld + i] = 0.f;
  stage_window_async<kWarpsX>(xs, ld, xw, C, T, tile_cols(0));
  const int units = (z1 - z0) * tiles;
  for (int u = 0; u < units; ++u) {
    const int zi = kTiled ? u / tiles : u, j = u - zi * tiles, z = z0 + zi;
    if (j == 0) {  // the zone's weights
      isd::stage_w12_async<O, K, kWarpsX>(w12s, lw1, op.w12 + static_cast<size_t>(z) * O * K * C,
                                          C, cp);
      stage_rows_async<kWarpsX>(w3s, w3s + 16 * lw, lw,
                                op.w3 + static_cast<size_t>(z) * O * K * O, K * O);
      stage_rows_async<kWarpsX>(w4s, w4s + 16 * lw, lw,
                                op.w4 + static_cast<size_t>(z) * O * K * O, K * O);
      if (threadIdx.x < O) {
        bias[threadIdx.x] = op.b12[z * O + threadIdx.x];
        gz[threadIdx.x] = g[mbn * Z * O + z * O + threadIdx.x] / t1;
      }
    }
    isd::cp_async_wait_all();
    __syncthreads();
    // The tile's rows: s its first window column, e the window's end, nt8
    // computed (whole 8-row tiles), [lo, hi) owned.
    const int s = j * isd::kColStep, e = t1 - s;
    const int nt8 = kTiled ? min((e + 7) & ~7, plan.nt8) : plan.nt8;
    const int lo = j > 0 ? isd::kColHalo : 0;
    const int hi = j + 1 < tiles ? isd::kColSpan - isd::kColHalo : e;
    const auto same = [&](int, int t, float v) { return t < e ? v : 0.f; };
    conv_tc<K, false, kNtConv, kWarpsX>(  // h1
        ha, ld, w12s, w12s + 16 * lw1, lw1, xs, ld, cp, nt8, warp,
        [&](int o, int t, float v) { return t < e ? v + bias[o] : 0.f; });
    __syncthreads();
    if (kTiled && u + 1 < units) {  // the window is read: the next unit's columns
      const int jn = j + 1 < tiles ? j + 1 : 0;
      stage_window_async<kWarpsX>(xs, ld, xw + jn * isd::kColStep, C, T, tile_cols(jn));
    }
    conv_tc<K, false, kNtConv, kWarpsX>(  // h2
        hb, ld, w3s, w3s + 16 * lw, lw, ha, ld, O, nt8, warp, same);
    __syncthreads();
    conv_tc<K, false, kNtConv, kWarpsX>(  // h3 -> dh3
        ha, ld, w4s, w4s + 16 * lw, lw, hb, ld, O, nt8, warp,
        [&](int o, int t, float v) { return t < e ? gz[o] * isd::gelu_grad(v) : 0.f; });
    __syncthreads();
    conv_tc<K, true, kNtConv, kWarpsX>(  // dh2 = conv4^T(dh3)
        hb, ld, w4s, nullptr, lw, ha, ld, O, nt8, warp, same);
    __syncthreads();
    conv_tc<K, true, kNtConv, kWarpsX, K - 1>(  // dh1 = conv3^T(dh2), owned rows, from column K - 1
        ha, plan.ldx, w3s, nullptr, lw, hb, ld, O, nt8, warp,
        [&](int, int t, float v) { return t >= lo && t < hi ? v : 0.f; });
    __syncthreads();
    input_grad_tc<O, K, kNtDx, kWarpsX>(dxw + s, W, zi == 0, lo, j > 0 ? lo + K - 1 : 0,
                                        min(hi + K - 1, W - s), ha, plan.ldx, w12s, lw1, C, cp,
                                        warp);
    __syncthreads();
  }
}

bool bad_geometry(int M, int B, int C, int T, int Z, int K1, int K2, int W, int step, int N) {
  return M < 1 || B < 1 || C < 1 || Z < 1 || N < 1 || K1 < 1 || K2 < 1 || W < K1 ||
         step < 1 || (N - 1) * step + W > T || M > 65535 || B > 65535;
}

template <int O, int K>
cudaError_t launch_w(const float* g, const float* x, const float* w12, const float* b12,
                     const float* w3, const float* w4, float* dw12, float* db12, float* dw3,
                     float* dw4, float* pw12, float* pb12, float* pw3, float* pw4, int M, int B,
                     int C, int T, int Z, int W, int step, int N, int S, cudaStream_t st) {
  const size_t smem_bytes = sizeof(float) * w_plan(C, W, O, K).total;
  // The shipped model's geometry (64 channels, windows of 250) gets compile-time strides,
  // and so do column tiles at 64 channels (one layout for every W).
  const auto kernel = !w_tiled(C, W, O, K)
                          ? ((C == 64 && W == 250) ? conv4head_bwd_w_kernel<O, K, 64, 250>
                                                   : conv4head_bwd_w_kernel<O, K, 0, 0>)
                          : (C == 64 ? conv4head_bwd_w_kernel<O, K, 64, -1>
                                     : conv4head_bwd_w_kernel<O, K, 0, -1>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const int P = N * S;
  kernel<<<dim3(Z, P, M), kWarpsW * 32, smem_bytes, st>>>(
      g, x, w12, b12, w3, w4, pw12, pb12, pw3, pw4, B, C, T, Z, N, W, step, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = sum_partials(pw12, dw12, M, P, Z * O * K * C, st)) != cudaSuccess) return err;
  if ((err = sum_partials(pb12, db12, M, P, Z * O, st)) != cudaSuccess) return err;
  if ((err = sum_partials(pw3, dw3, M, P, Z * O * K * O, st)) != cudaSuccess) return err;
  return sum_partials(pw4, dw4, M, P, Z * O * K * O, st);
}

template <int O, int K>
cudaError_t launch_x(const float* g, const float* x, const float* w12, const float* b12,
                     const float* w3, const float* w4, float* dxw, float* part, int M, int B,
                     int C, int T, int Z, int W, int step, int N, int SZ, cudaStream_t st) {
  const size_t smem_bytes = sizeof(float) * x_block_plan(C, W, O, K).total;
  // The shipped model's geometry (64 channels, windows of 250) gets compile-time strides,
  // and so do column tiles at 64 channels (one layout for every W).
  const auto kernel = !x_tiled(C, W, O, K)
                          ? ((C == 64 && W == 250) ? conv4head_bwd_x_kernel<O, K, 64, 250>
                                                   : conv4head_bwd_x_kernel<O, K, 0, 0>)
                          : (C == 64 ? conv4head_bwd_x_kernel<O, K, 64, -1>
                                     : conv4head_bwd_x_kernel<O, K, 0, -1>);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(N * SZ, B, M), kWarpsX * 32, smem_bytes, st>>>(
      g, x, w12, b12, w3, w4, SZ > 1 ? part : dxw, B, C, T, Z, N, W, step, SZ);
  if ((err = cudaGetLastError()) != cudaSuccess || SZ == 1) return err;
  return sum_partials(part, dxw, M * B * N, SZ, C * W, st);
}

}  // namespace

// Dynamic shared memory of one B2x block, in bytes: the whole window's
// plan where it fits a block, else the column tiles'.
extern "C" int isd_conv4head_bwd_x_smem_bytes(int C, int W, int O, int K) {
  return static_cast<int>(sizeof(float)) * x_block_plan(C, W, O, K).total;
}

// Units of one (trial, window, zone) in B2x: 1 where the whole window's
// plan fits a block, else its column tiles.
extern "C" int isd_conv4head_bwd_x_col_tiles(int C, int W, int O, int K) {
  return x_tiled(C, W, O, K) ? isd::col_tile_count(W - K + 1) : 1;
}

// Dynamic shared memory of one B2w block, in bytes: the whole window's
// plan where it fits a block, else the column tiles'.
extern "C" int isd_conv4head_bwd_w_smem_bytes(int C, int W, int O, int K) {
  return static_cast<int>(sizeof(float)) * w_plan(C, W, O, K).total;
}

// Units of one (trial, window) in B2w: 1 where the whole window's plan
// fits a block, else its column tiles.
extern "C" int isd_conv4head_bwd_w_col_tiles(int C, int W, int O, int K) {
  return w_tiled(C, W, O, K) ? isd::col_tile_count(W - K + 1) : 1;
}

// B2w. g (M, B, N, Z*O), x (M, B, C, T), operands as the forward's;
// outputs dw12 (M, Z*O, K1*C), db12 (M, Z*O), dw3/dw4 (M, Z, O, K2*O);
// scratch pw12/pb12/pw3/pw4 the same with a partial axis P = N*S after M.
// All f32, contiguous, on the device. K1 must equal K2, and C % 8 == 0.
extern "C" int isd_conv4head_bwd_w(const float* g, const float* x, const float* w12,
                                   const float* b12, const float* w3, const float* w4,
                                   float* dw12, float* db12, float* dw3, float* dw4, float* pw12,
                                   float* pb12, float* pw3, float* pw4, int M, int B, int C,
                                   int T, int Z, int O, int K1, int K2, int W, int step, int N,
                                   int S, void* stream) {
  if (bad_geometry(M, B, C, T, Z, K1, K2, W, step, N) || C % 8 != 0 || S < 1 || S > B ||
      static_cast<long long>(N) * S > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O == 32 && K1 == 5 && K2 == 5) {
    return launch_w<32, 5>(g, x, w12, b12, w3, w4, dw12, db12, dw3, dw4, pw12, pb12, pw3, pw4,
                           M, B, C, T, Z, W, step, N, S, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// B2x. g, x and operands as B2w; output dxw (M, B, N, C, W), the
// per-window input gradients (the caller overlap-adds the windows). SZ
// zone ranges (1 <= SZ <= Z) per (model, trial, window); with SZ > 1 the
// scratch part (M, B, N, SZ, C, W) holds the partials that a fixed-order
// pass sums into dxw (null otherwise).
extern "C" int isd_conv4head_bwd_x(const float* g, const float* x, const float* w12,
                                   const float* b12, const float* w3, const float* w4,
                                   float* dxw, float* part, int M, int B, int C, int T, int Z,
                                   int O, int K1, int K2, int W, int step, int N, int SZ,
                                   void* stream) {
  if (bad_geometry(M, B, C, T, Z, K1, K2, W, step, N) || SZ < 1 || SZ > Z ||
      (SZ > 1 && part == nullptr)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O == 32 && K1 == 5 && K2 == 5) {
    return launch_x<32, 5>(g, x, w12, b12, w3, w4, dxw, part, M, B, C, T, Z, W, step, N, SZ, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
