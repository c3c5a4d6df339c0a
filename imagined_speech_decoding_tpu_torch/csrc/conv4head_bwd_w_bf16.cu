// Weight gradients of the fused sliding-window Conv4Layers zone head in
// bf16, for Hopper (kernel B2w-bf16): the training path's default
// precision.
//
// Replaces the weight-gradient Pallas kernel of
// imagined_speech_decoding_tpu/ops/pallas/conv4head.py (_bwd_w_kernel and
// its zone helper _bwd_zone, called by _bwd_rule) when x is bf16, and
// rounds where they round (:165-228). Per (model, trial, window, zone) it
// recomputes the forward as B2f-bf16 does (h1, h2 bf16; h3 f32), then
//   dh3c = bf16(g / t1 * gelu'(h3))         (g read as f32, the product in f32)
//   dh2c = bf16(conv4^T(dh3c))              (f32 sums of exact bf16 products)
//   dh1  = conv3^T(dh2c)                    f32
//   dw4 += dh3c . p4^T, dw3 += dh2c . p3^T  (p4, p3: the bf16 patches of h2, h1)
//   db12 += sum_t dh1                       f32, before any rounding
//   dw12 += bf16(dh1) . p^T                 (p: the bf16 patches of the window)
// with w12, w3, w4 rounded to bf16 as they are staged and every gradient
// accumulated in f32. Operands and outputs are conv4head_bwd.cu's B2w's:
// g (M, B, N, Z*O) f32, x (M, B, C, T) bf16, the weights f32, dw12, db12,
// dw3, dw4 f32, with per-block partials summed by a fixed-order pass.
//
// What bounds it on the H100: work. ~12.6 M multiply-adds per (trial,
// window, zone) at full width, 2.4 T for a training step of 75 models at
// batch 64: 4.89 ms at the data sheet's 989 TFLOP/s dense bf16, one pass.
// On this route the shared-memory operands bound it first: a m64n32k16
// reads 3 KB for 32 K multiply-adds, and peaks at 653 TFLOP/s on the card
// (mma_tf32_ceiling.py --mode wgmma), 7.4 ms for that step.
//
// The design: a block per (model, zone, window, trial range), 16 warps = 4
// warpgroups, one block per SM, the zone's weights resident, the next
// (trial, column tile)'s samples streamed in by cp.async while the current
// one computes. Every product is a warpgroup GEMM, wgmma.mma_async
// m64n32k16 with both operands read from shared memory through descriptors
// (wgmma_bf16.cuh):
//  * the convs and conv^T's are D[t, o] GEMMs, M = time (a warpgroup takes
//    64 rows: 4 x 64 >= t1 = 246), N = O = 32, K = (tap, channel);
//  * the weight gradients are dw^T[(tap, i), o] = sum_t src[t + tap][i]
//    d[t][o], M = (tap, channel), N = o, K = time, and stay in registers
//    (f32 accumulators) across the block's whole trial range: each block
//    writes its partial once. dw12 is K * Cp / 64 tiles (5 at C <= 64),
//    dw3 and dw4 3 each; a warpgroup holds kSlots = 3 of the 11.
// One layout serves every GEMM: each time-major buffer (the window, h1,
// h2, dh3c, dh2c, bf16(dh1)) is stored in chunks of 8 channels,
// [chunk][row][8], wgmma's no-swizzle core-matrix layout. A tap's shift of
// one row is +16 bytes, a legal descriptor start; the same bytes read with
// channels along K feed a conv (K-major A) and with time along K a weight
// gradient (MN-major A or B). w3 and w4 are staged once, [chunk of (tap,
// channel)][o][8]: K-major B of a conv, and read MN-major they are the
// transposed B of a conv^T. A 64-row dw3 / dw4 tile spans two taps whose
// source rows differ by one, which no descriptor stride expresses: h1 and
// h2 carry a second copy one row down (channels O..2O-1, written by the
// same epilogue), so taps 2p and 2p + 1 are chunks 0-3 and 4-7 at one
// start. That costs 2 x 16.6 KB of shared memory and nothing in products
// (the other options: padding M = o to 64 doubles dw3's and dw4's work;
// mma.sync for them keeps the ldmatrix-fed loops this design leaves).
// The tile of taps 4 and 5 computes a tap past K, not stored.
//
// Column tiles: the buffers hold at most kGroups x 64 = 256 computed rows,
// so a window of t1 > 256 conv rows (W > 260) runs in column tiles, each
// computing 256 rows from column s = 240 j of the window (the last as few
// 64-row tiles as reach t1). conv3, conv4, conv4^T and conv3^T each reach
// 2 rows, so dh1 is exact 8 rows inside a tile's interior edges (a halo of
// kHalo = 8 rows a side, recomputed): tile j owns rows [s + 8, s + 248) of
// the window (from 0 in the first tile, up to t1 in the last), and only
// those enter the weight gradients and db12. Rows past t1 are zero as in
// one tile; interior edges hold real values. The time K step of a weight
// gradient is 16 rows and the owned edges (local rows 8 and 248) lie
// inside one, so the epilogues of dh3c and dh2c also write a masked copy
// of the 16-row chunk that holds each interior edge (the owned rows real,
// the others zero) and that step reads the copy; conv4^T and conv3^T read
// the full rows. bf16(dh1) feeds only dw12, so it is stored masked. At
// windows of 500 that is 2 tiles, 512 rows computed for 496; at W <= 260
// one tile, with no halo and no edge chunks (the other instantiations).
//
// A (trial, column tile): the window's columns transposed; h1, h2, h3 ->
// dh3c; conv4^T -> dh2c
// with dw4 issued behind it; conv3^T -> bf16(dh1) and db12's f32 column
// sums (per warp, added in warp order: no atomics) with dw3 behind it;
// dw12. Each phase's generic stores are fenced for the async proxy
// (fence.proxy.async) before the barrier after which a wgmma reads them;
// the weight-gradient groups run on under the next epilogues and are
// drained before the next (trial, tile) overwrites the window. C up to 64: the
// window and w12 are padded with zero channels to Cp = 64 (a dw12 tile is
// one tap), whose gradient columns are not stored; more channels fit
// neither 3 tiles a warpgroup nor the shared memory at W = 250.
// T even. 225 KB of shared memory at full width; 230,656 B in column tiles,
// one layout for every C <= 64 and window (the raw rows sized for 64
// channels, the 4 KB of masked edge chunks), so the column tiles'
// instantiation has compile-time strides as the shipped geometry's has. ops/cuda/conv4head.py mirrors the plan and the
// column tiles (bwd_w_bf16_plan, bwd_w_bf16_col_tiles) for the CPU
// emulation of tests/wgmma_emulation.py. The debug instantiations (kClock)
// add per-phase clock counters (phase_clock.cuh).

#include <cstdint>

#include <cuda_runtime.h>

#include "conv4head_bf16.cuh"
#include "phase_clock.cuh"
#include "sum_partials.cuh"
#include "conv4head_wgmma.cuh"
#include "wgmma_bf16.cuh"

namespace {

using isd::kWarpsB;
using isd::kRows;
using isd::kGroups;
using isd::chunk_off;
using isd::col_sums;
using isd::conv_epilogue;
using isd::conv_issue;
using isd::round16;
using isd::stage_weights_wg;

constexpr int kSlots = 3;  // weight-gradient tiles a warpgroup holds: 11 at C <= 64
constexpr int kSpan = kGroups * kRows;  // rows a column tile computes at most: 256
constexpr int kHalo = isd::kColHalo;  // rows recomputed at a tile's interior edge
constexpr int kTileStep = isd::kColStep;  // columns between two tiles' first rows: 240
static_assert(kSpan == isd::kColSpan, "B2w's and B2w-bf16's column tiles are one geometry");
constexpr int kEdgeRows = 16;  // rows of a masked edge chunk: one k16 step over time

// Shared-memory plan of a block, in bytes; mirrored by bwd_w_bf16_plan in
// ops/cuda/conv4head.py. Time-major buffers have `rows` rows (the column
// tile's rows 0..nt+K-2; activation time t at row K/2 + t, zero rows around
// up to the farthest row a tap reaches) in chunks of 8 channels, `cs`
// bytes apart.
struct WgPlan {
  int cp;        // channels of the staged window and w12: C rounded up to 64
  int t1, nt;    // valid conv length; the rows a tile computes (t1 up to 64s, at most kSpan)
  int tiles;     // column tiles a window: 1 up to t1 = kSpan, else ceil((t1 - 16) / 240)
  int rows, cs;  // rows of a buffer (nt + K - 1); bytes between its chunks
  int rw;        // raw row stride, in bf16 elements (even, past the columns a tile reads)
  int n34, n12;  // weight-gradient tiles of dw4 (= of dw3) and of dw12
  int xs, raw, h1, h2, d3, d2, d1, w12, w3, w4, bias, gz, red;
  int mk;        // the masked edge chunks, [dh3c, dh2c][left, right] (column tiles only)
  int total;
};

__host__ __device__ inline WgPlan wg_plan(int C, int W, int O, int K) {
  WgPlan p;
  p.cp = (C + kRows - 1) / kRows * kRows;
  p.t1 = W - K + 1;
  p.nt = p.t1 < kSpan ? (p.t1 + kRows - 1) / kRows * kRows : kSpan;
  p.tiles = isd::col_tile_count(p.t1);
  p.rows = p.nt + K - 1;
  p.cs = 16 * p.rows;
  p.rw = ((W < p.rows ? W : p.rows) + 2) & ~1;
  p.n34 = (K * O + kRows - 1) / kRows;
  p.n12 = K * p.cp / kRows;
  int off = 0;
  p.xs = off;
  off += round16(p.cp / 8 * p.cs);
  p.raw = off;  // C rows; cp in column tiles, so that every column-tile plan has one layout
  off += round16(2 * (p.tiles > 1 ? p.cp : C) * p.rw);
  p.h1 = off;  // O channels, then the copy one row down
  off += round16(O / 4 * p.cs);
  p.h2 = off;
  off += round16(O / 4 * p.cs);
  p.d3 = off;
  off += round16(O / 8 * p.cs);
  p.d2 = off;
  off += round16(O / 8 * p.cs);
  p.d1 = off;
  off += round16(O / 8 * p.cs);
  p.w12 = off;
  off += round16(2 * K * p.cp * O);
  p.w3 = off;
  off += round16(2 * K * O * O);
  p.w4 = off;
  off += round16(2 * K * O * O);
  p.bias = off;
  off += round16(4 * O);
  p.gz = off;
  off += round16(4 * O);
  p.red = off;
  off += round16(4 * kWarpsB * O);
  p.mk = off;
  off += p.tiles > 1 ? 4 * (O / 8) * 16 * kEdgeRows : 0;
  p.total = off;
  return p;
}

// Column tile j of a window, in the tile's own rows (row r is the window's
// conv row s + r): the rows it computes (nt, 64-row tiles), the first row
// past the window's end (e), the rows it owns [lo, hi), the window columns
// it reads, and whether it has an interior edge on the left or right.
struct ColTile {
  int s, nt, e, lo, hi, cols;
  bool left, right;
};

__host__ __device__ inline ColTile col_tile(const WgPlan& p, int j, int W, int K) {
  ColTile c;
  c.s = j * kTileStep;
  c.e = p.t1 - c.s;
  c.nt = (c.e + kRows - 1) / kRows * kRows;
  c.nt = c.nt < p.nt ? c.nt : p.nt;
  c.left = j > 0;
  c.right = j + 1 < p.tiles;
  c.lo = c.left ? kHalo : 0;
  c.hi = c.right ? p.nt - kHalo : c.e;
  c.cols = c.nt + K - 1 < W - c.s ? c.nt + K - 1 : W - c.s;
  return c;
}

// The C rows of `cols` window columns, from x0 (the even element at or
// before the columns' start in row 0; rows at stride T, T even), to
// raw[c * rw + j] by 4-byte cp.async: off + cols elements rounded up to
// even, the columns starting at j = off. Warp w copies rows w, w + 16, ...:
// no division a word (one per word cost ~3,000 cycles a trial, PERF.md); a
// round past a row's end repeats its last word.
__device__ inline void stage_raw_rows(uint16_t* raw, int rw, const uint16_t* __restrict__ x0,
                                      int C, int T, int cols, int off, int warp) {
  const int words = (off + cols + 1) >> 1, lane = threadIdx.x & 31;
  for (int c = warp; c < C; c += kWarpsB) {
    for (int j0 = 0; j0 < words; j0 += 32) {
      const int j = 2 * min(j0 + lane, words - 1);
      isd::cp_async4_b32(raw + c * rw + j, x0 + static_cast<size_t>(c) * T + j);
    }
  }
}

// The columns into their chunks: (t, c) = x[c, t] from the raw rows for t
// < span, 16 bytes (8 channels) a store, channels C..cp-1 zero; kPad: rows
// cols..span-1 zero as well (a column tile, span its buffers' rows: a
// constant divisor, and a short tile's rows past the window's end hold
// zeros). Rows from span on are not written (zero from the block's start).
// A round past the last item repeats it; raw rows past C, and in kPad raw
// columns past cols, are read and their values dropped (they lie inside the
// block's shared memory).
template <bool kPad>
__device__ inline void raw_to_chunks(char* xs, int cs, const uint16_t* raw, int rw, int off,
                                     int C, int cp, int cols, int span) {
  const int n = (cp >> 3) * span;
  for (int i0 = 0; i0 < n; i0 += kWarpsB * 32) {
    const int i = min(i0 + static_cast<int>(threadIdx.x), n - 1);
    const int ch = i / span, t = i - ch * span;
    const uint16_t* col = raw + 8 * ch * rw + off + t;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * ch + 2 * e;
      const uint32_t lo = col[2 * e * rw], hi = col[(2 * e + 1) * rw];
      v[e] = (c < C ? lo : 0u) | ((c + 1 < C ? hi : 0u) << 16);
      if (kPad) v[e] = t < cols ? v[e] : 0u;
    }
    *reinterpret_cast<uint4*>(xs + ch * cs + 16 * t) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// Zeros rows [r0, r0 + n) of `chunks` consecutive chunks (cs bytes apart) from buf.
__device__ inline void zero_rows(char* buf, int cs, int chunks, int r0, int n) {
  for (int i = threadIdx.x; i < chunks * n; i += blockDim.x) {
    const int ch = i / n;
    *reinterpret_cast<uint4*>(buf + ch * cs + 16 * (r0 + i - ch * n)) = make_uint4(0, 0, 0, 0);
  }
}

// acc += one weight-gradient tile's k16 steps over time (overwriting acc
// on the block's first (trial, tile)): A = src from byte a0 (time along K:
// MN-major), B = d from byte b0 (MN-major), nt rows; the first and last
// steps read the masked edge chunks bl and br instead where they are not 0.
__device__ inline void dw_issue(float (&acc)[16], uint32_t a0, uint32_t b0, int cs, int nt,
                                bool first, uint64_t bl, uint64_t br) {
  const uint64_t a = isd::wgmma_desc(a0, 128, cs), b = isd::wgmma_desc(b0, 128, cs);
#pragma unroll
  for (int t0 = 0; t0 < nt; t0 += 16) {  // +16 rows = +256 bytes = +16 in the start field
    const uint64_t bt = t0 == 0 && bl ? bl : t0 + 16 == nt && br ? br : b + t0;
    isd::wgmma_m64n32k16<1, 1>(acc, a + t0, bt, t0 > 0 || !first);
  }
}

// kW > 0: windows of kW samples (one column tile); kW 0: any window of one
// column tile; kW < 0 (kTiled): any window in column tiles, on the one
// layout of every column-tile plan (its strides compile-time constants).
template <int O, int K, int kC, int kW, bool kClock>
__global__ void __launch_bounds__(kWarpsB * 32, 1)
conv4head_bwd_w_bf16_kernel(const float* __restrict__ g, const uint16_t* __restrict__ x,
                            const float* __restrict__ w12, const float* __restrict__ b12,
                            const float* __restrict__ w3, const float* __restrict__ w4,
                            float* __restrict__ pw12, float* __restrict__ pb12,
                            float* __restrict__ pw3, float* __restrict__ pw4, int B, int C_arg,
                            int T, int Z, int N, int W_arg, int step, int S,
                            unsigned long long* __restrict__ clk) {
  static_assert(O == 32, "four 8-column chunks of O; dw3 / dw4 tiles of two taps");
  constexpr bool kTiled = kW < 0;
  const int C = kC > 0 ? kC : C_arg, W = kW > 0 ? kW : W_arg;
  extern __shared__ uint4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const uint32_t base = isd::smem_u32(smem);
  // Every column-tile plan is the plan of W = kSpan + K (two tiles) but for t1 and tiles.
  WgPlan plan = wg_plan(kTiled ? kRows : C, kTiled ? kSpan + K : W, O, K);
  if (kTiled) {
    const WgPlan own = wg_plan(C, W, O, K);
    plan.t1 = own.t1;
    plan.tiles = own.tiles;
  }
  const int tiles = kTiled ? plan.tiles : 1;  // the others take one column tile (launch_w)
  const int z = blockIdx.x, p = blockIdx.y, m = blockIdx.z;
  const int n = p / S, s = p - n * S, P = N * S;
  const int t1 = plan.t1, cs = plan.cs;
  // The warpgroup, through a shuffle so that the compiler knows it is the
  // same across the warp: every branch on it is then warp-uniform.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int wg = warp >> 2;
  uint16_t* raw = reinterpret_cast<uint16_t*>(smem + plan.raw);
  const float* bias = reinterpret_cast<const float*>(smem + plan.bias);
  float* gz = reinterpret_cast<float*>(smem + plan.gz);
  float* red = reinterpret_cast<float*>(smem + plan.red);
  isd::PhaseClock<kClock> clock(smem + plan.total);
  const size_t zo = (static_cast<size_t>(m) * Z + z) * O;
  const size_t mp = static_cast<size_t>(m) * P + p;
  const int b0 = s * B / S, b1 = (s + 1) * B / S;
  const int off = (n * step) & 1;  // T and kTileStep even: every row's columns start at this parity
  const uint16_t* x0 = x + (static_cast<size_t>(m) * B + b0) * C * T + n * step - off;

  // Column tile j, in one column tile the whole window (the plan's own registers).
  const auto tile_of = [&](int j) {
    return kTiled ? col_tile(plan, j, W, K)
                  : ColTile{0, plan.nt, plan.t1, 0, plan.t1, W, false, false};
  };
  stage_raw_rows(raw, plan.rw, x0, C, T, tile_of(0).cols, off, warp);
  isd::zero_words(reinterpret_cast<uint32_t*>(smem + plan.xs), plan.raw / 4);
  isd::zero_words(reinterpret_cast<uint32_t*>(smem + plan.h1), (plan.w12 - plan.h1) / 4);
  if (kTiled) {
    isd::zero_words(reinterpret_cast<uint32_t*>(smem + plan.mk), (plan.total - plan.mk) / 4);
  }
  stage_weights_wg(smem + plan.w12, w12 + zo * K * C, O, K, C, plan.cp);
  stage_weights_wg(smem + plan.w3, w3 + zo * K * O, O, K, O, O);
  stage_weights_wg(smem + plan.w4, w4 + zo * K * O, O, K, O, O);
  if (threadIdx.x < O) {
    reinterpret_cast<float*>(smem + plan.bias)[threadIdx.x] = b12[zo + threadIdx.x];
  }
  isd::fence_proxy_async();

  // Accumulators are defined by their first wgmma (scale-d 0), never by
  // other instructions: those would serialise the wgmma pipeline.
  float acc[16];           // a conv tile
  float accw[kSlots][16];  // this warpgroup's weight-gradient tiles wg, wg + 4, ...
  float db = 0.f;  // db12's sum over the block's trials (threads o < O keep theirs)
  ColTile ct = tile_of(0);  // the current (trial, column tile)'s

  // The masked edge chunk of dh3c (0) or dh2c (1) on the left (0) or right (1).
  const auto edge = [&](int which, int side) {
    return plan.mk + (2 * which + side) * (O / 8) * 16 * kEdgeRows;
  };
  const auto edge_desc = [&](int which, bool on, int side) -> uint64_t {
    return on ? isd::wgmma_desc(base + edge(which, side), 128, 16 * kEdgeRows) : 0;
  };
  // This warpgroup's weight-gradient tiles of [lo, hi): dw4 tiles are
  // 0..n34-1, dw3 n34..2 n34-1, dw12 2 n34..; their sources and dh.
  bool first = true;  // the block's first (trial, tile)
  const auto issue_dw = [&](int lo, int hi) {
#pragma unroll
    for (int t = 0; t < kSlots; ++t) {
      const int tile = wg + kGroups * t;
      if (tile < lo || tile >= hi) continue;
      uint32_t a0, b0r;
      uint64_t bl = 0, br = 0;
      if (tile < plan.n34) {  // dw4: taps 2p, 2p + 1 of h2 and its copy; dh3c
        a0 = base + plan.h2 + 32 * tile;
        b0r = base + plan.d3 + 16 * (K / 2);
        bl = edge_desc(0, ct.left, 0);
        br = edge_desc(0, ct.right, 1);
      } else if (tile < 2 * plan.n34) {  // dw3: h1; dh2c
        a0 = base + plan.h1 + 32 * (tile - plan.n34);
        b0r = base + plan.d2 + 16 * (K / 2);
        bl = edge_desc(1, ct.left, 0);
        br = edge_desc(1, ct.right, 1);
      } else {  // dw12: (tap, 64 channels) of the window; bf16(dh1), stored masked
        const int i = tile - 2 * plan.n34, blocks = plan.cp / kRows;
        const int tap = i / blocks, blk = i - tap * blocks;
        a0 = base + plan.xs + 8 * blk * cs + 16 * tap;
        b0r = base + plan.d1 + 16 * (K / 2);
      }
      dw_issue(accw[t], a0, b0r, cs, ct.nt, first, bl, br);
    }
  };
  // One conv phase: this warpgroup's time tiles, each issued, waited for
  // and handed to its epilogue; `extra` (weight-gradient tiles, or nothing:
  // a phase without them must hold no wgmma at all, or ptxas serialises
  // every wgmma around its epilogue) is issued behind the first tile and
  // runs on under the epilogues; then `after`, the fence for the async
  // proxy and the barrier.
  const auto conv_phase = [&](auto issue, auto epilogue, auto extra, auto after, int ph_dw,
                              int ph_conv) {
    bool issued = false;
    for (int tile = wg; tile < ct.nt / kRows; tile += kGroups) {
      isd::wgmma_fence();
      issue(tile);
      isd::wgmma_commit();
      if (!issued) {
        extra();
        isd::wgmma_commit();
        issued = true;
        clock.mark(ph_dw);
        isd::wgmma_wait<1>();
      } else {
        isd::wgmma_wait<0>();
      }
      isd::fence_operand(acc);
      conv_epilogue(acc, tile, epilogue);
    }
    if (!issued) {
      isd::wgmma_fence();
      extra();
      isd::wgmma_commit();
      clock.mark(ph_dw);
    }
    after();
    isd::fence_proxy_async();
    clock.sync(ph_conv);
  };
  const auto nothing = [] {};
  const auto put = [&](int buf, int row, int o, uint32_t v) {
    *reinterpret_cast<uint32_t*>(smem + buf + chunk_off(cs, row, o)) = v;
  };
  // In column tiles, dh3c's (0) or dh2c's (1) row t also into the masked
  // copy of the edge chunk that holds it (zero where the tile does not own
  // it); a row in no edge chunk goes to this thread's own word of red (free
  // in these phases): one store, no branch on t while weight gradients run.
  const auto put_edge = [&](int which, int t, int o, uint32_t v) {
    const bool l = ct.left && t < kEdgeRows, r = ct.right && t >= plan.nt - kEdgeRows;
    const bool own = l ? t >= kHalo : t < plan.nt - kHalo;
    const int at = l || r ? edge(which, r) + chunk_off(16 * kEdgeRows,
                                                       l ? t : t - (plan.nt - kEdgeRows), o)
                          : plan.red + 4 * static_cast<int>(threadIdx.x);
    *reinterpret_cast<uint32_t*>(smem + at) = own ? v : 0u;
  };
  const auto conv = [&](int src, int w) {
    return [=, &acc](int tile) { conv_issue<K, O, false>(acc, base + src, cs, base + w, O, tile); };
  };
  const auto conv_t = [&](int src, int w) {
    return [=, &acc](int tile) { conv_issue<K, O, true>(acc, base + src, cs, base + w, O, tile); };
  };

  for (int b = b0; b < b1; ++b) {
    const size_t mb = static_cast<size_t>(m) * B + b;
    for (int j = 0; j < tiles; ++j) {
      ct = tile_of(j);
      const int e = ct.e;  // rows from e on lie past the window's end: zero
      isd::cp_async_wait_all();
      isd::wgmma_wait<0>();  // the last (trial, tile)'s weight gradients read the window and dh
      __syncthreads();
      clock.mark(isd::kPhWait);
      raw_to_chunks<kTiled>(smem + plan.xs, cs, raw, plan.rw, off, C, plan.cp, ct.cols,
                            kTiled ? plan.rows : ct.cols);
      if (kTiled && ct.nt < plan.nt) {  // a short last tile: the rows its convs read past its own
        zero_rows(smem + plan.h1, cs, (plan.d1 - plan.h1) / cs, ct.nt + K / 2 - 1, K / 2 + 1);
      }
      // g / t1 (O = 32: every warp stores the same values)
      gz[threadIdx.x & 31] = g[(mb * N + n) * Z * O + z * O + (threadIdx.x & 31)] / t1;
      isd::fence_proxy_async();
      clock.sync(isd::kPhTranspose);
      const int nj = j + 1 < tiles ? j + 1 : 0, nb = nj > 0 ? b : b + 1;
      if (nb < b1) {  // the next (trial, tile)'s columns
        stage_raw_rows(raw, plan.rw,
                       x0 + (nb - b0) * static_cast<size_t>(C) * T + nj * kTileStep, C, T,
                       tile_of(nj).cols, off, warp);
      }
      conv_phase(  // h1 = bf16(w12 . p + b12), and its copy one row down
          [&](int tile) { conv_issue<K, O, false>(acc, base + plan.xs, cs, base + plan.w12,
                                                  plan.cp, tile); },
          [&](int, int t, int o, float v0, float v1) {
            const uint32_t v = t < e ? isd::pack_bf16(v0 + bias[o], v1 + bias[o + 1]) : 0u;
            put(plan.h1, K / 2 + t, o, v);
            put(plan.h1, K / 2 + t - 1, O + o, v);
          },
          nothing, nothing, isd::kPhConv1, isd::kPhConv1);
      conv_phase(  // h2 = bf16(w3 . pad(h1)), and its copy
          conv(plan.h1, plan.w3),
          [&](int, int t, int o, float v0, float v1) {
            const uint32_t v = t < e ? isd::pack_bf16(v0, v1) : 0u;
            put(plan.h2, K / 2 + t, o, v);
            put(plan.h2, K / 2 + t - 1, O + o, v);
          },
          nothing, nothing, isd::kPhConv2, isd::kPhConv2);
      conv_phase(  // h3 = w4 . pad(h2) -> dh3c = bf16(g / t1 * gelu'(h3))
          conv(plan.h2, plan.w4),
          [&](int, int t, int o, float v0, float v1) {
            const uint32_t v =
                t < e ? isd::pack_bf16(gz[o] * isd::gelu_grad(v0), gz[o + 1] * isd::gelu_grad(v1))
                      : 0u;
            put(plan.d3, K / 2 + t, o, v);
            if (kTiled) put_edge(0, t, o, v);
          },
          nothing, nothing, isd::kPhConv3, isd::kPhConv3);
      conv_phase(  // dh2c, dw4 behind it
          conv_t(plan.d3, plan.w4),
          [&](int, int t, int o, float v0, float v1) {
            const uint32_t v = t < e ? isd::pack_bf16(v0, v1) : 0u;
            put(plan.d2, K / 2 + t, o, v);
            if (kTiled) put_edge(1, t, o, v);
          },
          [&] { issue_dw(0, plan.n34); }, nothing, isd::kPhDw4, isd::kPhConv4T);
      float sums[4][2] = {};
      conv_phase(  // dh1 on the owned rows: bf16 for dw12, its f32 column sums for db12;
                   // dw3 behind it
          conv_t(plan.d2, plan.w3),
          [&](int j4, int t, int o, float v0, float v1) {
            const bool real = (ct.lo == 0 || t >= ct.lo) && t < ct.hi;
            put(plan.d1, K / 2 + t, o, real ? isd::pack_bf16(v0, v1) : 0u);
            sums[j4][0] += real ? v0 : 0.f;
            sums[j4][1] += real ? v1 : 0.f;
          },
          [&] { issue_dw(plan.n34, 2 * plan.n34); }, [&] { col_sums(red, sums); },
          isd::kPhDw3, isd::kPhConv3T);
      isd::wgmma_fence();
      issue_dw(2 * plan.n34, 2 * plan.n34 + plan.n12);
      isd::wgmma_commit();
      clock.mark(isd::kPhDw12);
      db += isd::sum_warps(red, threadIdx.x & 31);  // every thread: no branch (see col_sums)
      clock.mark(isd::kPhDb12);
      first = false;
    }
  }
  isd::wgmma_wait<0>();
#pragma unroll
  for (int t = 0; t < kSlots; ++t) isd::fence_operand(accw[t]);

  // Each tile's rows to its gradient: dw4 / dw3 rows r < 32 are tap 2p,
  // channel r, the rest tap 2p + 1 (not stored past K); dw12 rows are the
  // channels 64 blk + r of one tap (not stored past C).
  const int lane = threadIdx.x & 31, w = (threadIdx.x >> 5) & 3, gq = lane >> 2, q = lane & 3;
  float* dw12z = pw12 + (mp * Z * O + static_cast<size_t>(z) * O) * K * C;
  float* dw3z = pw3 + (mp * Z + z) * O * K * O;
  float* dw4z = pw4 + (mp * Z + z) * O * K * O;
#pragma unroll
  for (int t = 0; t < kSlots; ++t) {
    const int tile = wg + kGroups * t;
    if (tile >= 2 * plan.n34 + plan.n12) continue;
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int r = 16 * w + 8 * ((i >> 1) & 1) + gq, o = 8 * (i >> 2) + 2 * q + (i & 1);
      if (tile < 2 * plan.n34) {
        const int pair = tile < plan.n34 ? tile : tile - plan.n34;
        const int tap = 2 * pair + r / O, ch = r % O;
        float* dst = tile < plan.n34 ? dw4z : dw3z;
        if (tap < K) dst[o * K * O + tap * O + ch] = accw[t][i];
      } else {
        const int j = tile - 2 * plan.n34, blocks = plan.cp / kRows;
        const int tap = j / blocks, ch = kRows * (j - tap * blocks) + r;
        if (ch < C) dw12z[static_cast<size_t>(o) * K * C + tap * C + ch] = accw[t][i];
      }
    }
  }
  if (threadIdx.x < O) pb12[mp * Z * O + static_cast<size_t>(z) * O + threadIdx.x] = db;
  clock.finish(clk);
}

template <int O, int K, bool kClock>
cudaError_t launch_w(const float* g, const uint16_t* x, const float* w12, const float* b12,
                     const float* w3, const float* w4, float* dw12, float* db12, float* dw3,
                     float* dw4, float* pw12, float* pb12, float* pw3, float* pw4, int M, int B,
                     int C, int T, int Z, int W, int step, int N, int S,
                     unsigned long long* clk, cudaStream_t st) {
  const WgPlan plan = wg_plan(C, W, O, K);
  if (2 * plan.n34 + plan.n12 > kGroups * kSlots) {
    return cudaErrorInvalidValue;  // more weight-gradient tiles than registers hold
  }
  const size_t smem_bytes = plan.total + (kClock ? isd::clock_bytes() : 0);
  // The shipped model's geometry (64 channels, windows of 250) gets compile-time strides;
  // windows past kSpan conv rows take the column tiles' instantiation.
  const auto kernel = plan.tiles > 1 ? conv4head_bwd_w_bf16_kernel<O, K, 0, -1, kClock>
                      : (C == 64 && W == 250) ? conv4head_bwd_w_bf16_kernel<O, K, 64, 250, kClock>
                                              : conv4head_bwd_w_bf16_kernel<O, K, 0, 0, kClock>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const int P = N * S;
  kernel<<<dim3(Z, P, M), kWarpsB * 32, smem_bytes, st>>>(
      g, x, w12, b12, w3, w4, pw12, pb12, pw3, pw4, B, C, T, Z, N, W, step, S, clk);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = isd::sum_partials(pw12, dw12, M, P, Z * O * K * C, st)) != cudaSuccess) return err;
  if ((err = isd::sum_partials(pb12, db12, M, P, Z * O, st)) != cudaSuccess) return err;
  if ((err = isd::sum_partials(pw3, dw3, M, P, Z * O * K * O, st)) != cudaSuccess) return err;
  return isd::sum_partials(pw4, dw4, M, P, Z * O * K * O, st);
}

// B2w-bf16. Arguments as isd_conv4head_bwd_w's, with x (M, B, C, T) bf16
// (T even, 4-byte aligned). `clk` null launches the shipped instantiation;
// otherwise the debug one, which adds its counters to clk[0, kPhases + 2).
int bwd_w_bf16(const float* g, const void* x, const float* w12, const float* b12,
               const float* w3, const float* w4, float* dw12, float* db12, float* dw3,
               float* dw4, float* pw12, float* pb12, float* pw3, float* pw4, int M, int B, int C,
               int T, int Z, int O, int K1, int K2, int W, int step, int N, int S,
               unsigned long long* clk, void* stream) {
  if (M < 1 || B < 1 || C < 1 || Z < 1 || N < 1 || K1 < 1 || K2 < 1 || W < K1 || step < 1 ||
      (N - 1) * step + W > T || T % 2 != 0 || M > 65535 || S < 1 || S > B ||
      static_cast<long long>(N) * S > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O == 32 && K1 == 5 && K2 == 5) {
    const auto launch = clk ? launch_w<32, 5, true> : launch_w<32, 5, false>;
    return launch(g, static_cast<const uint16_t*>(x), w12, b12, w3, w4, dw12, db12, dw3, dw4,
                  pw12, pb12, pw3, pw4, M, B, C, T, Z, W, step, N, S, clk, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// Dynamic shared memory of one B2w-bf16 block, in bytes; -1 where its
// weight-gradient tiles would not fit the registers (C > 64). Mirrored by
// bwd_w_bf16_smem_bytes in ops/cuda/conv4head.py.
extern "C" int isd_conv4head_bwd_w_bf16_smem_bytes(int C, int W, int O, int K) {
  const WgPlan plan = wg_plan(C, W, O, K);
  return 2 * plan.n34 + plan.n12 > kGroups * kSlots ? -1 : plan.total;
}

extern "C" int isd_conv4head_bwd_w_bf16(const float* g, const void* x, const float* w12,
                                        const float* b12, const float* w3, const float* w4,
                                        float* dw12, float* db12, float* dw3, float* dw4,
                                        float* pw12, float* pb12, float* pw3, float* pw4, int M,
                                        int B, int C, int T, int Z, int O, int K1, int K2, int W,
                                        int step, int N, int S, void* stream) {
  return bwd_w_bf16(g, x, w12, b12, w3, w4, dw12, db12, dw3, dw4, pw12, pb12, pw3, pw4, M, B, C,
                    T, Z, O, K1, K2, W, step, N, S, nullptr, stream);
}

// The debug instantiation: as isd_conv4head_bwd_w_bf16, adding its phase
// counters to clk (kPhases + 2 zeros on the device, see phase_clock.cuh).
extern "C" int isd_conv4head_bwd_w_bf16_phases(
    const float* g, const void* x, const float* w12, const float* b12, const float* w3,
    const float* w4, float* dw12, float* db12, float* dw3, float* dw4, float* pw12, float* pb12,
    float* pw3, float* pw4, int M, int B, int C, int T, int Z, int O, int K1, int K2, int W,
    int step, int N, int S, void* clk, void* stream) {
  if (clk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return bwd_w_bf16(g, x, w12, b12, w3, w4, dw12, db12, dw3, dw4, pw12, pb12, pw3, pw4, M, B, C,
                    T, Z, O, K1, K2, W, step, N, S, static_cast<unsigned long long*>(clk),
                    stream);
}
