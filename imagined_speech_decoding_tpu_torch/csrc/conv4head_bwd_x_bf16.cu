// Input gradient of the fused sliding-window Conv4Layers zone head in
// bf16, for Hopper (kernel B2x-bf16): attributions of the default (bf16)
// model in its own precision.
//
// Replaces the input-gradient Pallas kernel of
// imagined_speech_decoding_tpu/ops/pallas/conv4head.py (_bwd_x_kernel,
// :231-259, with its zone helper _bwd_zone, called by _bwd_rule at :351)
// when x is bf16, and rounds where they round. Per (model, trial, window,
// zone) it recomputes B2w-bf16's first six phases (conv4head_bwd_w_bf16.cu)
//   h1 = bf16(w12 . p + b12),  h2 = bf16(conv3(h1)),  h3 = conv4(h2) (f32)
//   dh3c = bf16(g / t1 * gelu'(h3)),  dh2c = bf16(conv4^T(dh3c)),
//   dh1 = conv3^T(dh2c) (f32), then bf16(dh1)
// and one GEMM more, the input gradient of the window,
//   dxw[c, w] += sum_{k, o} w12z[o, k*C + c] * bf16(dh1)[o, w - k]
// with w12, w3, w4 rounded to bf16 as they are staged and every sum in
// f32, accumulated over the zones. Operands are conv4head_bwd.cu's B2x's
// with x (M, B, C, T) bf16: g (M, B, N, Z*O) f32, the weights f32, dxw
// (M, B, N, C, W) f32, which the wrapper overlap-adds in f32 and returns
// in bf16, as the Pallas kernel's caller does.
//
// What bounds it on the H100: work. ~10.08 M multiply-adds per (trial,
// window, zone) at full width (the recompute 5.04 M, dh2 and dh1 1.26 M
// each, dx 2.52 M), 40.3 G at M = 1, B = 100 (global_explain's batch):
// 0.0815 ms at the data sheet's 989 TFLOP/s dense bf16, one pass. Every
// operand is reused from shared memory hundreds of times; the bytes (x,
// g, the weights, dx) take 0.02 ms. On this route the shared-memory
// operands bound it first: a m64n32k16 reads 3 KB for 32 K multiply-adds
// and peaks at 653 TFLOP/s on the card (mma_tf32_ceiling.py --mode
// wgmma), 0.123 ms there.
//
// The design, for this card:
//  * A block is one (model, trial, window, zone range): 16 warps = 4
//    warpgroups, one block per SM, the window staged once and the zones
//    walked in order. Every product is a warpgroup GEMM, wgmma.mma_async
//    m64n32k16 with both operands in shared memory through descriptors
//    (wgmma_bf16.cuh). The recompute is B2w-bf16's: the time-major buffers
//    in chunks of 8 channels (the window, h1, h2, dh3c, dh2c, bf16(dh1)),
//    each conv and conv^T a D[t, o] GEMM issued by conv_issue
//    (conv4head_wgmma.cuh), a warpgroup a 64-row time tile. Only the
//    weight gradients' pieces go: no copies of h1 and h2 one row down, no
//    dw GEMMs, no column sums.
//  * The input gradient is time-major: D[w, c] = sum_{k, o} A_k[w, o]
//    B_k[o, c], M = the window's columns (64-row tiles up to W), N = Cp =
//    64 channels as two n32 halves, K = (tap, o), 10 k16 steps. A_k is
//    bf16(dh1) read K-major and shifted by the tap: dh1 is stored from row
//    K - 1 with zero rows on both sides (as the f32 B2x stores it), so a
//    tap is a start 16 bytes lower, a legal descriptor start, and no load
//    needs a predicate. B_k is the staged w12 read MN-major: its K-major
//    layout [chunk of (tap, channel)][o][8] read with o along K is the
//    transposed operand, as conv^T reads w3 and w4.
//  * The dx tiles (64 rows x 32 channels, 16 f32 registers a thread each;
//    8 of them at W <= 256, 10 at W <= 260) stay in registers across the
//    block's zones, 2 a warpgroup at the shipped windows of 250 (kSlots = 3
//    otherwise), and are written once. (The f32 B2x adds each zone into
//    global memory, 64 KB of L2 traffic a unit: its mma.sync fragments left
//    no room for the accumulators.) A zone's dx GEMM is issued behind the
//    next zone's h3 tile and runs on under its GELU' epilogue, the phase
//    with the most CUDA-core work; the phase after drains it.
//  * The weights: a pre-pass rounds every (model, zone)'s w12, w3 and w4 to
//    bf16 once, in their staged layout, beside b12 and g / t1 (the Pallas
//    kernel's g_wz / t1, a division), so that a block copies a zone's set
//    in by cp.async, 8 bytes a copy and a whole number of copies a thread,
//    with no conversion and no register. Blocks reading f32 weights and
//    rounding them themselves spent ~7,000 of a zone's ~22,000 cycles
//    there: every SM re-reads a zone's 80 KB at the same moment, and loads
//    held in registers cannot cross the phases' barriers (which wait for
//    them). Two weight sets alternate: the next zone's w3, w4, b12 and g /
//    t1 go in behind its h1 tile, its w12 behind its bf16(dh1) tile (once
//    the dx GEMM that read that set has drained), and the copies land by
//    the barrier after bf16(dh1).
//  * Grid fill at M = 1: 5 windows of 16 trials (explain_fast's batch) are
//    80 blocks for 132 SMs, so the wrapper may split the zones into SZ
//    ranges a (trial, window) (ops/cuda/conv4head.py::_bwd_x_zone_splits,
//    with B2x-bf16's own time a zone and a block); with SZ > 1 each block
//    writes a partial and the fixed-order pass of sum_partials.cuh sums
//    them. No atomics: reruns are bit-identical.
//  * The window is transposed into its chunks once per block by 2-byte
//    loads (no cp.async of 4-byte pairs): any T and any window start, so
//    an odd T needs no even copy.
//  * GELU' takes its exponential from ex2.approx (__expf, a few ulp), the
//    product rounded to bf16 right after, as Pallas rounds it.
//  * Column tiles: a block holds at most kGroups x 64 = 256 conv rows, so a
//    window of t1 > 256 (W > 260) runs in B2w-bf16's column tiles
//    (conv4head_common.cuh): tile j stages the window's columns [240 j,
//    240 j + 260) on the plan of windows of 260 samples (one layout for
//    every W), recomputes h1 .. dh1 over its rows (zero from the window's
//    end on; g / t1 is the whole window's) and keeps in bf16(dh1) only the
//    rows it owns, [8, 248) at interior edges (from 0 in the first tile, up
//    to t1 in the last): dh1 is exact 8 rows inside an edge, and a halo row
//    kept would count twice. dh3c and dh2c need no masked edge chunks here
//    (B2w-bf16 sums them over time; here only dh1 feeds dx). The owned rows
//    [lo, hi) reach dx columns [lo, hi + K - 1), so tiles j and j + 1 both
//    reach the K - 1 = 4 seam columns [240 j + 248, 240 j + 252). Tiles run
//    outside the zones: a block walks units (tile j, zone z), the tile's dx
//    in registers across its zones (a whole 800-sample window's 26 dx tiles
//    would not fit), the window transposed once a tile, a zone's weight set
//    copied in under the phases a unit as before (the double buffer carries
//    on across the tiles). After a tile's last zone its dx GEMM is drained
//    and the tile stored: columns from lo + K - 1 written (from 0 in the
//    first tile), the K - 1 before them added onto what tile j - 1 stored
//    there, by the same block in tile order with a barrier between, so no
//    atomics and reruns stay bit-identical. At one 800-sample window a
//    (trial, window, zone) computes 3 x 256 + 128 = 896 conv rows (the
//    short last tile in two 64-row tiles) against the 796 of t1.
// It takes O = 32, K1 = K2 = 5, C <= 64 (the window and w12 zero-padded to
// Cp = 64 channels, whose gradient rows are not stored) and any window:
// one tile up to t1 = 256 conv rows (windows of 260 samples), column tiles
// past that. 198,912 B of shared memory at the shipped geometry (C = 64,
// W = 250), which has compile-time strides; another instantiation takes
// the other windows of one tile; column tiles have two (C = 64 and any C,
// compile-time strides both, 203,008 B), and a debug instantiation of each
// (kClock) adds per-phase clock counters (phase_clock.cuh).
// ops/cuda/conv4head.py mirrors the plan, the tiles and the descriptors
// (bwd_x_bf16_plan, bwd_x_bf16_col_tiles, bwd_x_bf16_dx_descs) for the CPU
// emulation of tests/wgmma_emulation.py.

#include <cstdint>
#include <type_traits>

#include <cuda_runtime.h>

#include "conv4head_bf16.cuh"
#include "phase_clock.cuh"
#include "conv4head_wgmma.cuh"
#include "sum_partials.cuh"
#include "wgmma_bf16.cuh"

namespace {

using isd::chunk_off;
using isd::conv_epilogue;
using isd::conv_issue;
using isd::kGroups;
using isd::kRows;
using isd::kWarpsB;
using isd::round16;

constexpr int kCp = 64;                // channels of the staged window and w12
constexpr int kSlots = 3;              // dx tiles a warpgroup holds
constexpr int kMaxT1 = kGroups * kRows;  // conv rows of a block: one 64-row tile a warpgroup
static_assert(kMaxT1 == isd::kColSpan, "B2x-bf16's column tiles are B2w-bf16's geometry");

// Shared-memory plan of a block, in bytes; mirrored by bwd_x_bf16_plan in
// ops/cuda/conv4head.py. The time-major buffers have `rows` rows (time t
// of an activation at row K/2 + t, zero rows around it), dh1 `rx` (t at row
// K - 1 + t, zero up to the farthest row the dx tiles' taps read), in
// chunks of 8 channels `cs` (dh1: `csx`) bytes apart. Two sets of a zone's
// weights, `wset` bytes apart: w12, w3, w4 in bf16, b12 and g / t1 in f32.
struct XPlan {
  int t1, nt;     // valid conv length; the rows the convs compute (t1 up to 64s)
  int rows, cs;   // rows of a buffer (nt + K - 1) and the bytes between its chunks
  int nx;         // dx row tiles (W up to 64s, over 64): 2 nx dx tiles of 32 channels
  int rx, csx;    // rows of dh1's buffer (64 nx + K - 1) and its chunk stride
  int xs, h1, h2, d3, d2, d1;
  int w12, w3, w4, bias, gz;  // the first weight set's
  int wset, total;
};

__host__ __device__ inline XPlan x_plan(int C, int W, int O, int K) {
  (void)C;  // every C <= kCp has one layout
  XPlan p;
  p.t1 = W - K + 1;
  p.nt = (p.t1 + kRows - 1) / kRows * kRows;
  p.rows = p.nt + K - 1;
  p.cs = 16 * p.rows;
  p.nx = (W + kRows - 1) / kRows;
  p.rx = kRows * p.nx + K - 1;
  p.csx = 16 * p.rx;
  int off = 0;
  p.xs = off;
  off += round16(kCp / 8 * p.cs);
  p.h1 = off;
  off += round16(O / 8 * p.cs);
  p.h2 = off;
  off += round16(O / 8 * p.cs);
  p.d3 = off;
  off += round16(O / 8 * p.cs);
  p.d2 = off;
  off += round16(O / 8 * p.cs);
  p.d1 = off;
  off += round16(O / 8 * p.csx);
  const int set = off;
  p.w12 = off;
  off += round16(2 * K * kCp * O);
  p.w3 = off;
  off += round16(2 * K * O * O);
  p.w4 = off;
  off += round16(2 * K * O * O);
  p.bias = off;
  off += round16(4 * O);
  p.gz = off;
  off += round16(4 * O);
  p.wset = off - set;
  p.total = off + p.wset;
  return p;
}

// Whether B2x-bf16 has a plan for C channels at windows of W: C <= kCp (one
// window in column tiles past t1 = kMaxT1).
__host__ __device__ inline bool x_plan_ok(int C, int W, int K) {
  return C >= 1 && C <= kCp && W >= K;
}

// Whether windows of W run in column tiles: t1 past one block's rows.
__host__ __device__ inline bool x_tiled(int W, int K) { return W - K + 1 > kMaxT1; }

// The plan a launch takes: the whole window's, or in column tiles the plan
// of windows of kMaxT1 + K - 1 samples, whatever W is (one layout; its nx
// = 5 row tiles make 10 dx tiles, within kSlots a warpgroup).
__host__ __device__ inline XPlan x_block_plan(int C, int W, int O, int K) {
  return x_plan(C, x_tiled(W, K) ? kMaxT1 + K - 1 : W, O, K);
}

// Column tile j of `tiles` of a window of W samples (t1 conv rows), on the
// block's plan p, in the tile's own rows and columns (row r is the window's
// conv row s + r, column w its column s + w; conv4head_common.cuh's
// geometry): the rows its convs compute (nt, whole 64-row tiles), the first
// row past the window's end (e), the rows of dh1 it keeps [lo, hi), the
// window columns it stages (cols); its dx reach [lo, w1) in nx 64-row dx
// tiles, of which it adds [lo, wf) onto what tile j - 1 stored (the K - 1
// seam columns) and writes [wf, w1). The whole window is one such tile.
struct XTile {
  int s, nt, e, lo, hi, cols, wf, w1, nx;
};

__host__ __device__ inline XTile x_tile(const XPlan& p, int W, int K, int j, int tiles) {
  XTile c;
  c.s = j * isd::kColStep;
  c.e = W - K + 1 - c.s;
  c.nt = (c.e + kRows - 1) / kRows * kRows;
  c.nt = c.nt < p.nt ? c.nt : p.nt;
  c.lo = j > 0 ? isd::kColHalo : 0;
  c.hi = j + 1 < tiles ? p.nt - isd::kColHalo : c.e;
  c.cols = c.nt + K - 1 < W - c.s ? c.nt + K - 1 : W - c.s;
  c.wf = j > 0 ? c.lo + K - 1 : 0;
  c.w1 = c.hi + K - 1 < W - c.s ? c.hi + K - 1 : W - c.s;
  c.nx = (c.w1 + kRows - 1) / kRows;
  return c;
}

// The window's columns into the chunks: (t, c) = x0[c * T + t] for t < cols
// and c < C, zero elsewhere, rows 0..rows-1, by 2-byte loads (a warp reads
// 32 consecutive samples of a channel), 16 bytes (8 channels) a store.
__device__ inline void window_to_chunks(char* xs, int cs, const uint16_t* __restrict__ x0, int C,
                                        int T, int cols, int rows) {
  const int n = (kCp >> 3) * rows;
#pragma unroll 5
  for (int i = threadIdx.x; i < n; i += kWarpsB * 32) {
    const int ch = i / rows, t = i - ch * rows;
    uint32_t v[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = 8 * ch + 2 * e;
      const uint32_t lo = t < cols && c < C ? x0[static_cast<size_t>(c) * T + t] : 0u;
      const uint32_t hi = t < cols && c + 1 < C ? x0[static_cast<size_t>(c + 1) * T + t] : 0u;
      v[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(xs + ch * cs + 16 * t) = make_uint4(v[0], v[1], v[2], v[3]);
  }
}

// GELU's derivative as isd::gelu_grad computes it, with the exponential
// by ex2.approx (__expf; a few ulp): the product rounds to bf16 right after.
__device__ inline float gelu_grad_fast(float v) {
  return 0.5f * (1.f + erff(v * isd::kInvSqrt2)) + v * isd::kInvSqrt2Pi * __expf(-0.5f * v * v);
}

// 8 bytes global -> shared by cp.async (both 8-byte aligned).
__device__ __forceinline__ void cp_async8(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(isd::smem_addr(dst)), "l"(src)
               : "memory");
}

// A zone's staged weights in global memory, as the pre-pass writes them:
// the bytes of a shared-memory weight set from w12 up to (not including) gz
// (w12, w3 and w4 in bf16, b12 in f32); g / t1 is a separate array.
__host__ __device__ inline int prep_bytes(const XPlan& p) { return p.gz - p.w12; }

// The pre-pass: zone z of model m's w12 (channels C..kCp-1 zero), w3 and w4
// rounded to bf16 in their staged layout (as isd::stage_weights_wg stages
// them), and b12, into prep. A block takes kPrepPairs bf16 pairs of one
// (zone, model): w12 in kPrepParts12 parts, w3 and w4 in kPrepParts34
// each, kPrepParts blocks a zone, so that M = 1 still spreads over 64 SMs.
// The main kernel copies them in by cp.async, 8 bytes a thread and no
// conversion, under the products of the zone before.
constexpr int kPrepPairs = 1280;
constexpr int kPrepParts12 = 32 * 5 * kCp / 2 / kPrepPairs;  // at O = 32, K = 5
constexpr int kPrepParts34 = 32 * 5 * 32 / 2 / kPrepPairs;
constexpr int kPrepParts = kPrepParts12 + 2 * kPrepParts34;

template <int O, int K>
__global__ void __launch_bounds__(256)
conv4head_bwd_x_bf16_prep_kernel(const float* __restrict__ w12, const float* __restrict__ b12,
                                 const float* __restrict__ w3, const float* __restrict__ w4,
                                 char* __restrict__ prep, int C, int Z) {
  static_assert(O * K * kCp / 2 == kPrepParts12 * kPrepPairs &&
                O * K * O / 2 == kPrepParts34 * kPrepPairs, "the parts tile the pairs");
  const XPlan p = x_plan(C, kMaxT1 + K - 1, O, K);
  const size_t mz = static_cast<size_t>(blockIdx.y) * Z + blockIdx.x;
  const int part = blockIdx.z;
  const bool is12 = part < kPrepParts12, is3 = !is12 && part < kPrepParts12 + kPrepParts34;
  const int Ch = is12 ? C : O, chp = is12 ? kCp : O, pairs = K * chp / 2;
  const float* w = is12 ? w12 + mz * O * K * C : (is3 ? w3 : w4) + mz * O * K * O;
  char* dst = prep + mz * prep_bytes(p) + (is12 ? 0 : (is3 ? p.w3 : p.w4) - p.w12);
  const int i0 = kPrepPairs * (is12 ? part : (part - kPrepParts12) % kPrepParts34);
  for (int i = i0 + threadIdx.x; i < i0 + kPrepPairs; i += blockDim.x) {
    const int o = i / pairs, j = 2 * (i - o * pairs), k = j / chp, c = j - k * chp;
    const float* row = w + static_cast<size_t>(o) * K * Ch + k * Ch;
    *reinterpret_cast<uint32_t*>(dst + chunk_off(16 * O, o, j)) =
        isd::pack_bf16(c < Ch ? row[c] : 0.f, c + 1 < Ch ? row[c + 1] : 0.f);
  }
  if (part == 0 && threadIdx.x < O) {
    reinterpret_cast<float*>(prep + mz * prep_bytes(p) + (p.bias - p.w12))[threadIdx.x] =
        b12[mz * O + threadIdx.x];
  }
}

// gs = g / t1, the mean's cotangent a step (the Pallas kernel's g_wz / t1).
__global__ void conv4head_bwd_x_bf16_scale_kernel(const float* __restrict__ g,
                                                  float* __restrict__ gs, long long n, int t1) {
  for (long long i = blockIdx.x * static_cast<long long>(blockDim.x) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * blockDim.x) {
    gs[i] = g[i] / t1;
  }
}

// A unit's phases, in the order of ops/cuda/conv4head.py's BWD_X_BF16_PHASES:
// the debug instantiation's counters (phase_clock.cuh).
enum XPhase {
  kXSetup,    // zeros, the window's transpose, the first zone's weights
  kXConv1,    // h1; this zone's w3 and w4 staged behind its products
  kXConv2,    // h2
  kXConv3,    // h3 -> dh3c; the last zone's dx GEMM issued behind its products
  kXConv4T,   // dh2c (the last zone's dx GEMM drained)
  kXConv3T,   // bf16(dh1); the next zone's w12, b12 and g / t1 staged behind its products
  kXDx,       // a tile's last dx GEMM, issued and waited for
  kXStore,    // dx written, the seam added
  kXTile,     // column tiles: the next tile's window transposed, a short tile's stale rows zeroed
  kXBarrier,  // every __syncthreads
  kXPhases
};

// kC, kW > 0: the shipped geometry's compile-time strides; kW 0: any window
// of one tile; kW < 0 (kTiled): any window in column tiles, on the one plan
// of every column-tile geometry (compile-time strides; kC > 0 fixes C too).
// kClock: the debug instantiation, which adds its phase counters to clk.
// A block walks its units (column tile j, zone z), the tiles in order and
// each tile's zones in order: the tile's dx stays in registers across its
// zones, and after its last zone it is stored (the K - 1 seam columns at an
// interior left edge added onto what tile j - 1 stored), then the next
// tile's window is staged. The zones' weight sets alternate by unit, across
// the tiles.
template <int O, int K, int kC, int kW, bool kClock>
__global__ void __launch_bounds__(kWarpsB * 32, 1)
conv4head_bwd_x_bf16_kernel(const float* __restrict__ gs, const uint16_t* __restrict__ x,
                            const char* __restrict__ prep, float* __restrict__ out, int B,
                            int C_arg, int T, int Z, int N, int W_arg, int step, int SZ,
                            unsigned long long* __restrict__ clk) {
  static_assert(O == 32, "four 8-column chunks of O; a warp's lanes copy b12 and g / t1");
  constexpr bool kTiled = kW < 0;
  // dx tiles a warpgroup holds: 2 at the shipped windows of 250 (8 tiles), else kSlots.
  constexpr int kSl = kW > 0 ? (2 * ((kW + kRows - 1) / kRows) + kGroups - 1) / kGroups : kSlots;
  static_assert(kSl <= kSlots, "the dx tiles must fit the registers");
  const int C = kC > 0 ? kC : C_arg, W = kW > 0 ? kW : W_arg;
  extern __shared__ uint4 smem4[];
  char* smem = reinterpret_cast<char*>(smem4);
  const uint32_t base = isd::smem_u32(smem);
  const XPlan plan = x_plan(C, kTiled ? kMaxT1 + K - 1 : W, O, K);
  const int cs = plan.cs, csx = plan.csx;
  const int tiles = kTiled ? isd::col_tile_count(W - K + 1) : 1;
  const int n = blockIdx.x / SZ, zs = blockIdx.x - n * SZ, b = blockIdx.y, m = blockIdx.z;
  // The warpgroup, through a shuffle so that the compiler knows it is the
  // same across the warp: every branch on it is then warp-uniform.
  const int warp = __shfl_sync(0xffffffffu, threadIdx.x >> 5, 0);
  const int wg = warp >> 2;
  const size_t mb = static_cast<size_t>(m) * B + b, mbn = mb * N + n;
  const int z0 = zs * Z / SZ, z1 = (zs + 1) * Z / SZ, nz = z1 - z0;
  const uint16_t* xw = x + mb * C * T + static_cast<size_t>(n) * step;
  isd::PhaseClock<kClock, kXPhases> clock(smem + plan.total);
  // Zone z's staged weights into the set at `set` (the plan's first set's
  // offsets shifted), by cp.async: w3, w4, b12 and g / t1 (every warp copies
  // the last two, the same bytes: no branch), then w12; 8 bytes a copy, a
  // whole number of copies a thread. They land by the next cp.async wait.
  constexpr int kThreads = kWarpsB * 32;
  const int tid = threadIdx.x, lane = tid & 31, pbytes = prep_bytes(plan);
  const auto copy34 = [&](int z, int set) {
    const char* src = prep + (static_cast<size_t>(m) * Z + z) * pbytes;
#pragma unroll
    for (int r = 0; r < 2 * (2 * K * O * O) / 8 / kThreads; ++r) {  // w3 and w4, contiguous
      const int i = 8 * (tid + r * kThreads);
      cp_async8(smem + set + plan.w3 + i, src + (plan.w3 - plan.w12) + i);
    }
    const char* bg = lane < 16 ? src + (plan.bias - plan.w12) + 8 * lane
                               : reinterpret_cast<const char*>(gs + (mbn * Z + z) * O) +
                                     8 * (lane - 16);
    cp_async8(smem + set + plan.bias + 8 * lane, bg);  // b12, then gz right after it
  };
  const auto copy12 = [&](int z, int set) {
    const char* src = prep + (static_cast<size_t>(m) * Z + z) * pbytes;
#pragma unroll
    for (int r = 0; r < 2 * K * kCp * O / 8 / kThreads; ++r) {
      const int i = 8 * (tid + r * kThreads);
      cp_async8(smem + set + plan.w12 + i, src + i);
    }
  };

  XTile ct = x_tile(plan, W, K, 0, tiles);  // the current column tile; the whole window in one
  copy34(z0, 0);
  copy12(z0, 0);
  isd::zero_words(reinterpret_cast<uint32_t*>(smem + plan.h1), (plan.w12 - plan.h1) / 4);
  window_to_chunks(smem + plan.xs, cs, xw, C, T, ct.cols, plan.rows);
  isd::cp_async_wait_all();
  isd::fence_proxy_async();
  clock.sync(kXSetup);

  // Accumulators are defined by their first wgmma (scale-d 0), never by
  // other instructions: those would serialise the wgmma pipeline.
  float acc[16];        // a conv tile
  float accx[kSl][16];  // this warpgroup's dx tiles wg, wg + 4, ...: (row tile, half) = (i / 2, i % 2)
  // One conv phase: this warpgroup's time tile (a tile's rows <= kGroups x
  // 64: one a warpgroup), issued, waited for and handed to its epilogue,
  // `under` run behind its products (or alone, without a tile); kPend 1:
  // `under` issues products of its own, committed as a group that runs on
  // under the epilogue into the next phase; kPend 0: nothing is left in
  // flight (a warpgroup without a tile drains the last dx GEMM here). Then,
  // with `land`, the wait for this thread's cp.async copies; the fence for
  // the async proxy and the barrier.
  const auto conv_phase = [&](auto issue, auto epilogue, auto under, auto pend, int phase,
                              bool land) {
    constexpr int kPend = decltype(pend)::value;
    if (wg < ct.nt / kRows) {
      isd::wgmma_fence();
      issue(wg);
      isd::wgmma_commit();
      under();
      if (kPend) isd::wgmma_commit();
      isd::wgmma_wait<kPend>();
      isd::fence_operand(acc);
      conv_epilogue(acc, wg, epilogue);
    } else {
      if (kPend) isd::wgmma_fence();
      under();
      if (kPend) isd::wgmma_commit();
    }
    if (!kPend) isd::wgmma_wait<0>();
    if (land) isd::cp_async_wait_all();
    isd::fence_proxy_async();
    clock.sync(phase);
  };
  constexpr std::integral_constant<int, 0> drained{};
  constexpr std::integral_constant<int, 1> behind{};
  const auto nothing = [] {};
  const auto put = [&](int buf, int row, int o, uint32_t v) {
    *reinterpret_cast<uint32_t*>(smem + buf + chunk_off(cs, row, o)) = v;
  };
  // This warpgroup's dx tiles of unit ud (its bf16(dh1) in d1, its w12 in
  // weight set ud % 2): A = bf16(dh1) from row 64 mt + K-1-k (tap k),
  // K-major; B = w12's taps k, channels 32 h.., read MN-major. A tile's
  // first zone (`first`) overwrites the accumulators; the tile's nx row
  // tiles only (the rest of the slots hold nothing of it).
  const auto issue_dx = [&](int ud, bool first) {
    const uint32_t w12s = base + (ud & 1) * plan.wset + plan.w12;
#pragma unroll
    for (int s = 0; s < kSl; ++s) {
      const int tile = wg + kGroups * s;
      if (tile >= 2 * ct.nx) continue;
      const int mt = tile >> 1, h = tile & 1;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const uint32_t a_row = base + plan.d1 + 16 * (kRows * mt + K - 1 - k);
#pragma unroll
        for (int o0 = 0; o0 < O; o0 += 16) {
          const uint64_t a = isd::wgmma_desc(a_row + (o0 >> 3) * csx, csx, 128);
          const uint64_t bd = isd::wgmma_desc(
              w12s + ((k * kCp + 32 * h) >> 3) * 16 * O + 16 * o0, 128, 16 * O);
          isd::wgmma_m64n32k16<0, 1>(accx[s], a, bd, !first || k > 0 || o0 > 0);
        }
      }
    }
  };
  // The current tile's last dx GEMM (unit ud), waited for, and its dx out:
  // each dx tile's columns [lo, w1) of the tile and channels c < C, written
  // from wf on, added before it (the seam, which tile j - 1 stored earlier
  // in this block: a barrier lies between).
  const int w4q = warp & 3, gq = lane >> 2, q = lane & 3;
  float* const dxw = out + (mbn * SZ + zs) * C * W;
  const auto flush_dx = [&](int ud) {
    isd::wgmma_fence();
    issue_dx(ud, nz == 1);
    isd::wgmma_commit();
    isd::wgmma_wait<0>();
#pragma unroll
    for (int s = 0; s < kSl; ++s) isd::fence_operand(accx[s]);
    clock.mark(kXDx);
    float* dst = dxw + ct.s;
#pragma unroll
    for (int s = 0; s < kSl; ++s) {
      const int tile = wg + kGroups * s;
      if (tile >= 2 * ct.nx) continue;
      const int mt = tile >> 1, h = tile & 1;
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int w = kRows * mt + 16 * w4q + 8 * ((i >> 1) & 1) + gq;
        const int c = 32 * h + 8 * (i >> 2) + 2 * q + (i & 1);
        if (w >= ct.lo && w < ct.w1 && c < C) {
          float* p = dst + static_cast<size_t>(c) * W + w;
          *p = kTiled && w < ct.wf ? *p + accx[s][i] : accx[s][i];
        }
      }
    }
  };

  const int units = nz * tiles;
  for (int u = 0; u < units; ++u) {
    const int j = kTiled ? u / nz : 0, z = z0 + (u - j * nz);
    const int zn = z + 1 < z1 ? z + 1 : z0, set = (u & 1) * plan.wset;  // the next unit's zone
    const bool more = u + 1 < units;
    const int e = ct.e, lo = ct.lo, hi = ct.hi;
    const float* bias = reinterpret_cast<const float*>(smem + set + plan.bias);
    const float* gz = reinterpret_cast<const float*>(smem + set + plan.gz);
    const uint32_t w12s = base + set + plan.w12, w3s = base + set + plan.w3,
                   w4s = base + set + plan.w4;
    conv_phase(  // h1 = bf16(w12 . p + b12); the next unit's w3, w4, b12 and g / t1 copied
                 // in behind it (into the last unit's set)
        [&](int tile) { conv_issue<K, O, false>(acc, base + plan.xs, cs, w12s, kCp, tile); },
        [&](int, int t, int o, float v0, float v1) {
          put(plan.h1, K / 2 + t, o, t < e ? isd::pack_bf16(v0 + bias[o], v1 + bias[o + 1]) : 0u);
        },
        [&] {
          if (more) copy34(zn, plan.wset - set);
        },
        drained, kXConv1, false);
    conv_phase(  // h2 = bf16(w3 . pad(h1))
        [&](int tile) { conv_issue<K, O, false>(acc, base + plan.h1, cs, w3s, O, tile); },
        [&](int, int t, int o, float v0, float v1) {
          put(plan.h2, K / 2 + t, o, t < e ? isd::pack_bf16(v0, v1) : 0u);
        },
        nothing, drained, kXConv2, false);
    conv_phase(  // h3 = w4 . pad(h2) -> dh3c = bf16(g / t1 * gelu'(h3)); the last zone's dx
                 // GEMM runs on under the GELU' epilogue
        [&](int tile) { conv_issue<K, O, false>(acc, base + plan.h2, cs, w4s, O, tile); },
        [&](int, int t, int o, float v0, float v1) {
          put(plan.d3, K / 2 + t, o,
              t < e ? isd::pack_bf16(gz[o] * gelu_grad_fast(v0), gz[o + 1] * gelu_grad_fast(v1))
                    : 0u);
        },
        [&] {
          if (z > z0) issue_dx(u - 1, z - 1 == z0);
        },
        behind, kXConv3, false);
    conv_phase(  // dh2c = bf16(conv4^T(dh3c)); the last zone's dx GEMM drained
        [&](int tile) { conv_issue<K, O, true>(acc, base + plan.d3, cs, w4s, O, tile); },
        [&](int, int t, int o, float v0, float v1) {
          put(plan.d2, K / 2 + t, o, t < e ? isd::pack_bf16(v0, v1) : 0u);
        },
        nothing, drained, kXConv4T, false);
    conv_phase(  // bf16(dh1) on the rows the tile keeps, dh1 = conv3^T(dh2c) in f32, from row
                 // K - 1; the next unit's w12 copied in behind it (the last zone's dx GEMM,
                 // which read that set's, drained), and every copy landed before the barrier
        [&](int tile) { conv_issue<K, O, true>(acc, base + plan.d2, cs, w3s, O, tile); },
        [&](int, int t, int o, float v0, float v1) {
          *reinterpret_cast<uint32_t*>(smem + plan.d1 + chunk_off(csx, K - 1 + t, o)) =
              t >= lo && t < hi ? isd::pack_bf16(v0, v1) : 0u;
        },
        [&] {
          if (more) copy12(zn, plan.wset - set);
        },
        drained, kXConv3T, true);
    if (kTiled && zn == z0 && more) {  // the tile's last zone: its dx out, the next tile in
      flush_dx(u);
      clock.sync(kXStore);
      ct = x_tile(plan, W, K, j + 1, tiles);
      window_to_chunks(smem + plan.xs, cs, xw + ct.s, C, T, ct.cols, plan.rows);
      if (ct.nt < plan.nt) {  // a short last tile: the rows past its own that its convs and
                              // dx GEMM read, which hold the tile before's values
        isd::zero_rows(smem + plan.h1, cs, (plan.d1 - plan.h1) / cs, ct.nt + K / 2, K - 1 - K / 2);
        isd::zero_rows(smem + plan.d1, csx, O / 8, ct.nt + K - 1, kRows);
      }
      isd::fence_proxy_async();
      clock.sync(kXTile);
    }
  }
  flush_dx(units - 1);
  clock.mark(kXStore);
  clock.finish(clk);
}

bool bad_geometry(int M, int B, int C, int T, int Z, int W, int step, int N, int SZ,
                  const float* part) {
  return M < 1 || B < 1 || Z < 1 || N < 1 || step < 1 || (N - 1) * step + W > T ||
         M > 65535 || B > 65535 || SZ < 1 || SZ > Z || static_cast<long long>(N) * SZ > 65535 ||
         (SZ > 1 && part == nullptr) || !x_plan_ok(C, W, 5);
}

// Bytes of the pre-pass's output: M x Z staged weight sets, then g / t1
// (M, B, N, Z*O) f32.
long long work_bytes(int M, int B, int N, int Z, int C, int O, int K) {
  const XPlan p = x_plan(C, kMaxT1 + K - 1, O, K);
  return static_cast<long long>(M) * Z * prep_bytes(p) +
         4LL * M * B * N * Z * O;
}

template <int O, int K, bool kClock>
cudaError_t launch_x(const float* g, const uint16_t* x, const float* w12, const float* b12,
                     const float* w3, const float* w4, float* dxw, float* part, void* work,
                     int M, int B, int C, int T, int Z, int W, int step, int N, int SZ,
                     unsigned long long* clk, cudaStream_t st) {
  const XPlan plan = x_block_plan(C, W, O, K);
  char* prep = static_cast<char*>(work);
  float* gs = reinterpret_cast<float*>(prep + static_cast<size_t>(M) * Z * prep_bytes(plan));
  conv4head_bwd_x_bf16_prep_kernel<O, K><<<dim3(Z, M, kPrepParts), 256, 0, st>>>(
      w12, b12, w3, w4, prep, C, Z);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long ng = static_cast<long long>(M) * B * N * Z * O;
  const int gblocks = static_cast<int>((ng + 255) / 256 < 1024 ? (ng + 255) / 256 : 1024);
  // g / t1 of the whole window, in column tiles too
  conv4head_bwd_x_bf16_scale_kernel<<<gblocks, 256, 0, st>>>(g, gs, ng, W - K + 1);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  const size_t smem_bytes = plan.total + (kClock ? isd::clock_bytes<kXPhases>() : 0);
  // The shipped model's geometry (64 channels, windows of 250) gets compile-time strides,
  // and so do column tiles (one plan for every window; C too at 64 channels).
  const auto kernel =
      !x_tiled(W, K) ? ((C == 64 && W == 250) ? conv4head_bwd_x_bf16_kernel<O, K, 64, 250, kClock>
                                              : conv4head_bwd_x_bf16_kernel<O, K, 0, 0, kClock>)
                     : (C == 64 ? conv4head_bwd_x_bf16_kernel<O, K, 64, -1, kClock>
                                : conv4head_bwd_x_bf16_kernel<O, K, 0, -1, kClock>);
  if ((err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  static_cast<int>(smem_bytes))) != cudaSuccess) {
    return err;
  }
  kernel<<<dim3(N * SZ, B, M), kWarpsB * 32, smem_bytes, st>>>(
      gs, x, prep, SZ > 1 ? part : dxw, B, C, T, Z, N, W, step, SZ, clk);
  if ((err = cudaGetLastError()) != cudaSuccess || SZ == 1) return err;
  return isd::sum_partials(part, dxw, M * B * N, SZ, C * W, st);
}

int bwd_x_bf16(const float* g, const void* x, const float* w12, const float* b12,
               const float* w3, const float* w4, float* dxw, float* part, void* work, int M,
               int B, int C, int T, int Z, int O, int K1, int K2, int W, int step, int N, int SZ,
               unsigned long long* clk, void* stream) {
  if (O != 32 || K1 != 5 || K2 != 5 || work == nullptr ||
      bad_geometry(M, B, C, T, Z, W, step, N, SZ, part)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const auto launch = clk ? launch_x<32, 5, true> : launch_x<32, 5, false>;
  return static_cast<int>(launch(g, static_cast<const uint16_t*>(x), w12, b12, w3, w4, dxw, part,
                                 work, M, B, C, T, Z, W, step, N, SZ, clk,
                                 static_cast<cudaStream_t>(stream)));
}

}  // namespace

// Dynamic shared memory of one B2x-bf16 block, in bytes: the whole
// window's plan, or past t1 = 256 the column tiles' (one plan for every
// window); -1 where it has no plan (C > 64). Mirrored by
// bwd_x_bf16_smem_bytes in ops/cuda/conv4head.py.
extern "C" int isd_conv4head_bwd_x_bf16_smem_bytes(int C, int W, int O, int K) {
  return x_plan_ok(C, W, K) ? x_block_plan(C, W, O, K).total : -1;
}

// Column tiles of one (trial, window) in B2x-bf16: 1 up to t1 = 256, else
// ceil((t1 - 16) / 240); mirrored by bwd_x_bf16_col_tiles.
extern "C" int isd_conv4head_bwd_x_bf16_col_tiles(int C, int W, int O, int K) {
  (void)C;
  (void)O;
  return x_tiled(W, K) ? isd::col_tile_count(W - K + 1) : 1;
}

// Bytes of B2x-bf16's scratch `work` (the pre-pass's staged weights and
// g / t1; 256-byte aligned).
extern "C" long long isd_conv4head_bwd_x_bf16_work_bytes(int M, int B, int N, int Z, int C,
                                                         int O, int K) {
  return work_bytes(M, B, N, Z, C, O, K);
}

// B2x-bf16. Arguments as isd_conv4head_bwd_x's, with x (M, B, C, T) bf16
// (any T, any alignment): output dxw (M, B, N, C, W) f32, the per-window
// input gradients; SZ zone ranges (1 <= SZ <= Z) per (model, trial,
// window), with SZ > 1 summed from the scratch part (M, B, N, SZ, C, W) by
// a fixed-order pass (null otherwise); scratch work of
// isd_conv4head_bwd_x_bf16_work_bytes. O = 32, K1 = K2 = 5 only.
extern "C" int isd_conv4head_bwd_x_bf16(const float* g, const void* x, const float* w12,
                                        const float* b12, const float* w3, const float* w4,
                                        float* dxw, float* part, void* work, int M, int B, int C,
                                        int T, int Z, int O, int K1, int K2, int W, int step,
                                        int N, int SZ, void* stream) {
  return bwd_x_bf16(g, x, w12, b12, w3, w4, dxw, part, work, M, B, C, T, Z, O, K1, K2, W, step,
                    N, SZ, nullptr, stream);
}

// The debug instantiation: as isd_conv4head_bwd_x_bf16, adding its phase
// counters to clk (kXPhases + 2 zeros on the device, see phase_clock.cuh).
extern "C" int isd_conv4head_bwd_x_bf16_phases(const float* g, const void* x, const float* w12,
                                               const float* b12, const float* w3,
                                               const float* w4, float* dxw, float* part,
                                               void* work, int M, int B, int C, int T, int Z,
                                               int O, int K1, int K2, int W, int step, int N,
                                               int SZ, void* clk, void* stream) {
  if (clk == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return bwd_x_bf16(g, x, w12, b12, w3, w4, dxw, part, work, M, B, C, T, Z, O, K1, K2, W, step,
                    N, SZ, static_cast<unsigned long long*>(clk), stream);
}
