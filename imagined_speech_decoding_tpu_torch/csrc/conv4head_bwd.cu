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
// ~10 M in B2x; one training step of 75 models at batch 64 is ~2.4 T FMAs
// of B2w. All operands are reused hundreds of times from shared memory, so
// both are compute-bound. B2w's bound is the fastest f32-accurate route,
// three TF32 tensor-core passes at 495 TFLOP/s: 29.3 ms for the step's
// 2.4 T FMAs (on the CUDA cores in f32, 67 TFLOP/s, it would be 72.2 ms).
//
// B2w: every product on the tensor cores, f32-exact (mma_tf32.cuh).
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
//    trial's window streams in by cp.async during the dw12 phase, into the
//    region whose activations are dead by then; the two regions swap roles
//    every trial. w12's halves go into space conv1 leaves free.
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
//    trial. No atomics: the result is bit-identical from run to run.
//
// B2x (f32 on the CUDA cores, one thread per time step) keeps the helpers
// of conv4head_common.cuh and the odd row strides of bwd_plan:
//  * one block per (model, trial, window) loops over the zones, so
//    the per-window input gradient accumulates zone by zone without any
//    race; windows overlap, so each window writes its own dxw slice and
//    the wrapper overlap-adds them, as the JAX package does in XLA.
// Both kernels take O and K as template arguments, instantiated only for
// the shipped model's O = 32, K1 = K2 = 5; B2w also needs C % 8 == 0 (a
// reduction step of 8 rows never straddles two taps).

#include <cuda_runtime.h>

#include "conv4head_common.cuh"
#include "mma_tf32.cuh"

namespace {

using isd::kThreads;
using isd::round_up4;

// Shared-memory plan of a backward block, in floats; every region starts
// 16-byte aligned.
struct BwdPlan {
  int lx, lt, cp;             // row strides of the window and activations; padded C
  int xs, r1, a, b, c, gz, total;
};

__host__ __device__ inline BwdPlan bwd_plan(int C, int W, int O, int K) {
  BwdPlan p;
  const int t1 = W - K + 1;
  p.lx = W | 1;
  p.lt = t1 | 1;
  p.cp = (C + 31) & ~31;  // w12 rows padded to whole 32-channel chunks for dx
  int r1 = isd::max_int(O * K * C, 2 * K * O * O);
  r1 = isd::max_int(r1, O * K * p.cp);
  p.xs = 0;
  p.r1 = p.xs + round_up4(C * p.lx);
  p.a = p.r1 + round_up4(r1);
  p.b = p.a + round_up4(O * p.lt);
  p.c = p.b + round_up4(O * p.lt);
  p.gz = p.c + round_up4(O * p.lt);
  p.total = p.gz + round_up4(O);
  return p;
}

// Per-model operand pointers.
struct Operands {
  const float* w12;  // (Z*O, K*C)
  const float* b12;  // (Z*O)
  const float* w3;   // (Z, O, K*O)
  const float* w4;
};

__device__ inline void stage_window(float* xs, int lx, const float* __restrict__ x, int C, int T,
                                    int W) {
  for (int i = threadIdx.x; i < C * W; i += blockDim.x) {
    const int c = i / W, j = i - c * W;
    xs[c * lx + j] = x[static_cast<size_t>(c) * T + j];
  }
}

// dxw[c * W + w] (+)= sum_{o, k} w12z[o, k*C + c] * d[o, w - k], 0 <= w - k < t1,
// with wpad the zone's w12 rows staged as wpad[(o * K + k) * cp + c] (zero
// for c >= C). A thread owns one window sample w, 32 channels at a time.
template <int O, int K>
__device__ inline void input_grad(float* __restrict__ dxw, bool first, const float* d, int ld,
                                  const float* wpad, int cp, int C, int W, int t1) {
  for (int w = threadIdx.x; w < W; w += blockDim.x) {
    for (int c0 = 0; c0 < C; c0 += 32) {
      float acc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) acc[j] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int tt = w - k;
        if (tt < 0 || tt >= t1) continue;
        for (int o = 0; o < O; ++o) isd::axpy_row<32>(acc, wpad + (o * K + k) * cp + c0, d[o * ld + tt]);
      }
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        if (c0 + j < C) {
          const size_t idx = static_cast<size_t>(c0 + j) * W + w;
          dxw[idx] = (first ? 0.f : dxw[idx]) + acc[j];
        }
      }
    }
  }
}

// One zone's backward for the window staged in xs: recompute h1 (a), h2
// (b), h3 (c); dh3 into c; dh2 into b; dh1 into c. g_z points at the
// zone's O cotangents. Ends synchronised, r1 free.
template <int O, int K>
__device__ void zone_backward(const BwdPlan& p, float* smem, const Operands& op,
                              const float* __restrict__ g_z, int z, int C, int t1) {
  float* xs = smem + p.xs;
  float* r1 = smem + p.r1;
  float* ha = smem + p.a;
  float* hb = smem + p.b;
  float* hc = smem + p.c;
  float* gz = smem + p.gz;
  const int kw = K * O * O;  // floats of one zone's w3 (or w4)

  isd::stage_transposed(r1, op.w12, z * O, O, K * C);
  if (threadIdx.x < O) gz[threadIdx.x] = g_z[threadIdx.x] / t1;  // d(mean) over the t1 real steps
  __syncthreads();
  isd::first_conv<O>(ha, p.lt, xs, p.lx, r1, op.b12 + z * O, C, K, t1);
  __syncthreads();

  isd::stage_transposed(r1, op.w3, z * O, O, K * O);
  isd::stage_transposed(r1 + kw, op.w4, z * O, O, K * O);
  __syncthreads();
  isd::same_conv<O, false>(hb, ha, p.lt, r1, K, t1, false);
  __syncthreads();
  isd::same_conv<O, false>(hc, hb, p.lt, r1 + kw, K, t1, false);
  __syncthreads();

  for (int i = threadIdx.x; i < O * t1; i += blockDim.x) {
    const int o = i / t1, t = i - o * t1;
    float* v = hc + o * p.lt + t;
    *v = gz[o] * isd::gelu_grad(*v);  // dh3
  }
  isd::stage_copy(r1, op.w3 + static_cast<size_t>(z) * kw, kw);
  isd::stage_copy(r1 + kw, op.w4 + static_cast<size_t>(z) * kw, kw);
  __syncthreads();
  isd::same_conv<O, true>(hb, hc, p.lt, r1 + kw, K, t1, false);  // dh2 = conv4^T(dh3)
  __syncthreads();
  isd::same_conv<O, true>(hc, hb, p.lt, r1, K, t1, false);  // dh1 = conv3^T(dh2)
  __syncthreads();
}

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

constexpr int kWarpsW = 16;  // B2w's block: 16 warps, one block per SM
constexpr int kUnrollW = 2;  // reduction steps per iteration of B2w's mma loops

// 8-column tiles per warp in each phase, for the shipped geometry's 31 time
// tiles, K*O/8 = 20 column tiles of dw3/dw4 and K*C/8 = 40 of dw12 (other
// geometries loop over more tiles, or compute some twice and store once).
constexpr int kNtConv = 32 / kWarpsW;                          // all warps, both row tiles
constexpr int kNtConvHalf = 64 / kWarpsW;                      // dh1 on half the warps
constexpr int kNtDw4 = (20 + kWarpsW / 2 - 1) / (kWarpsW / 2);  // all warps, one row tile
constexpr int kNtDw3 = 20 / (kWarpsW / 4);                     // half the warps
constexpr int kNtDw12 = 40 / (kWarpsW / 2);

// The least stride >= n that is 4 mod 8: rows g = 0..7 at columns q = 0..3
// (the A fragments, and the B fragments of the weight gradients) then fall
// in 32 distinct banks.
__host__ __device__ inline int stride_4mod8(int n) { return ((n + 3) & ~7) + 4; }

// Shared-memory plan of a B2w block, in floats. Two regions r[0], r[1]
// take turns: one holds the (trial's) window, C rows at stride ld from
// column 0; the other the activations h1 (rows 0..O-1) and h2 (from O*ld),
// each row stored from column K/2. A third activation buffer c, the
// zone's w3 and w4 (resident for the whole block), the cotangent row g/t1
// and the bias follow. w12's 32 rows are staged per trial in two halves of
// 16 (row stride lw1) into h2's and c's space, which conv1 leaves free.
struct TcPlan {
  int nt8;      // t1 rounded up to whole 8-column tiles
  int ld;       // >= nt8 + K - 1: the farthest column a tap's shift reaches
  int lw1, lw;  // row strides of the staged w12 rows and of w3 / w4
  int hsz;      // floats of one activation buffer, which also holds 16 rows of w12
  int r[2], c, w3, w4, gz, bias, total;
};

__host__ __device__ inline TcPlan tc_plan(int C, int W, int O, int K) {
  TcPlan p;
  p.nt8 = (W - K + 1 + 7) & ~7;
  p.ld = stride_4mod8(p.nt8 + K - 1);
  p.lw1 = stride_4mod8(K * C);
  p.lw = stride_4mod8(K * O);
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

// The window x[c, 0:W] (rows at stride T) to dst[c * ld + j] by cp.async,
// and zeros in its columns W..ld-1 (the conv's reach past the window).
__device__ inline void stage_window_async(float* dst, int ld, const float* __restrict__ x, int C,
                                          int T, int W) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int c = warp; c < C; c += kWarpsW) {
    const float* src = x + static_cast<size_t>(c) * T;
    float* row = dst + c * ld;
    for (int j = lane; j < W; j += 32) isd::cp_async4(row + j, src + j);
    for (int j = W + lane; j < ld; j += 32) row[j] = 0.f;
  }
}

// Rows o < 16 of w (O = 32 rows of `cols` floats, 16-byte aligned) to
// lo[o * ld], rows 16..31 to hi[(o - 16) * ld], by 16-byte cp.async.
__device__ inline void stage_rows_async(float* lo, float* hi, int ld, const float* __restrict__ w,
                                        int cols) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = warp; o < 32; o += kWarpsW) {
    float* row = o < 16 ? lo + o * ld : hi + (o - 16) * ld;
    const float* src = w + static_cast<size_t>(o) * cols;
    for (int j = 4 * lane; j < cols; j += 128) isd::cp_async16(row + j, src + j);
  }
}

// Zeros in the pad columns [0, K/2) and [K/2 + nt8, ld) of O activation
// rows: the 'same' convs' zero padding. Thread i of a team of `threads`.
template <int O, int K>
__device__ inline void zero_pads(float* dst, int ld, int nt8, int i, int threads) {
  const int tail = ld - K / 2 - nt8;
  const int per_row = K / 2 + tail;
  for (int e = i; e < O * per_row; e += threads) {
    const int o = e / per_row, j = e - o * per_row;
    dst[o * ld + (j < K / 2 ? j : nt8 + j)] = 0.f;
  }
}

// dst[o, K/2 + t] = epi(o, t, sum_r A[o, r] * src[c, t + shift]) for the
// nt8 columns t, r = k * Ch + c over K * Ch, and zeros in dst's pad
// columns. src is the window (stored from column 0) or an activation
// (from column K/2, so a 'same' conv's shift is the tap k too).
//  * kT false (a conv): A[o, k*Ch + c] = a_i[(o - 16 i) * lda + k*Ch + c] for
//    the row halves i = 0, 1 (a1 may be anywhere), and shift = k.
//  * kT true (the input gradient of a 'same' conv with weight w at a0,
//    w[o', k*O + o] at a0[o' * lda + k*O + o], Ch = O): A[o, k*O + o'] =
//    w[o', k*O + o] read in place, and shift = K - 1 - k.
// A team of kTeam warps (tw its warp) covers both 16-row tiles of the
// 8-column tiles tw, tw + kTeam, ... (NT at a time; a tile past the end is
// computed as the last one and not stored).
template <int K, bool kT, int NT, int kTeam, class Epi>
__device__ inline void conv_tc(float* dst, int ld, const float* a0, const float* a1, int lda,
                               const float* src, int lds, int Ch, int nt8, int tw, Epi epi) {
  const int lane = threadIdx.x & 31, g = lane >> 2, q = lane & 3;
  const int tiles = nt8 >> 3;
  zero_pads<32, K>(dst, ld, nt8, tw * 32 + lane, kTeam * 32);
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
#pragma unroll kUnrollW
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
          isd::ldmatrix_a(a[0], a0 + k * Ch + c0, lda);
          isd::ldmatrix_a(a[1], a1 + k * Ch + c0, lda);
        }
#pragma unroll
        for (int j = 0; j < NT; ++j) {
          const float* p = pb + c0 * lds + col[j];
          b[j][0] = p[0];
          b[j][1] = p[4 * lds];
        }
        isd::mma3_step<2, NT>(acc, a, b);
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
            *reinterpret_cast<float2*>(dst + row * ld + K / 2 + c) =
                make_float2(epi(row, c, acc[i][j][2 * h]), epi(row, c + 1, acc[i][j][2 * h + 1]));
          }
        }
      }
    }
  }
}

// dw[o * ldw + n] (+)= sum_{t < nt8} d[o, K/2 + t] * src[i, t + k] for
// n = k * Ch + i < K * Ch: the weight gradient of a conv whose input is
// the window (src from column 0) or an activation (from column K/2). d is
// zero from column K/2 + t1 on. A team of kTeam warps: warp tw owns the
// 16-row tile tw % 2 and the 8-column tiles tw / 2, tw / 2 + kTeam / 2, ...
// (NT at a time; a tile past the end is computed as the last one and not
// stored); each lane adds its fragments into fixed elements of dw.
template <int K, int NT, int kTeam>
__device__ inline void weight_grad_tc(float* __restrict__ dw, int ldw, bool first, const float* d,
                                      int ld, const float* src, int lds, int Ch, int nt8, int tw) {
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
#pragma unroll kUnrollW
    for (int t0 = 0; t0 < nt8; t0 += 8) {
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

// db[o] (+)= sum_{t < nt8} d[o, K/2 + t], one warp per row at a time.
template <int K>
__device__ inline void bias_grad(float* __restrict__ db, bool first, const float* d, int ld,
                                 int O, int nt8) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int o = warp; o < O; o += kWarpsW) {
    float s = 0.f;
    for (int t = lane; t < nt8; t += 32) s += d[o * ld + K / 2 + t];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) db[o] = (first ? 0.f : db[o]) + s;
  }
}

// B2w: block (z, p = n * S + s, m) covers trials [s*B/S, (s+1)*B/S) of
// window n and writes partial p of model m's zone-z gradients. Per trial,
// seven phases between barriers (h1 | h2 | h3, dh3 | dw4 | dh2 | dw3 and
// dh1 by two teams of eight warps | dw12, db12); the next trial's window
// streams in by cp.async during the last phase. kC, kW > 0 fix C and W at
// compile time (the shipped model's geometry), so every stride and trip
// count is a constant; 0 takes them from the arguments.
template <int O, int K, int kC, int kW>
__global__ void __launch_bounds__(kWarpsW * 32, 1)
conv4head_bwd_w_kernel(const float* __restrict__ g, const float* __restrict__ x,
                       const float* __restrict__ w12, const float* __restrict__ b12,
                       const float* __restrict__ w3, const float* __restrict__ w4,
                       float* __restrict__ pw12, float* __restrict__ pb12,
                       float* __restrict__ pw3, float* __restrict__ pw4, int B, int C_arg,
                       int T, int Z, int N, int W_arg, int step, int S) {
  static_assert(O == 32, "two 16-row tiles of O");
  const int C = kC > 0 ? kC : C_arg, W = kW > 0 ? kW : W_arg;
  constexpr int kHalf = kWarpsW / 2;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int z = blockIdx.x, p = blockIdx.y, m = blockIdx.z;
  const int n = p / S, s = p - n * S, P = N * S;
  const int t1 = W - K + 1;
  const int warp = threadIdx.x >> 5;
  const TcPlan plan = tc_plan(C, W, O, K);
  const int ld = plan.ld, nt8 = plan.nt8, lw = plan.lw, lw1 = plan.lw1;
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
  stage_rows_async(w3s, w3s + 16 * lw, lw, op.w3 + static_cast<size_t>(z) * O * K * O, K * O);
  stage_rows_async(w4s, w4s + 16 * lw, lw, op.w4 + static_cast<size_t>(z) * O * K * O, K * O);
  stage_window_async(smem + plan.r[0], ld, x + (static_cast<size_t>(m) * B + b0) * C * T + x_win,
                     C, T, W);
  stage_rows_async(smem + plan.r[1] + O * ld, hc, lw1, w12z, K * C);
  if (threadIdx.x < O) bias[threadIdx.x] = op.b12[z * O + threadIdx.x];
  isd::cp_async_wait_all();
  __syncthreads();

  const auto same = [&](int, int t, float v) { return t < t1 ? v : 0.f; };
  for (int b = b0; b < b1; ++b) {
    const size_t mb = static_cast<size_t>(m) * B + b;
    const bool first = b == b0;
    const bool odd = (b - b0) & 1;
    float* xs = smem + (odd ? plan.r[1] : plan.r[0]);
    float* ha = smem + (odd ? plan.r[0] : plan.r[1]);
    float* hb = ha + O * ld;
    if (threadIdx.x < O) gz[threadIdx.x] = g[(mb * N + n) * Z * O + z * O + threadIdx.x] / t1;
    conv_tc<K, false, kNtConv, kWarpsW>(  // h1
        ha, ld, hb, hc, lw1, xs, ld, C, nt8, warp,
        [&](int o, int t, float v) { return t < t1 ? v + bias[o] : 0.f; });
    __syncthreads();
    conv_tc<K, false, kNtConv, kWarpsW>(  // h2
        hb, ld, w3s, w3s + 16 * lw, lw, ha, ld, O, nt8, warp, same);
    __syncthreads();
    conv_tc<K, false, kNtConv, kWarpsW>(  // h3 -> dh3
        hc, ld, w4s, w4s + 16 * lw, lw, hb, ld, O, nt8, warp,
        [&](int o, int t, float v) { return t < t1 ? gz[o] * isd::gelu_grad(v) : 0.f; });
    __syncthreads();
    weight_grad_tc<K, kNtDw4, kWarpsW>(dw4z, K * O, first, hc, ld, hb, ld, O, nt8, warp);
    __syncthreads();
    conv_tc<K, true, kNtConv, kWarpsW>(  // dh2 = conv4^T(dh3)
        hb, ld, w4s, nullptr, lw, hc, ld, O, nt8, warp, same);
    __syncthreads();
    if (warp < kHalf) {
      weight_grad_tc<K, kNtDw3, kHalf>(dw3z, K * O, first, hb, ld, ha, ld, O, nt8, warp);
    } else {
      conv_tc<K, true, kNtConvHalf, kHalf>(  // dh1 = conv3^T(dh2)
          hc, ld, w3s, nullptr, lw, hb, ld, O, nt8, warp - kHalf, same);
    }
    __syncthreads();
    if (b + 1 < b1) stage_window_async(ha, ld, x + (mb + 1) * C * T + x_win, C, T, W);
    weight_grad_tc<K, kNtDw12, kWarpsW>(dw12z, K * C, first, hc, ld, xs, ld, C, nt8, warp);
    bias_grad<K>(db12z, first, hc, ld, O, nt8);
    __syncthreads();
    if (b + 1 < b1) {  // the next trial's w12 halves, into its h2's and c's space
      stage_rows_async(xs + O * ld, hc, lw1, w12z, K * C);
      isd::cp_async_wait_all();
      __syncthreads();
    }
  }
}

// out[m, l] = sum_p part[m, p, l] for l < L, in a fixed order.
__global__ void sum_partials_kernel(const float* __restrict__ part, float* __restrict__ out,
                                    int M, int P, int L) {
  const size_t total = static_cast<size_t>(M) * L;
  for (size_t i = blockIdx.x * static_cast<size_t>(blockDim.x) + threadIdx.x; i < total;
       i += static_cast<size_t>(gridDim.x) * blockDim.x) {
    const size_t m = i / L, l = i - m * L;
    const float* src = part + m * P * L + l;
    float acc = 0.f;
    for (int q = 0; q < P; ++q) acc += src[static_cast<size_t>(q) * L];
    out[i] = acc;
  }
}

cudaError_t sum_partials(const float* part, float* out, int M, int P, int L, cudaStream_t st) {
  const long long total = static_cast<long long>(M) * L;
  const int blocks = static_cast<int>((total + 255) / 256 < 4096 ? (total + 255) / 256 : 4096);
  sum_partials_kernel<<<blocks, 256, 0, st>>>(part, out, M, P, L);
  return cudaGetLastError();
}

// B2x: block (n, b, m) accumulates the window's input gradient over zones.
template <int O, int K>
__global__ void __launch_bounds__(kThreads)
conv4head_bwd_x_kernel(const float* __restrict__ g, const float* __restrict__ x,
                       const float* __restrict__ w12, const float* __restrict__ b12,
                       const float* __restrict__ w3, const float* __restrict__ w4,
                       float* __restrict__ dxw, int B, int C, int T, int Z, int N, int W,
                       int step) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int n = blockIdx.x, b = blockIdx.y, m = blockIdx.z;
  const int t1 = W - K + 1;
  const BwdPlan plan = bwd_plan(C, W, O, K);
  const Operands op = model_operands(w12, b12, w3, w4, m, Z, O, K, C);
  const size_t mb = static_cast<size_t>(m) * B + b;
  float* dxw_w = dxw + (mb * N + n) * C * W;
  float* r1 = smem + plan.r1;

  stage_window(smem + plan.xs, plan.lx, x + mb * C * T + static_cast<size_t>(n) * step, C, T, W);
  for (int z = 0; z < Z; ++z) {
    zone_backward<O, K>(plan, smem, op, g + (mb * N + n) * Z * O + z * O, z, C, t1);
    for (int i = threadIdx.x; i < O * K * plan.cp; i += blockDim.x) {
      const int o = i / (K * plan.cp), rem = i - o * K * plan.cp;
      const int k = rem / plan.cp, c = rem - k * plan.cp;
      r1[i] = c < C ? op.w12[static_cast<size_t>(z * O + o) * K * C + k * C + c] : 0.f;
    }
    __syncthreads();
    input_grad<O, K>(dxw_w, z == 0, smem + plan.c, plan.lt, r1, plan.cp, C, W, t1);
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
  const size_t smem_bytes = sizeof(float) * tc_plan(C, W, O, K).total;
  // The shipped model's geometry (64 channels, windows of 250) gets compile-time strides.
  const auto kernel = (C == 64 && W == 250) ? conv4head_bwd_w_kernel<O, K, 64, 250>
                                            : conv4head_bwd_w_kernel<O, K, 0, 0>;
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
                     const float* w3, const float* w4, float* dxw, int M, int B, int C, int T,
                     int Z, int W, int step, int N, cudaStream_t st) {
  const size_t smem_bytes = sizeof(float) * bwd_plan(C, W, O, K).total;
  cudaError_t err = cudaFuncSetAttribute(conv4head_bwd_x_kernel<O, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  conv4head_bwd_x_kernel<O, K><<<dim3(N, B, M), kThreads, smem_bytes, st>>>(
      g, x, w12, b12, w3, w4, dxw, B, C, T, Z, N, W, step);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one B2x block, in bytes.
extern "C" int isd_conv4head_bwd_smem_bytes(int C, int W, int O, int K) {
  return static_cast<int>(sizeof(float)) * bwd_plan(C, W, O, K).total;
}

// Dynamic shared memory of one B2w block, in bytes.
extern "C" int isd_conv4head_bwd_w_smem_bytes(int C, int W, int O, int K) {
  return static_cast<int>(sizeof(float)) * tc_plan(C, W, O, K).total;
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
// per-window input gradients (the caller overlap-adds the windows).
extern "C" int isd_conv4head_bwd_x(const float* g, const float* x, const float* w12,
                                   const float* b12, const float* w3, const float* w4,
                                   float* dxw, int M, int B, int C, int T, int Z, int O, int K1,
                                   int K2, int W, int step, int N, void* stream) {
  if (bad_geometry(M, B, C, T, Z, K1, K2, W, step, N)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O == 32 && K1 == 5 && K2 == 5) {
    return launch_x<32, 5>(g, x, w12, b12, w3, w4, dxw, M, B, C, T, Z, W, step, N, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
