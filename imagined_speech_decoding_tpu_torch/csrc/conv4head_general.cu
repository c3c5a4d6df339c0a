// General-geometry kernels of the fused sliding-window Conv4Layers zone
// head, for Hopper: B2f-g (forward), B2w-g (weight gradients) and B2x-g
// (per-window input gradients), each in f32 and in bf16 (a bf16 x).
//
// Replaces, for the geometries that the tuned kernels (conv4head.cu,
// conv4head_bwd.cu, conv4head_fwd_bf16.cu, conv4head_bwd_w_bf16.cu) have
// no plan for, the Pallas kernels of
// imagined_speech_decoding_tpu/ops/pallas/conv4head.py: _fwd_kernel (B2f-g,
// called by _fwd_impl), _bwd_w_kernel with _bwd_zone (B2w-g) and
// _bwd_x_kernel (B2x-g), both called by _bwd_rule. B2x-g's bf16
// instantiation is the only bf16 input gradient of the port. B2w-g bf16
// runs only at C > 72 or O > 32: B2w-bf16's column tiles take bf16 weight
// gradients at every window up to C = 64, the f32 route C = 65-72. What it
// computes per (model m, trial b, window n, zone z), t in [0, t1), t1 = W - K + 1:
//
//   h1 = w12z . patches(x window) + b12z      (O x t1, a valid conv over K*C)
//   h2 = conv3(h1), h3 = conv4(h2)            ('same', zeros at the window's ends)
//   out[o] = mean_t gelu(h3[o, t])            (exact erf GELU; B2f-g)
//   dh3 = g / t1 * gelu'(h3), dh2 = conv4^T(dh3), dh1 = conv3^T(dh2)
//   dw4 += dh3 (x) h2, dw3 += dh2 (x) h1, dw12 += dh1 (x) patches,
//   db12 += sum_t dh1                         (B2w-g)
//   dxw[c, w] = sum_{z, k, o} w12z[o, k*C + c] * dh1[o, w - k]   (B2x-g)
//
// In bf16 (x bf16, weights f32 and rounded to bf16 as they are read) it
// rounds where the Pallas kernel rounds: h1 and h2 to bf16, dh3 and dh2
// to bf16, dh1 to bf16 before the dw12 and dx products (db12 sums it
// unrounded); every sum in f32; the outputs f32 (the wrapper returns dx
// in x's dtype). The plain versions in ops/cuda/conv4head.py
// (_bf16_forward, conv4head_bwd_bf16_plain) spell out the same.
//
// What bounds it on the H100: work. At C = 64, O = 32, K = 5 and windows
// of 500 (t1 = 496) one (trial, window, zone) is 10.16 M FMAs forward (h1
// 5.08 M, h2 and h3 2.54 M each), 25.40 M in B2w-g (the forward's 10.16 M,
// then dw4, dh2, dw3, dh1 at 2.54 M and dw12 at 5.08 M); at the shipped
// windows of 250, 10.08 M in B2x-g (the recompute, dh2, dh1, dx). A
// training step of 75 models at batch 64 with 3 such windows is 1.17 T
// FMAs forward and 2.93 T in B2w-g; an attribution step at 100 trials
// 40.3 G in B2x-g. On the CUDA cores at 67 TFLOP/s (f32) that is at least
// 35, 87 and 1.2 ms; the port's bound for f32 heads is three TF32
// tensor-core passes at 495 TFLOP/s (14.2, 35.5 and 0.49 ms), for bf16 one
// pass at 989 (2.4, 5.9 and 0.08 ms).
//
// What the design does, and where it stops short:
//  * Shared memory does not depend on C, W or O: 13,568 bytes a block, two
//    GEMM tiles and the row sums' partials. Each product of a unit is a
//    GEMM out[r, s] = sum_{k < K, i < I} A(r, k, i) B(k, i, s) computed
//    tile by tile (32 rows x 64 columns, 256 threads, 2 x 4 outputs a
//    thread), its reduction staged in chunks of 32 (of channels, of O, or
//    of time for a weight gradient) with the next chunk's loads in
//    registers while the current one is summed. The tiles read A and B
//    through index functions: a conv's B is a view of its input shifted
//    by the tap (an implicit im2col), zero where the shift leaves [0, t1)
//    (the 'same' convs' padding at the window's true ends) or the tile
//    leaves the matrix.
//  * The intermediates of one unit (h1, h2, dh3, dh2, dh1: O x t1 each)
//    live in a global workspace, a slot of 2 (B2f-g), 4 (B2w-g) or 3
//    (B2x-g) such buffers a block, taken from torch's allocator by the
//    wrapper. The grid is persistent: min(units, resident blocks), each
//    block walking units blockIdx.x, + gridDim.x, ... in its own slot, so
//    the workspace is sized by the resident blocks, not by the units. A
//    phase writes its buffer and a barrier makes it visible to the block
//    before the next phase reads it; nothing is read through the
//    non-coherent cache. The halo of a tile is then just the next tile's
//    columns in the workspace: nothing is recomputed.
//  * Units: B2f-g a (model, trial, window, zone), writing its O features
//    once; B2x-g a (model, trial, window), its zones in order into the
//    window's slice of dxw (the first writes); B2w-g a (model, zone,
//    window, trial range): S ranges chosen by the wrapper to fill the
//    resident blocks, each unit adding its trials in order into its own
//    partial slice (the first writes), then sum_partials.cuh's
//    fixed-order pass over the N * S partials. Row sums (the time-mean,
//    db12) run in a fixed order through shared memory. No atomics: reruns
//    are bit-identical.
//  * CUDA-core FMAs in f32 (fmaf), one warp-uniform path: no tensor
//    cores, no TMA, no tuning. Measured on an H100 80GB HBM3 at 700 W
//    (PERF.md): 128 registers, 2 blocks an SM; at the training step above
//    141.88 ms forward and 510.29 ms in B2w-g (f32), 522.58 ms in B2w-g
//    bf16, 10%, 7% and 1% of their bounds (25%, 17% and 17% of the CUDA
//    cores'; that bf16 step now runs B2w-bf16's column tiles); B2x-g bf16
//    6.50 ms at 100 trials. The tensor-core redesigns still to come are in
//    ROADMAP.md.
//  * No host synchronisation and no allocation inside: a launch is
//    captured in a CUDA graph like any other kernel (the decoders capture
//    isd::conv4head_fwd).
// K1 = K2 = 5 (the Pallas kernel's _cfg_of); C, T, W, step, O and Z are
// runtime values. The device code uses nothing but barriers, so
// tests/test_torch_conv4head_general.py builds it with the host compiler
// and runs it block by block on the CPU; the launch entry points below
// are compiled by nvcc only.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <type_traits>

#include "conv4head_common.cuh"

namespace {

constexpr int kK = 5;          // K1 = K2
constexpr int kThreads = 256;  // a block: 16 x 16 threads over a 32 x 64 output tile
constexpr int kBM = 32, kBN = 64, kBK = 32;
constexpr int kParts = kThreads / 32;  // partial sums a row in row_sums

struct Smem {
  float a[kBK][kBM + 2];  // A chunk, [reduction][row]; rows padded for the stores' banks
  float b[kBK][kBN];      // B chunk, [reduction][column]
  float red[kParts][32];  // row_sums' partial sums
};

template <bool BF16>
using XT = typename std::conditional<BF16, __nv_bfloat16, float>::type;

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) { return __bfloat162float(v); }

// v as the precision holds it: bf16 rounds to nearest even, f32 keeps it.
template <bool BF16>
__device__ __forceinline__ float held(float v) {
  if constexpr (BF16) {
    return __bfloat162float(__float2bfloat16_rn(v));
  } else {
    return v;
  }
}

// out(r, s, sum_{k < KR, i < I} fa(r, k, i) * fb(k, i, s)) for r < R, s < S,
// by 32 x 64 tiles; each thread sums its 2 x 4 outputs over the chunks in
// order (k, then i in chunks of kBK), so the result does not depend on
// timing. Starts with no barrier: a caller whose A or B was written by
// other threads puts one before.
template <class FA, class FB, class FO>
__device__ void gemm(Smem& sm, int R, int S, int KR, int I, const FA& fa, const FB& fb,
                     const FO& out) {
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int ci = (I + kBK - 1) / kBK, chunks = KR * ci;
  for (int r0 = 0; r0 < R; r0 += kBM) {
    for (int s0 = 0; s0 < S; s0 += kBN) {
      float acc[2][4] = {};
      float pa[4], pb[8];
      const auto fetch = [&](int ch) {
        const int k = ch / ci, i0 = (ch - k * ci) * kBK;
        const int ia = i0 + (tid & 31);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int r = r0 + (tid >> 5) + 8 * j;
          pa[j] = (ia < I && r < R) ? fa(r, k, ia) : 0.f;
        }
        const int s = s0 + (tid & 63);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int i = i0 + (tid >> 6) + 4 * j;
          pb[j] = (i < I && s < S) ? fb(k, i, s) : 0.f;
        }
      };
      fetch(0);
      for (int ch = 0; ch < chunks; ++ch) {
        __syncthreads();  // the previous chunk's (or tile's) reads of sm are done
#pragma unroll
        for (int j = 0; j < 4; ++j) sm.a[tid & 31][(tid >> 5) + 8 * j] = pa[j];
#pragma unroll
        for (int j = 0; j < 8; ++j) sm.b[(tid >> 6) + 4 * j][tid & 63] = pb[j];
        __syncthreads();
        if (ch + 1 < chunks) fetch(ch + 1);
#pragma unroll 8
        for (int kk = 0; kk < kBK; ++kk) {
          const float2 a = *reinterpret_cast<const float2*>(&sm.a[kk][2 * ty]);
          const float4 b = *reinterpret_cast<const float4*>(&sm.b[kk][4 * tx]);
          const float av[2] = {a.x, a.y}, bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
          for (int i = 0; i < 2; ++i) {
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = r0 + 2 * ty + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = s0 + 4 * tx + j;
          if (r < R && s < S) out(r, s, acc[i][j]);
        }
      }
    }
  }
}

// out(o, sum_{t < L} v(o, t)) for o < R: thread (lane, part) sums t = part,
// part + kParts, ... of row r0 + lane, then lane's row adds the parts in
// order. Barriers inside: every thread calls it; v's writers are done.
template <class FV, class FO>
__device__ void row_sums(Smem& sm, int R, int L, const FV& v, const FO& out) {
  const int lane = threadIdx.x & 31, part = threadIdx.x >> 5;
  for (int r0 = 0; r0 < R; r0 += 32) {
    const int o = r0 + lane;
    float s = 0.f;
    if (o < R) {
      for (int t = part; t < L; t += kParts) s += v(o, t);
    }
    sm.red[part][lane] = s;
    __syncthreads();
    if (part == 0 && o < R) {
      float total = sm.red[0][lane];
      for (int p = 1; p < kParts; ++p) total += sm.red[p][lane];
      out(o, total);
    }
    __syncthreads();
  }
}

// One zone's operands of model m: w12 rows z*O.. (K*C each), b12, w3, w4.
struct Zone {
  const float* w12;
  const float* b12;
  const float* w3;
  const float* w4;
};

__device__ inline Zone zone_of(const float* w12, const float* b12, const float* w3,
                               const float* w4, long long m, int z, int Z, int O, int C) {
  const size_t mz = static_cast<size_t>(m) * Z + z;
  Zone q;
  q.w12 = w12 + mz * O * kK * C;
  q.b12 = b12 + mz * O;
  q.w3 = w3 + mz * O * kK * O;
  q.w4 = w4 + mz * O * kK * O;
  return q;
}

// h[o, t] = held(w12z . patches + b12z): xw is the window's first sample
// of channel 0, channels at stride T.
template <bool BF16>
__device__ void conv1(Smem& sm, float* h, const XT<BF16>* xw, int T, const Zone& q, int C,
                      int O, int t1) {
  const int kc = kK * C;
  const float* w = q.w12;
  const float* bias = q.b12;
  gemm(
      sm, O, t1, kK, C,
      [=](int o, int k, int c) { return held<BF16>(w[static_cast<size_t>(o) * kc + k * C + c]); },
      [=](int k, int c, int t) { return to_float(xw[static_cast<size_t>(c) * T + t + k]); },
      [=](int o, int t, float v) { h[static_cast<size_t>(o) * t1 + t] = held<BF16>(v + bias[o]); });
}

// out(o, t, sum_{k, i} wz[o, k*O + i] * hin[i, t + k - K/2]): a 'same' conv.
template <bool BF16, class FO>
__device__ void same_conv(Smem& sm, const float* hin, const float* wz, int O, int t1,
                          const FO& out) {
  const int ko = kK * O;
  gemm(
      sm, O, t1, kK, O,
      [=](int o, int k, int i) { return held<BF16>(wz[static_cast<size_t>(o) * ko + k * O + i]); },
      [=](int k, int i, int t) {
        const int u = t + k - kK / 2;
        return u >= 0 && u < t1 ? hin[static_cast<size_t>(i) * t1 + u] : 0.f;
      },
      out);
}

// out(i, t, sum_{o, k} wz[o, k*O + i] * d[o, t + K/2 - k]): a 'same'
// conv's input gradient.
template <bool BF16, class FO>
__device__ void same_conv_t(Smem& sm, const float* d, const float* wz, int O, int t1,
                            const FO& out) {
  const int ko = kK * O;
  gemm(
      sm, O, t1, kK, O,
      [=](int i, int k, int o) { return held<BF16>(wz[static_cast<size_t>(o) * ko + k * O + i]); },
      [=](int k, int o, int t) {
        const int u = t + kK / 2 - k;
        return u >= 0 && u < t1 ? d[static_cast<size_t>(o) * t1 + u] : 0.f;
      },
      out);
}

// dw[o, k*I + i] (+)= sum_{t < t1} d(o, t) * src(i, t + k); `first` writes.
template <class FD, class FX>
__device__ void weight_grad(Smem& sm, float* dw, bool first, int O, int I, int t1, const FD& d,
                            const FX& src) {
  const int ki = kK * I;
  gemm(
      sm, O, ki, 1, t1, [=](int o, int, int t) { return d(o, t); },
      [=](int, int t, int s) {
        const int k = s / I;
        return src(s - k * I, t + k);
      },
      [=](int o, int s, float v) {
        float* p = dw + static_cast<size_t>(o) * ki + s;
        *p = first ? v : *p + v;
      });
}

// ---- B2f-g: block walks (model, trial, window, zone) units ----
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
conv4head_fwd_general_kernel(const XT<BF16>* __restrict__ x, const float* __restrict__ w12,
                             const float* __restrict__ b12, const float* __restrict__ w3,
                             const float* __restrict__ w4, float* __restrict__ out, float* work,
                             int M, int B, int C, int T, int Z, int O, int W, int step, int N) {
  __shared__ __align__(16) Smem sm;
  const int t1 = W - kK + 1;
  const size_t hs = static_cast<size_t>(O) * t1;
  float* ha = work + blockIdx.x * 2 * hs;
  float* hb = ha + hs;
  const long long units = static_cast<long long>(M) * B * N * Z;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int z = static_cast<int>(u % Z);
    const long long mbn = u / Z;  // (m * B + b) * N + n
    const int n = static_cast<int>(mbn % N);
    const long long mb = mbn / N;
    const Zone q = zone_of(w12, b12, w3, w4, mb / B, z, Z, O, C);
    conv1<BF16>(sm, ha, x + static_cast<size_t>(mb) * C * T + static_cast<size_t>(n) * step, T,
                q, C, O, t1);
    __syncthreads();
    same_conv<BF16>(sm, ha, q.w3, O, t1, [=](int o, int t, float v) {
      hb[static_cast<size_t>(o) * t1 + t] = held<BF16>(v);
    });
    __syncthreads();
    same_conv<BF16>(sm, hb, q.w4, O, t1, [=](int o, int t, float v) {
      ha[static_cast<size_t>(o) * t1 + t] = isd::gelu(v);
    });
    __syncthreads();
    float* feat = out + static_cast<size_t>(mbn) * Z * O + static_cast<size_t>(z) * O;
    row_sums(
        sm, O, t1, [=](int o, int t) { return ha[static_cast<size_t>(o) * t1 + t]; },
        [=](int o, float s) { feat[o] = s / t1; });
  }
}

// The forward's recompute and the backward through the zone's tail to dh1
// (_bwd_zone): h1 in ha, h2 in hb, dh3 in hc, dh2 in hd (B2w-g) or ha
// (B2x-g, h1 being dead), dh1 into hc (held, for B2x-g; unrounded for
// B2w-g, whose db12 sums it so). gz is the window's cotangent row of the
// zone. Between the phases, barriers; the last phase's writes too are
// followed by one.
template <bool BF16, bool kHeldDh1, class FW4, class FW3>
__device__ void backward_to_dh1(Smem& sm, const XT<BF16>* xw, int T, const Zone& q,
                                const float* gz, int C, int O, int t1, float* ha, float* hb,
                                float* hc, float* hd, const FW4& dw4, const FW3& dw3) {
  conv1<BF16>(sm, ha, xw, T, q, C, O, t1);
  __syncthreads();
  same_conv<BF16>(sm, ha, q.w3, O, t1, [=](int o, int t, float v) {
    hb[static_cast<size_t>(o) * t1 + t] = held<BF16>(v);
  });
  __syncthreads();
  same_conv<BF16>(sm, hb, q.w4, O, t1, [=](int o, int t, float v) {
    hc[static_cast<size_t>(o) * t1 + t] = held<BF16>(gz[o] / t1 * isd::gelu_grad(v));
  });
  __syncthreads();
  dw4();  // reads dh3 (hc) and h2 (hb)
  same_conv_t<BF16>(sm, hc, q.w4, O, t1, [=](int i, int t, float v) {
    hd[static_cast<size_t>(i) * t1 + t] = held<BF16>(v);
  });
  __syncthreads();
  dw3();  // reads dh2 (hd) and h1 (ha)
  same_conv_t<BF16>(sm, hd, q.w3, O, t1, [=](int i, int t, float v) {
    hc[static_cast<size_t>(i) * t1 + t] = kHeldDh1 ? held<BF16>(v) : v;
  });
  __syncthreads();
}

// ---- B2w-g: block walks (model, partial p = n * S + s, zone) units ----
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
conv4head_bwd_w_general_kernel(const float* __restrict__ g, const XT<BF16>* __restrict__ x,
                               const float* __restrict__ w12, const float* __restrict__ b12,
                               const float* __restrict__ w3, const float* __restrict__ w4,
                               float* __restrict__ pw12, float* __restrict__ pb12,
                               float* __restrict__ pw3, float* __restrict__ pw4, float* work,
                               int M, int B, int C, int T, int Z, int O, int W, int step, int N,
                               int S) {
  __shared__ __align__(16) Smem sm;
  const int t1 = W - kK + 1;
  const size_t hs = static_cast<size_t>(O) * t1;
  float* ha = work + blockIdx.x * 4 * hs;
  float* hb = ha + hs;
  float* hc = hb + hs;
  float* hd = hc + hs;
  const int P = N * S;
  const long long units = static_cast<long long>(M) * P * Z;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int z = static_cast<int>(u % Z);
    const long long mp = u / Z;  // m * P + p
    const int p = static_cast<int>(mp % P);
    const long long m = mp / P;
    const int n = p / S, s = p - n * S;
    const Zone q = zone_of(w12, b12, w3, w4, m, z, Z, O, C);
    const size_t mz = static_cast<size_t>(mp) * Z + z;  // this partial's zone slice
    float* dw12 = pw12 + mz * O * kK * C;
    float* db12 = pb12 + mz * O;
    float* dw3 = pw3 + mz * O * kK * O;
    float* dw4 = pw4 + mz * O * kK * O;
    const int b0 = static_cast<int>(static_cast<long long>(s) * B / S);
    const int b1 = static_cast<int>(static_cast<long long>(s + 1) * B / S);
    for (int b = b0; b < b1; ++b) {
      const bool first = b == b0;
      const size_t mb = static_cast<size_t>(m) * B + b;
      const XT<BF16>* xw = x + mb * C * T + static_cast<size_t>(n) * step;
      const float* gz = g + (mb * N + n) * Z * O + static_cast<size_t>(z) * O;
      const auto shifted = [=](const float* h) {  // h[i, u - K/2], zero outside [0, t1)
        return [=](int i, int u) {
          const int t = u - kK / 2;
          return t >= 0 && t < t1 ? h[static_cast<size_t>(i) * t1 + t] : 0.f;
        };
      };
      const auto rows = [=](const float* h) {
        return [=](int o, int t) { return h[static_cast<size_t>(o) * t1 + t]; };
      };
      backward_to_dh1<BF16, false>(
          sm, xw, T, q, gz, C, O, t1, ha, hb, hc, hd,
          [&] { weight_grad(sm, dw4, first, O, O, t1, rows(hc), shifted(hb)); },
          [&] { weight_grad(sm, dw3, first, O, O, t1, rows(hd), shifted(ha)); });
      weight_grad(
          sm, dw12, first, O, C, t1,
          [=](int o, int t) { return held<BF16>(hc[static_cast<size_t>(o) * t1 + t]); },
          [=](int c, int u) { return to_float(xw[static_cast<size_t>(c) * T + u]); });
      row_sums(sm, O, t1, rows(hc), [=](int o, float v) { db12[o] = first ? v : db12[o] + v; });
    }
  }
}

// ---- B2x-g: block walks (model, trial, window) units, zones in order ----
template <bool BF16>
__global__ void __launch_bounds__(kThreads)
conv4head_bwd_x_general_kernel(const float* __restrict__ g, const XT<BF16>* __restrict__ x,
                               const float* __restrict__ w12, const float* __restrict__ b12,
                               const float* __restrict__ w3, const float* __restrict__ w4,
                               float* __restrict__ dxw, float* work, int M, int B, int C, int T,
                               int Z, int O, int W, int step, int N) {
  __shared__ __align__(16) Smem sm;
  const int t1 = W - kK + 1;
  const size_t hs = static_cast<size_t>(O) * t1;
  float* ha = work + blockIdx.x * 3 * hs;
  float* hb = ha + hs;
  float* hc = hb + hs;
  const long long units = static_cast<long long>(M) * B * N;
  for (long long u = blockIdx.x; u < units; u += gridDim.x) {
    const int n = static_cast<int>(u % N);
    const long long mb = u / N;
    const XT<BF16>* xw = x + static_cast<size_t>(mb) * C * T + static_cast<size_t>(n) * step;
    float* dx = dxw + static_cast<size_t>(u) * C * W;
    for (int z = 0; z < Z; ++z) {
      const Zone q = zone_of(w12, b12, w3, w4, mb / B, z, Z, O, C);
      const float* gz = g + static_cast<size_t>(u) * Z * O + static_cast<size_t>(z) * O;
      backward_to_dh1<BF16, true>(sm, xw, T, q, gz, C, O, t1, ha, hb, hc, ha, [] {}, [] {});
      const int kc = kK * C;
      const float* w = q.w12;
      const bool first = z == 0;
      gemm(
          sm, C, W, kK, O,
          [=](int c, int k, int o) {
            return held<BF16>(w[static_cast<size_t>(o) * kc + k * C + c]);
          },
          [=](int k, int o, int col) {
            const int t = col - k;
            return t >= 0 && t < t1 ? hc[static_cast<size_t>(o) * t1 + t] : 0.f;
          },
          [=](int c, int col, float v) {
            float* p = dx + static_cast<size_t>(c) * W + col;
            *p = first ? v : *p + v;
          });
      __syncthreads();  // hc and the workspace are rewritten by the next zone
    }
  }
}

// Workspace floats a block of op takes: 2, 4 or 3 buffers of O x t1.
constexpr int kBuffers[3] = {2, 4, 3};

}  // namespace

// Workspace floats of one slot of op (0 B2f-g, 1 B2w-g, 2 B2x-g) at O and
// windows of W: the wrapper's (and the CPU emulation's) only source of it.
extern "C" long long isd_conv4head_general_slot_floats(int op, int O, int W) {
  return op < 0 || op > 2 ? -1 : static_cast<long long>(kBuffers[op]) * O * (W - kK + 1);
}

#if defined(__CUDACC__)

#include "sum_partials.cuh"

namespace {

template <bool BF16>
const void* kernel_of(int op) {
  switch (op) {
    case 0: return reinterpret_cast<const void*>(conv4head_fwd_general_kernel<BF16>);
    case 1: return reinterpret_cast<const void*>(conv4head_bwd_w_general_kernel<BF16>);
    default: return reinterpret_cast<const void*>(conv4head_bwd_x_general_kernel<BF16>);
  }
}

bool bad_geometry(int M, int B, int C, int T, int Z, int O, int K1, int K2, int W, int step, int N,
                  int grid) {
  return M < 1 || B < 1 || C < 1 || Z < 1 || O < 1 || N < 1 || K1 != kK || K2 != kK || W < kK ||
         step < 1 || static_cast<long long>(N - 1) * step + W > T || grid < 1;
}

}  // namespace

// Resident blocks of op (0 B2f-g, 1 B2w-g, 2 B2x-g) in the precision bf16
// (0 or 1) on the current device: the grid the wrapper launches at most,
// and the number of workspace slots. -1 on a CUDA error.
extern "C" int isd_conv4head_general_slots(int op, int bf16) {
  int dev = 0, sms = 0, per_sm = 0;
  const void* kernel = bf16 ? kernel_of<true>(op) : kernel_of<false>(op);
  if (op < 0 || op > 2 || cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0) != cudaSuccess) {
    return -1;
  }
  return sms * per_sm;
}

// B2f-g. x (M, B, C, T) f32 or bf16 (bf16 = 1), w12 (M, Z*O, K*C), b12
// (M, Z*O), w3 / w4 (M, Z, O, K*O) f32; out (M, B, N, Z*O) f32; work
// grid slots of isd_conv4head_general_slot_floats(0, O, W) floats.
extern "C" int isd_conv4head_fwd_general(const void* x, const float* w12, const float* b12,
                                         const float* w3, const float* w4, float* out,
                                         float* work, int M, int B, int C, int T, int Z, int O,
                                         int K1, int K2, int W, int step, int N, int grid,
                                         int bf16, void* stream) {
  if (bad_geometry(M, B, C, T, Z, O, K1, K2, W, step, N, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    conv4head_fwd_general_kernel<true><<<grid, kThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), w12, b12, w3, w4, out, work, M, B, C, T, Z, O, W,
        step, N);
  } else {
    conv4head_fwd_general_kernel<false><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(x), w12, b12, w3, w4, out, work, M, B, C, T, Z, O, W, step, N);
  }
  return static_cast<int>(cudaGetLastError());
}

// B2w-g. g (M, B, N, Z*O) f32, x and the weights as B2f-g's; outputs dw12,
// db12, dw3, dw4 in the weights' shapes, f32; scratch pw12 / pb12 / pw3 /
// pw4 the same with a partial axis P = N*S after M, and the workspace.
extern "C" int isd_conv4head_bwd_w_general(const float* g, const void* x, const float* w12,
                                           const float* b12, const float* w3, const float* w4,
                                           float* dw12, float* db12, float* dw3, float* dw4,
                                           float* pw12, float* pb12, float* pw3, float* pw4,
                                           float* work, int M, int B, int C, int T, int Z, int O,
                                           int K1, int K2, int W, int step, int N, int S, int grid,
                                           int bf16, void* stream) {
  if (bad_geometry(M, B, C, T, Z, O, K1, K2, W, step, N, grid) || S < 1 || S > B) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    conv4head_bwd_w_general_kernel<true><<<grid, kThreads, 0, st>>>(
        g, static_cast<const __nv_bfloat16*>(x), w12, b12, w3, w4, pw12, pb12, pw3, pw4, work, M,
        B, C, T, Z, O, W, step, N, S);
  } else {
    conv4head_bwd_w_general_kernel<false><<<grid, kThreads, 0, st>>>(
        g, static_cast<const float*>(x), w12, b12, w3, w4, pw12, pb12, pw3, pw4, work, M, B, C, T,
        Z, O, W, step, N, S);
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int P = N * S;
  if ((err = isd::sum_partials(pw12, dw12, M, P, Z * O * kK * C, st)) != cudaSuccess ||
      (err = isd::sum_partials(pb12, db12, M, P, Z * O, st)) != cudaSuccess ||
      (err = isd::sum_partials(pw3, dw3, M, P, Z * O * kK * O, st)) != cudaSuccess) {
    return static_cast<int>(err);
  }
  return static_cast<int>(isd::sum_partials(pw4, dw4, M, P, Z * O * kK * O, st));
}

// B2x-g. g, x and the weights as B2w-g's; output dxw (M, B, N, C, W) f32,
// the per-window input gradients summed over the zones (the wrapper
// overlap-adds the windows).
extern "C" int isd_conv4head_bwd_x_general(const float* g, const void* x, const float* w12,
                                           const float* b12, const float* w3, const float* w4,
                                           float* dxw, float* work, int M, int B, int C, int T,
                                           int Z, int O, int K1, int K2, int W, int step, int N,
                                           int grid, int bf16, void* stream) {
  if (bad_geometry(M, B, C, T, Z, O, K1, K2, W, step, N, grid)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (bf16) {
    conv4head_bwd_x_general_kernel<true><<<grid, kThreads, 0, st>>>(
        g, static_cast<const __nv_bfloat16*>(x), w12, b12, w3, w4, dxw, work, M, B, C, T, Z, O, W,
        step, N);
  } else {
    conv4head_bwd_x_general_kernel<false><<<grid, kThreads, 0, st>>>(
        g, static_cast<const float*>(x), w12, b12, w3, w4, dxw, work, M, B, C, T, Z, O, W, step,
        N);
  }
  return static_cast<int>(cudaGetLastError());
}

#endif  // __CUDACC__
