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
// the kernels are compute-bound on the CUDA cores (f32, no tensor cores in
// this first version).
//
// What the design does about it:
//  * Blocks run concurrently, so the TPU kernel's accumulation into output
//    blocks that every grid cell revisits does not carry over. Rows
//    z*O..(z+1)*O of dw12 and db12, and dw3[z], dw4[z], depend on zone z
//    alone, so a B2w block owns one (model, zone, window, trial range) and
//    accumulates into its own slice of a partial buffer (P = N * S
//    partials per model, S trial ranges chosen by the wrapper to fill the
//    SMs); a second, deterministic pass sums the P partials. No atomics:
//    the result is bit-identical from run to run.
//  * Shared memory: the block holds the window (C x W), one staging
//    region for the weights of the current phase (the zone's w12 rows
//    transposed, then w3/w4 transposed, then w3/w4 as stored), and three
//    (O, t1) activations that the phases recycle (h1 | h2 -> dh2 | h3 ->
//    dh3 -> dh1): 200 KB at full width. The weights are restaged from L2
//    for every (trial, window), ~120 KB against ~50 K FMAs per thread.
//    The gradient accumulators are not held on chip: each thread owns a
//    fixed set of output elements and adds its (trial, window) sum into
//    the block's slice in device memory once per iteration (< 100
//    read-modify-writes per thread against ~50 K FMAs).
//  * Rows of the window and of the activations get odd strides, so lanes
//    that walk rows (the weight gradients) hit distinct banks.
//  * B2x: one block per (model, trial, window) loops over the zones, so
//    the per-window input gradient accumulates zone by zone without any
//    race; windows overlap, so each window writes its own dxw slice and
//    the wrapper overlap-adds them, as the JAX package does in XLA.
//  * O and K are template arguments, instantiated only for the shipped
//    model's O = 32, K1 = K2 = 5.

#include <cuda_runtime.h>

#include "conv4head_common.cuh"

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

// dw[(o * K + k) * O + i] (+)= sum_t d[o, t] * src[i, t + k - K/2], zero
// outside [0, t1): the weight gradient of a 'same' tail conv. Thread j owns
// input channel i = j % O and O*O/kThreads output channels o, for all K taps.
template <int O, int K>
__device__ inline void tail_weight_grad(float* __restrict__ dw, bool first, const float* d,
                                        const float* src, int ld, int t1) {
  constexpr int kGroups = kThreads / O;
  constexpr int kPer = O / kGroups;
  static_assert(kThreads % O == 0 && O % kGroups == 0, "thread layout");
  constexpr int pad = K / 2;
  const int i = threadIdx.x % O, g = threadIdx.x / O;
  float acc[kPer][K];
  float win[K];
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
#pragma unroll
    for (int k = 0; k < K; ++k) acc[r][k] = 0.f;
  }
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int s = k - pad;
    win[k] = (s >= 0 && s < t1) ? src[i * ld + s] : 0.f;
  }
  for (int t = 0; t < t1; ++t) {
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
      const float dv = d[(g * kPer + r) * ld + t];
#pragma unroll
      for (int k = 0; k < K; ++k) acc[r][k] += dv * win[k];
    }
#pragma unroll
    for (int k = 0; k < K - 1; ++k) win[k] = win[k + 1];
    const int s = t + K - pad;
    win[K - 1] = s < t1 ? src[i * ld + s] : 0.f;
  }
#pragma unroll
  for (int r = 0; r < kPer; ++r) {
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int idx = ((g * kPer + r) * K + k) * O + i;
      dw[idx] = (first ? 0.f : dw[idx]) + acc[r][k];
    }
  }
}

// dw12[o * K*C + k * C + c] (+)= sum_{t < t1} d[o, t] * xs[c, t + k] and
// db12[o] (+)= sum_t d[o, t]: the weight gradients of the first conv.
// A thread owns one channel c and eight output rows o, for all K taps.
template <int O, int K>
__device__ inline void first_weight_grad(float* __restrict__ dw12, float* __restrict__ db12,
                                         bool first, const float* d, int ld, const float* xs,
                                         int lx, int C, int t1) {
  constexpr int kPer = 8;
  constexpr int kGroups = O / kPer;
  static_assert(O % kPer == 0, "thread layout");
  for (int pair = threadIdx.x; pair < C * kGroups; pair += blockDim.x) {
    const int c = pair % C, g = pair / C;
    const float* xr = xs + c * lx;
    float acc[kPer][K];
    float win[K];
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
#pragma unroll
      for (int k = 0; k < K; ++k) acc[r][k] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < K; ++k) win[k] = xr[k];
    for (int t = 0; t < t1; ++t) {
#pragma unroll
      for (int r = 0; r < kPer; ++r) {
        const float dv = d[(g * kPer + r) * ld + t];
#pragma unroll
        for (int k = 0; k < K; ++k) acc[r][k] += dv * win[k];
      }
#pragma unroll
      for (int k = 0; k < K - 1; ++k) win[k] = win[k + 1];
      if (t + 1 < t1) win[K - 1] = xr[t + K];
    }
#pragma unroll
    for (int r = 0; r < kPer; ++r) {
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const size_t idx = static_cast<size_t>(g * kPer + r) * K * C + k * C + c;
        dw12[idx] = (first ? 0.f : dw12[idx]) + acc[r][k];
      }
    }
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = warp; o < O; o += blockDim.x / 32) {
    float s = 0.f;
    for (int t = lane; t < t1; t += 32) s += d[o * ld + t];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) db12[o] = (first ? 0.f : db12[o]) + s;
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
// (b), h3 (c); dh3 into c; dh2 into b; dh1 into c. With dw3z/dw4z set
// (B2w), also adds this (trial, window)'s dw4 and dw3 of the zone. g_z
// points at the zone's O cotangents. Ends synchronised, r1 free.
template <int O, int K>
__device__ void zone_backward(const BwdPlan& p, float* smem, const Operands& op,
                              const float* __restrict__ g_z, int z, int C, int t1,
                              float* __restrict__ dw3z, float* __restrict__ dw4z, bool first) {
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
  if (dw4z != nullptr) tail_weight_grad<O, K>(dw4z, first, hc, hb, p.lt, t1);
  __syncthreads();
  isd::same_conv<O, true>(hb, hc, p.lt, r1 + kw, K, t1, false);  // dh2 = conv4^T(dh3)
  __syncthreads();
  if (dw3z != nullptr) tail_weight_grad<O, K>(dw3z, first, hb, ha, p.lt, t1);
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

// B2w: block (z, p = n * S + s, m) covers trials [s*B/S, (s+1)*B/S) of
// window n and writes partial p of model m's zone-z gradients.
template <int O, int K>
__global__ void __launch_bounds__(kThreads)
conv4head_bwd_w_kernel(const float* __restrict__ g, const float* __restrict__ x,
                       const float* __restrict__ w12, const float* __restrict__ b12,
                       const float* __restrict__ w3, const float* __restrict__ w4,
                       float* __restrict__ pw12, float* __restrict__ pb12,
                       float* __restrict__ pw3, float* __restrict__ pw4, int B, int C, int T,
                       int Z, int N, int W, int step, int S) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int z = blockIdx.x, p = blockIdx.y, m = blockIdx.z;
  const int n = p / S, s = p - n * S, P = N * S;
  const int t1 = W - K + 1;
  const BwdPlan plan = bwd_plan(C, W, O, K);
  const Operands op = model_operands(w12, b12, w3, w4, m, Z, O, K, C);
  const size_t mp = static_cast<size_t>(m) * P + p;
  float* dw12z = pw12 + (mp * Z * O + static_cast<size_t>(z) * O) * K * C;
  float* db12z = pb12 + mp * Z * O + static_cast<size_t>(z) * O;
  float* dw3z = pw3 + (mp * Z + z) * O * K * O;
  float* dw4z = pw4 + (mp * Z + z) * O * K * O;

  const int b0 = s * B / S, b1 = (s + 1) * B / S;
  for (int b = b0; b < b1; ++b) {
    const size_t mb = static_cast<size_t>(m) * B + b;
    stage_window(smem + plan.xs, plan.lx, x + mb * C * T + static_cast<size_t>(n) * step, C, T, W);
    const bool first = b == b0;
    zone_backward<O, K>(plan, smem, op, g + (mb * N + n) * Z * O + z * O, z, C, t1, dw3z, dw4z,
                        first);
    first_weight_grad<O, K>(dw12z, db12z, first, smem + plan.c, plan.lt, smem + plan.xs,
                            plan.lx, C, t1);
    __syncthreads();
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
    zone_backward<O, K>(plan, smem, op, g + (mb * N + n) * Z * O + z * O, z, C, t1, nullptr,
                        nullptr, false);
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
  const size_t smem_bytes = sizeof(float) * bwd_plan(C, W, O, K).total;
  cudaError_t err = cudaFuncSetAttribute(conv4head_bwd_w_kernel<O, K>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const int P = N * S;
  conv4head_bwd_w_kernel<O, K><<<dim3(Z, P, M), kThreads, smem_bytes, st>>>(
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

// Dynamic shared memory of one B2w or B2x block, in bytes.
extern "C" int isd_conv4head_bwd_smem_bytes(int C, int W, int O, int K) {
  return static_cast<int>(sizeof(float)) * bwd_plan(C, W, O, K).total;
}

// B2w. g (M, B, N, Z*O), x (M, B, C, T), operands as the forward's;
// outputs dw12 (M, Z*O, K1*C), db12 (M, Z*O), dw3/dw4 (M, Z, O, K2*O);
// scratch pw12/pb12/pw3/pw4 the same with a partial axis P = N*S after M.
// All f32, contiguous, on the device. K1 must equal K2.
extern "C" int isd_conv4head_bwd_w(const float* g, const float* x, const float* w12,
                                   const float* b12, const float* w3, const float* w4,
                                   float* dw12, float* db12, float* dw3, float* dw4, float* pw12,
                                   float* pb12, float* pw3, float* pw4, int M, int B, int C,
                                   int T, int Z, int O, int K1, int K2, int W, int step, int N,
                                   int S, void* stream) {
  if (bad_geometry(M, B, C, T, Z, K1, K2, W, step, N) || S < 1 || S > B ||
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
