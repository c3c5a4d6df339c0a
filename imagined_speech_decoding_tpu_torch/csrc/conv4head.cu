// Forward of the fused sliding-window Conv4Layers zone head, for Hopper.
//
// Replaces the forward Pallas kernel of
// imagined_speech_decoding_tpu/ops/pallas/conv4head.py (_fwd_kernel, called
// by _fwd_impl). Per trial b, window n and zone z it computes
//
//   h1[o, t] = b12[z*O + o] + sum_{k, c} w12[z*O + o, k*C + c] * x[b, c, n*step + t + k]
//   h2 = 'same' K2-tap conv of h1 with w3[z]      (zero padding at the window edges)
//   h3 = 'same' K2-tap conv of h2 with w4[z]
//   out[b, n, z*O + o] = mean_t gelu(h3[o, t])    (exact erf GELU)
//
// for t in [0, t1), t1 = W - K1 + 1. The operand layouts are the ones that
// imagined_speech_decoding_tpu_torch.models.heads.Conv4LayersHead
// .prepare_fused_weights returns: w12 (Z*O, K1*C) and w3, w4 (Z, O, K2*O),
// all tap-major. x is batch-major (B, C, T); the Pallas kernel's
// channel-major input and its 246 -> 256 lane padding were Mosaic
// constraints and are gone.
//
// What bounds it on the H100: about 5 M FMAs per (trial, window, zone) at
// full width (C = 64, O = 32, K = 5, t1 = 246), so ~0.4 GFLOP per trial
// against ~200 KB of input; it is compute-bound. This first version does
// the products on the CUDA cores in f32, not on the tensor cores.
//
// What the design does about it: one block per (zone, window, trial).
// The block stages the window's C x W input slice and the zone's weights
// in shared memory once, so every FMA reads its operands from shared
// memory or registers, never from device memory. Each thread owns one
// time step t and keeps all O outputs of that step in registers; the
// weights are stored transposed (o innermost) so one 16-byte broadcast
// load feeds four FMAs. The three convs and the time-mean stay in shared
// memory, and only O floats per block go back to device memory. O is a
// template argument, instantiated only for the shipped model's O = 32.

#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__host__ __device__ inline int round_up4(int v) { return (v + 3) & ~3; }

// Shared-memory plan in floats; every region starts 16-byte aligned.
struct SmemPlan {
  int xs, ws, ha, hb, total;
};

__host__ __device__ inline SmemPlan smem_plan(int C, int W, int O, int K1, int K2) {
  const int t1 = W - K1 + 1;
  const int w_floats = (K1 * C > 2 * K2 * O ? K1 * C : 2 * K2 * O) * O;
  SmemPlan p;
  p.xs = 0;
  p.ws = p.xs + round_up4(C * W);
  p.ha = p.ws + round_up4(w_floats);
  p.hb = p.ha + round_up4(O * t1);
  p.total = p.hb + round_up4(O * t1);
  return p;
}

// Stage rows [row0, row0 + O) of a (rows, cols) matrix into dst as
// (cols, O): dst[q * O + o] = src[(row0 + o) * cols + q].
__device__ inline void stage_transposed(float* dst, const float* __restrict__ src, int row0,
                                        int O, int cols) {
  for (int i = threadIdx.x; i < O * cols; i += blockDim.x) {
    const int o = i / cols, q = i - o * cols;
    dst[q * O + o] = src[static_cast<size_t>(row0 + o) * cols + q];
  }
}

// acc[o] += sum_q w[q * O + o] * v  for one input value v (w transposed).
template <int O>
__device__ inline void axpy_row(float (&acc)[O], const float* w, float v) {
  const float4* w4 = reinterpret_cast<const float4*>(w);
#pragma unroll
  for (int j = 0; j < O / 4; ++j) {
    const float4 q = w4[j];
    acc[4 * j + 0] += q.x * v;
    acc[4 * j + 1] += q.y * v;
    acc[4 * j + 2] += q.z * v;
    acc[4 * j + 3] += q.w * v;
  }
}

// One 'same' K-tap conv over time: dst[o, t] = sum_{k, i} w[(k*O + i) * O + o] * src[i, t + k - K/2].
template <int O>
__device__ inline void same_conv(float* dst, const float* src, const float* w, int K, int t1,
                                 bool apply_gelu) {
  const int pad = K / 2;
  for (int t = threadIdx.x; t < t1; t += blockDim.x) {
    float acc[O];
#pragma unroll
    for (int o = 0; o < O; ++o) acc[o] = 0.f;
    for (int k = 0; k < K; ++k) {
      const int tt = t + k - pad;
      if (tt < 0 || tt >= t1) continue;
      for (int i = 0; i < O; ++i) axpy_row<O>(acc, w + (k * O + i) * O, src[i * t1 + tt]);
    }
#pragma unroll
    for (int o = 0; o < O; ++o) {
      float v = acc[o];
      if (apply_gelu) v = 0.5f * v * (1.f + erff(v * 0.70710678118654752f));
      dst[o * t1 + t] = v;
    }
  }
}

template <int O>
__global__ void __launch_bounds__(kThreads)
conv4head_fwd_kernel(const float* __restrict__ x, const float* __restrict__ w12,
                     const float* __restrict__ b12, const float* __restrict__ w3,
                     const float* __restrict__ w4, float* __restrict__ out, int C, int T, int Z,
                     int N, int W, int step, int K1, int K2) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const int z = blockIdx.x, n = blockIdx.y, b = blockIdx.z;
  const int t1 = W - K1 + 1;
  const SmemPlan plan = smem_plan(C, W, O, K1, K2);
  float* xs = smem + plan.xs;  // (C, W) window slice
  float* ws = smem + plan.ws;  // transposed weights of the current stage
  float* ha = smem + plan.ha;  // (O, t1): h1, later gelu(h3)
  float* hb = smem + plan.hb;  // (O, t1): h2

  // Stage the window and the zone's rows of w12.
  const float* xw = x + static_cast<size_t>(b) * C * T + static_cast<size_t>(n) * step;
  for (int i = threadIdx.x; i < C * W; i += blockDim.x) {
    const int c = i / W, j = i - c * W;
    xs[i] = xw[static_cast<size_t>(c) * T + j];
  }
  stage_transposed(ws, w12, z * O, O, K1 * C);
  __syncthreads();

  // h1 = fused temporal x zone-scattered spatial conv (valid) + bias.
  for (int t = threadIdx.x; t < t1; t += blockDim.x) {
    float acc[O];
#pragma unroll
    for (int o = 0; o < O; ++o) acc[o] = b12[z * O + o];
    for (int k = 0; k < K1; ++k) {
      for (int c = 0; c < C; ++c) axpy_row<O>(acc, ws + (k * C + c) * O, xs[c * W + t + k]);
    }
#pragma unroll
    for (int o = 0; o < O; ++o) ha[o * t1 + t] = acc[o];
  }
  __syncthreads();

  // The zone's two tail convs, staged together.
  float* ws3 = ws;
  float* ws4 = ws + K2 * O * O;
  stage_transposed(ws3, w3, z * O, O, K2 * O);
  stage_transposed(ws4, w4, z * O, O, K2 * O);
  __syncthreads();
  same_conv<O>(hb, ha, ws3, K2, t1, false);
  __syncthreads();
  same_conv<O>(ha, hb, ws4, K2, t1, true);
  __syncthreads();

  // Mean over t: one warp per output channel, lanes stride over t.
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int o = warp; o < O; o += blockDim.x / 32) {
    float s = 0.f;
    for (int t = lane; t < t1; t += 32) s += ha[o * t1 + t];
#pragma unroll
    for (int off = 16; off > 0; off /= 2) s += __shfl_down_sync(0xffffffffu, s, off);
    if (lane == 0) out[(static_cast<size_t>(b) * N + n) * Z * O + z * O + o] = s / t1;
  }
}

template <int O>
cudaError_t launch(const float* x, const float* w12, const float* b12, const float* w3,
                   const float* w4, float* out, int B, int C, int T, int Z, int K1, int K2,
                   int W, int step, int N, cudaStream_t stream) {
  const size_t smem_bytes = sizeof(float) * smem_plan(C, W, O, K1, K2).total;
  cudaError_t err = cudaFuncSetAttribute(conv4head_fwd_kernel<O>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const dim3 grid(Z, N, B);
  conv4head_fwd_kernel<O><<<grid, kThreads, smem_bytes, stream>>>(x, w12, b12, w3, w4, out, C,
                                                                  T, Z, N, W, step, K1, K2);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory one block needs, in bytes (the wrapper checks it
// against the card's per-block limit before launching).
extern "C" int isd_conv4head_smem_bytes(int C, int W, int O, int K1, int K2) {
  return static_cast<int>(sizeof(float)) * smem_plan(C, W, O, K1, K2).total;
}

// x (B, C, T), w12 (Z*O, K1*C), b12 (Z*O), w3/w4 (Z, O, K2*O), out (B, N, Z*O);
// all f32, contiguous, on the device. Returns a cudaError_t (0 on success).
extern "C" int isd_conv4head_fwd(const float* x, const float* w12, const float* b12,
                                 const float* w3, const float* w4, float* out, int B, int C,
                                 int T, int Z, int O, int K1, int K2, int W, int step, int N,
                                 void* stream) {
  if (B < 1 || C < 1 || Z < 1 || N < 1 || K1 < 1 || K2 < 1 || W < K1 || step < 1 ||
      (N - 1) * step + W > T) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (O) {
    case 32: return launch<32>(x, w12, b12, w3, w4, out, B, C, T, Z, K1, K2, W, step, N, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
