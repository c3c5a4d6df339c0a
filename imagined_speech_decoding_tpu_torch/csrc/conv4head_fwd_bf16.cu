// Forward of the fused sliding-window Conv4Layers zone head in bf16, for
// Hopper (kernel B2f-bf16): the training path's default precision.
//
// Replaces the forward Pallas kernel of
// imagined_speech_decoding_tpu/ops/pallas/conv4head.py (_fwd_kernel, called
// by _fwd_impl) when x is bf16 (dt = xt.dtype there), and rounds where it
// rounds (_fwd_kernel :151-162): the window's patches are bf16, w12, w3 and
// w4 are rounded to bf16, and every product accumulates in f32:
//   h1 = bf16(acc(w12 . p) + b12)      (b12 added in f32 before the rounding)
//   h2 = bf16(acc(w3 . pad(h1)))
//   h3 = acc(w4 . pad(h2))             f32
//   out[m, b, n, z*O + o] = mean_t gelu(h3[o, t])   (exact erf GELU, f32)
// Operand layouts are conv4head.cu's: x (M, B, C, T) bf16; w12 (M, Z*O,
// K*C), b12 (M, Z*O), w3 / w4 (M, Z, O, K*O), all f32 (the parameters are
// f32, as conv4layers_prepare_fused_weights gives them); out f32.
//
// What bounds it on the H100: work. One (trial, window, zone) at full width
// is 5.04 M multiply-adds; a training step of 75 models at batch 64 is
// 0.97 T, 1.96 ms at the data sheet's 989 TFLOP/s dense bf16, one pass.
//
// The design (the pieces in conv4head_bf16.cuh): B2f's block structure, a
// block per (zone, window, trial range) of a model with 16 warps, the
// zone's weights resident, the next trial's window streaming in by
// cp.async behind the compute; each product one bf16 mma.sync m16n8k16
// pass (no hi/lo split: bf16 x bf16 is exact in f32), on time-major
// buffers (the header says why). h3 never leaves the registers: each lane
// sums gelu(h3) over its rows, and the per-warp column sums are added in
// warp order, so each output is written once by one block and reruns are
// bit-identical. 156 KB of shared memory at full width: one block per SM.
// O and K are template arguments, instantiated for O = 32, K = 5; C = 64
// with W = 250 (the shipped geometry) gets compile-time strides beside a
// generic instantiation. Any C (padded to 16); T must be even (the 4-byte
// cp.async of the window).

#include <cstdint>

#include <cuda_runtime.h>

#include "conv4head_bf16.cuh"

namespace {

using isd::kWarpsB;

template <int O, int K, int kC, int kW>
__global__ void __launch_bounds__(kWarpsB * 32, 1)
conv4head_fwd_bf16_kernel(const uint16_t* __restrict__ x, const float* __restrict__ w12,
                          const float* __restrict__ b12, const float* __restrict__ w3,
                          const float* __restrict__ w4, float* __restrict__ out, int B,
                          int C_arg, int T, int Z, int N, int W_arg, int step, int S) {
  static_assert(O == 32, "four 8-column tiles of O");
  const int C = kC > 0 ? kC : C_arg, W = kW > 0 ? kW : W_arg;
  extern __shared__ float4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int z = blockIdx.x, p = blockIdx.y, m = blockIdx.z;
  const int n = p / S, s = p - n * S;
  const int t1 = W - K + 1;
  const int warp = threadIdx.x >> 5;
  const isd::Bf16Plan plan = isd::bf16_plan(C, W, O, K, 2);
  const int ldx = plan.ldx, lda = plan.lda, tiles = plan.nt16 / 16;
  uint32_t* xs = smem + plan.xs;
  uint16_t* raw = reinterpret_cast<uint16_t*>(smem + plan.raw);
  uint32_t* ha = smem + plan.act[0];
  uint32_t* hb = smem + plan.act[1];
  uint32_t* w12s = smem + plan.w12;
  uint32_t* w3s = smem + plan.w3;
  uint32_t* w4s = smem + plan.w4;
  float* bias = reinterpret_cast<float*>(smem + plan.bias);
  float* red = reinterpret_cast<float*>(smem + plan.red);
  const size_t zo = (static_cast<size_t>(m) * Z + z) * O;  // the zone's first row in model m
  const int b0 = s * B / S, b1 = (s + 1) * B / S;
  // T is even, so every row's window starts at the parity of n * step.
  const int off = (n * step) & 1;
  const uint16_t* x0 = x + (static_cast<size_t>(m) * B + b0) * C * T + n * step - off;

  isd::stage_raw_async(raw, plan.rw, x0, C, T, W, off);
  isd::zero_words(xs, plan.raw - plan.xs);  // the window's pads stay zero
  isd::zero_words(ha, plan.w12 - plan.act[0]);  // so do the activations'
  isd::stage_weights_bf16(w12s, plan.lw1, w12 + zo * K * C, O, K, C, plan.cp);
  isd::stage_weights_bf16(w3s, plan.lw, w3 + zo * K * O, O, K, O, O);
  isd::stage_weights_bf16(w4s, plan.lw, w4 + zo * K * O, O, K, O, O);
  if (threadIdx.x < O) bias[threadIdx.x] = b12[zo + threadIdx.x];

  for (int b = b0; b < b1; ++b) {
    const size_t mb = static_cast<size_t>(m) * B + b;
    isd::cp_async_wait_all();
    __syncthreads();
    isd::raw_to_window(xs, ldx, raw, plan.rw, off, C, W);
    __syncthreads();
    if (b + 1 < b1) {  // the raw buffer is free: the next trial's window streams in
      isd::stage_raw_async(raw, plan.rw, x0 + (b + 1 - b0) * static_cast<size_t>(C) * T, C, T,
                           W, off);
    }
    isd::conv_bf16<K, false, kWarpsB>(  // h1
        xs, ldx, w12s, plan.lw1, plan.cp, tiles, warp,
        [&](int, int t, int o, float v0, float v1) {
          ha[(K / 2 + t) * lda + o / 2] = t < t1 ? isd::pack_bf16(v0 + bias[o], v1 + bias[o + 1])
                                                 : 0u;
        });
    __syncthreads();
    isd::conv_bf16<K, false, kWarpsB>(  // h2
        ha, lda, w3s, plan.lw, O, tiles, warp, [&](int, int t, int o, float v0, float v1) {
          hb[(K / 2 + t) * lda + o / 2] = t < t1 ? isd::pack_bf16(v0, v1) : 0u;
        });
    __syncthreads();
    float sums[4][2] = {};
    isd::conv_bf16<K, false, kWarpsB>(  // h3 -> sum_t gelu(h3), in registers
        hb, lda, w4s, plan.lw, O, tiles, warp, [&](int j, int t, int, float v0, float v1) {
          if (t < t1) {
            sums[j][0] += isd::gelu(v0);
            sums[j][1] += isd::gelu(v1);
          }
        });
    isd::warp_col_sums(red, sums);
    __syncthreads();
    if (threadIdx.x < O) {
      out[(mb * N + n) * Z * O + z * O + threadIdx.x] = isd::sum_warps(red, threadIdx.x) / t1;
    }
  }
}

template <int O, int K>
cudaError_t launch(const uint16_t* x, const float* w12, const float* b12, const float* w3,
                   const float* w4, float* out, int M, int B, int C, int T, int Z, int W,
                   int step, int N, int S, cudaStream_t st) {
  const size_t smem_bytes = sizeof(uint32_t) * isd::bf16_plan(C, W, O, K, 2).total;
  // The shipped model's geometry (64 channels, windows of 250) gets compile-time strides.
  const auto kernel = (C == 64 && W == 250) ? conv4head_fwd_bf16_kernel<O, K, 64, 250>
                                            : conv4head_fwd_bf16_kernel<O, K, 0, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  kernel<<<dim3(Z, N * S, M), kWarpsB * 32, smem_bytes, st>>>(x, w12, b12, w3, w4, out, B, C, T,
                                                              Z, N, W, step, S);
  return cudaGetLastError();
}

}  // namespace

// Dynamic shared memory of one B2f-bf16 block, in bytes.
extern "C" int isd_conv4head_bf16_smem_bytes(int C, int W, int O, int K) {
  return static_cast<int>(sizeof(uint32_t)) * isd::bf16_plan(C, W, O, K, 2).total;
}

// x (M, B, C, T) bf16 (T even, 4-byte aligned), w12 (M, Z*O, K1*C),
// b12 (M, Z*O), w3/w4 (M, Z, O, K2*O), out (M, B, N, Z*O) f32; contiguous,
// on the device. S trial ranges per (zone, window), 1 <= S <= B. K1 must
// equal K2. Returns a cudaError_t (0 on success).
extern "C" int isd_conv4head_fwd_bf16(const void* x, const float* w12, const float* b12,
                                      const float* w3, const float* w4, float* out, int M, int B,
                                      int C, int T, int Z, int O, int K1, int K2, int W, int step,
                                      int N, int S, void* stream) {
  if (M < 1 || B < 1 || C < 1 || Z < 1 || N < 1 || K1 < 1 || K2 < 1 || W < K1 || step < 1 ||
      (N - 1) * step + W > T || T % 2 != 0 || S < 1 || S > B || M > 65535 ||
      static_cast<long long>(N) * S > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O == 32 && K1 == 5 && K2 == 5) {
    return launch<32, 5>(static_cast<const uint16_t*>(x), w12, b12, w3, w4, out, M, B, C, T, Z,
                         W, step, N, S, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
