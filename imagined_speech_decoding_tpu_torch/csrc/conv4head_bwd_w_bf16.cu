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
//
// The design: B2w's (a block per (model, zone, window, trial range), 16
// warps, the zone's weights resident, partials per block, no atomics, the
// next trial's window streamed in by cp.async), on the bf16 pieces of
// conv4head_bf16.cuh: time-major buffers, the convs and conv^T's as
// D[t, o] GEMMs, the weight gradients as GEMMs over time through
// ldmatrix.trans. Three activation buffers: h1 | h2, then dh2 | dh3, then
// dh1 (bf16; its f32 row sums for db12 are taken in the epilogue, in
// registers, and added in warp order). 177 KB of shared memory at full
// width: one block per SM. Any C (padded to 16 with zero channels, whose
// gradient columns are not stored): B2w's f32 instantiation needs C % 8 ==
// 0 for its reduction steps of 8 over (tap, channel); here every step of
// 16 stays in one tap because the staged channels are padded. T even.

#include <cstdint>

#include <cuda_runtime.h>

#include "conv4head_bf16.cuh"
#include "sum_partials.cuh"

namespace {

using isd::kWarpsB;

// 8-column tiles per warp in the weight gradients at full width: dw12 has
// K*Cp/8 = 40 column tiles over 8 warp groups, dw3 / dw4 20.
constexpr int kNtDw12 = 5;
constexpr int kNtDw = 3;

template <int O, int K, int kC, int kW>
__global__ void __launch_bounds__(kWarpsB * 32, 1)
conv4head_bwd_w_bf16_kernel(const float* __restrict__ g, const uint16_t* __restrict__ x,
                            const float* __restrict__ w12, const float* __restrict__ b12,
                            const float* __restrict__ w3, const float* __restrict__ w4,
                            float* __restrict__ pw12, float* __restrict__ pb12,
                            float* __restrict__ pw3, float* __restrict__ pw4, int B, int C_arg,
                            int T, int Z, int N, int W_arg, int step, int S) {
  static_assert(O == 32, "two 16-row tiles and four 8-column tiles of O");
  const int C = kC > 0 ? kC : C_arg, W = kW > 0 ? kW : W_arg;
  extern __shared__ float4 smem4[];
  uint32_t* smem = reinterpret_cast<uint32_t*>(smem4);
  const int z = blockIdx.x, p = blockIdx.y, m = blockIdx.z;
  const int n = p / S, s = p - n * S, P = N * S;
  const int t1 = W - K + 1;
  const int warp = threadIdx.x >> 5;
  const isd::Bf16Plan plan = isd::bf16_plan(C, W, O, K, 3);
  const int ldx = plan.ldx, lda = plan.lda, lw = plan.lw, cp = plan.cp;
  const int tiles = plan.nt16 / 16;
  uint32_t* xs = smem + plan.xs;
  uint16_t* raw = reinterpret_cast<uint16_t*>(smem + plan.raw);
  uint32_t* ha = smem + plan.act[0];  // h1
  uint32_t* hb = smem + plan.act[1];  // h2, then dh2
  uint32_t* hc = smem + plan.act[2];  // dh3, then dh1
  uint32_t* w12s = smem + plan.w12;
  uint32_t* w3s = smem + plan.w3;
  uint32_t* w4s = smem + plan.w4;
  float* bias = reinterpret_cast<float*>(smem + plan.bias);
  float* gz = reinterpret_cast<float*>(smem + plan.gz);
  float* red = reinterpret_cast<float*>(smem + plan.red);
  const size_t zo = (static_cast<size_t>(m) * Z + z) * O;
  const size_t mp = static_cast<size_t>(m) * P + p;
  float* dw12z = pw12 + (mp * Z * O + static_cast<size_t>(z) * O) * K * C;
  float* db12z = pb12 + mp * Z * O + static_cast<size_t>(z) * O;
  float* dw3z = pw3 + (mp * Z + z) * O * K * O;
  float* dw4z = pw4 + (mp * Z + z) * O * K * O;
  const int b0 = s * B / S, b1 = (s + 1) * B / S;
  const int off = (n * step) & 1;  // T is even: every row's window starts at this parity
  const uint16_t* x0 = x + (static_cast<size_t>(m) * B + b0) * C * T + n * step - off;

  isd::stage_raw_async(raw, plan.rw, x0, C, T, W, off);
  isd::zero_words(xs, plan.raw - plan.xs);
  isd::zero_words(ha, plan.w12 - plan.act[0]);
  isd::stage_weights_bf16(w12s, plan.lw1, w12 + zo * K * C, O, K, C, cp);
  isd::stage_weights_bf16(w3s, lw, w3 + zo * K * O, O, K, O, O);
  isd::stage_weights_bf16(w4s, lw, w4 + zo * K * O, O, K, O, O);
  if (threadIdx.x < O) bias[threadIdx.x] = b12[zo + threadIdx.x];

  const auto store = [&](uint32_t* dst) {  // a bf16 activation, zero from t1 on
    return [=](int, int t, int o, float v0, float v1) {
      dst[(K / 2 + t) * lda + o / 2] = t < t1 ? isd::pack_bf16(v0, v1) : 0u;
    };
  };
  for (int b = b0; b < b1; ++b) {
    const size_t mb = static_cast<size_t>(m) * B + b;
    const bool first = b == b0;
    isd::cp_async_wait_all();
    __syncthreads();
    isd::raw_to_window(xs, ldx, raw, plan.rw, off, C, W);
    if (threadIdx.x < O) gz[threadIdx.x] = g[(mb * N + n) * Z * O + z * O + threadIdx.x] / t1;
    __syncthreads();
    if (b + 1 < b1) {
      isd::stage_raw_async(raw, plan.rw, x0 + (b + 1 - b0) * static_cast<size_t>(C) * T, C, T,
                           W, off);
    }
    isd::conv_bf16<K, false, kWarpsB>(  // h1
        xs, ldx, w12s, plan.lw1, cp, tiles, warp, [&](int, int t, int o, float v0, float v1) {
          ha[(K / 2 + t) * lda + o / 2] = t < t1 ? isd::pack_bf16(v0 + bias[o], v1 + bias[o + 1])
                                                 : 0u;
        });
    __syncthreads();
    isd::conv_bf16<K, false, kWarpsB>(ha, lda, w3s, lw, O, tiles, warp, store(hb));  // h2
    __syncthreads();
    isd::conv_bf16<K, false, kWarpsB>(  // h3 -> dh3c
        hb, lda, w4s, lw, O, tiles, warp, [&](int, int t, int o, float v0, float v1) {
          hc[(K / 2 + t) * lda + o / 2] =
              t < t1 ? isd::pack_bf16(gz[o] * isd::gelu_grad(v0), gz[o + 1] * isd::gelu_grad(v1))
                     : 0u;
        });
    __syncthreads();
    isd::weight_grad_bf16<K, kNtDw, kWarpsB>(dw4z, K * O, O, first, hc, lda, hb, lda, O, tiles,
                                             warp);
    __syncthreads();
    isd::conv_bf16<K, true, kWarpsB>(hc, lda, w4s, lw, O, tiles, warp, store(hb));  // dh2c
    __syncthreads();
    isd::weight_grad_bf16<K, kNtDw, kWarpsB>(dw3z, K * O, O, first, hb, lda, ha, lda, O, tiles,
                                             warp);
    float sums[4][2] = {};
    isd::conv_bf16<K, true, kWarpsB>(  // dh1: bf16 for dw12, its f32 row sums for db12
        hb, lda, w3s, lw, O, tiles, warp, [&](int j, int t, int o, float v0, float v1) {
          const bool real = t < t1;
          hc[(K / 2 + t) * lda + o / 2] = real ? isd::pack_bf16(v0, v1) : 0u;
          if (real) {
            sums[j][0] += v0;
            sums[j][1] += v1;
          }
        });
    isd::warp_col_sums(red, sums);
    __syncthreads();
    isd::weight_grad_bf16<K, kNtDw12, kWarpsB>(dw12z, K * C, C, first, hc, lda, xs, ldx, cp,
                                               tiles, warp);
    if (threadIdx.x < O) {
      db12z[threadIdx.x] = (first ? 0.f : db12z[threadIdx.x]) + isd::sum_warps(red, threadIdx.x);
    }
  }
}

template <int O, int K>
cudaError_t launch_w(const float* g, const uint16_t* x, const float* w12, const float* b12,
                     const float* w3, const float* w4, float* dw12, float* db12, float* dw3,
                     float* dw4, float* pw12, float* pb12, float* pw3, float* pw4, int M, int B,
                     int C, int T, int Z, int W, int step, int N, int S, cudaStream_t st) {
  const size_t smem_bytes = sizeof(uint32_t) * isd::bf16_plan(C, W, O, K, 3).total;
  // The shipped model's geometry (64 channels, windows of 250) gets compile-time strides.
  const auto kernel = (C == 64 && W == 250) ? conv4head_bwd_w_bf16_kernel<O, K, 64, 250>
                                            : conv4head_bwd_w_bf16_kernel<O, K, 0, 0>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem_bytes));
  if (err != cudaSuccess) return err;
  const int P = N * S;
  kernel<<<dim3(Z, P, M), kWarpsB * 32, smem_bytes, st>>>(
      g, x, w12, b12, w3, w4, pw12, pb12, pw3, pw4, B, C, T, Z, N, W, step, S);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if ((err = isd::sum_partials(pw12, dw12, M, P, Z * O * K * C, st)) != cudaSuccess) return err;
  if ((err = isd::sum_partials(pb12, db12, M, P, Z * O, st)) != cudaSuccess) return err;
  if ((err = isd::sum_partials(pw3, dw3, M, P, Z * O * K * O, st)) != cudaSuccess) return err;
  return isd::sum_partials(pw4, dw4, M, P, Z * O * K * O, st);
}

}  // namespace

// Dynamic shared memory of one B2w-bf16 block, in bytes.
extern "C" int isd_conv4head_bwd_w_bf16_smem_bytes(int C, int W, int O, int K) {
  return static_cast<int>(sizeof(uint32_t)) * isd::bf16_plan(C, W, O, K, 3).total;
}

// B2w-bf16. Arguments as isd_conv4head_bwd_w's, with x (M, B, C, T) bf16
// (T even, 4-byte aligned); any C.
extern "C" int isd_conv4head_bwd_w_bf16(const float* g, const void* x, const float* w12,
                                        const float* b12, const float* w3, const float* w4,
                                        float* dw12, float* db12, float* dw3, float* dw4,
                                        float* pw12, float* pb12, float* pw3, float* pw4, int M,
                                        int B, int C, int T, int Z, int O, int K1, int K2, int W,
                                        int step, int N, int S, void* stream) {
  if (M < 1 || B < 1 || C < 1 || Z < 1 || N < 1 || K1 < 1 || K2 < 1 || W < K1 || step < 1 ||
      (N - 1) * step + W > T || T % 2 != 0 || M > 65535 || S < 1 || S > B ||
      static_cast<long long>(N) * S > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (O == 32 && K1 == 5 && K2 == 5) {
    return launch_w<32, 5>(g, static_cast<const uint16_t*>(x), w12, b12, w3, w4, dw12, db12, dw3,
                           dw4, pw12, pb12, pw3, pw4, M, B, C, T, Z, W, step, N, S, st);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
