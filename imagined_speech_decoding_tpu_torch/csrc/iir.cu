// Biquad-cascade IIR filter over a time-major (T, R) array, for Hopper.
//
// Replaces the Pallas kernel imagined_speech_decoding_tpu/ops/pallas/iir.py
// (_make_kernel, called by sosfilt_time_major). Same contract: a causal
// cascade of S second-order sections in direct form II transposed, a0
// normalised to 1, per-row initial states zi (2S, R) in, final states
// zf (2S, R) out for chunked continuation.
//
// What bounds it on the H100: the recurrence is sequential in T, so each
// row is one dependent chain of ~5*S FMAs per sample. With one thread per
// row the card is latency-bound whenever R is small (at B = 1, R = 64: one
// block walking ~850 steps) and bandwidth-bound once R fills the SMs
// (each sample is read once and written once, 8 bytes).
//
// What the design does about it: one thread per row keeps the 2S section
// states in registers for the whole walk. Rows are contiguous in the
// time-major layout, so each time step's loads and stores coalesce across
// the warp. Coefficients travel by value in the kernel's parameter space
// (constant bank), so a launch needs no device allocation or copy. The
// section count is a template argument so the state array is fully
// unrolled into registers; it is instantiated only for the serving chain's
// filters: S = 1 (the notch) and S = 4 (the order-4 band-pass).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxSections = 4;
constexpr int kThreads = 128;

struct SosCoefficients {
  float c[kMaxSections][6];  // scipy layout b0 b1 b2 a0 a1 a2, a0 == 1
};

template <int S>
__global__ void __launch_bounds__(kThreads)
sosfilt_time_major_kernel(const float* __restrict__ x, const float* __restrict__ zi,
                          float* __restrict__ y, float* __restrict__ zf,
                          const SosCoefficients coef, int t_len, int rows) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= rows) return;
  float z[2 * S];
#pragma unroll
  for (int i = 0; i < 2 * S; ++i) z[i] = zi[static_cast<size_t>(i) * rows + r];

#pragma unroll 4
  for (int t = 0; t < t_len; ++t) {
    float out = x[static_cast<size_t>(t) * rows + r];
#pragma unroll
    for (int s = 0; s < S; ++s) {
      const float b0 = coef.c[s][0], b1 = coef.c[s][1], b2 = coef.c[s][2];
      const float a1 = coef.c[s][4], a2 = coef.c[s][5];
      const float v = b0 * out + z[2 * s];
      z[2 * s] = b1 * out - a1 * v + z[2 * s + 1];
      z[2 * s + 1] = b2 * out - a2 * v;
      out = v;
    }
    y[static_cast<size_t>(t) * rows + r] = out;
  }

#pragma unroll
  for (int i = 0; i < 2 * S; ++i) zf[static_cast<size_t>(i) * rows + r] = z[i];
}

template <int S>
cudaError_t launch(const float* x, const float* zi, float* y, float* zf,
                   const SosCoefficients& coef, int t_len, int rows, cudaStream_t stream) {
  const int blocks = (rows + kThreads - 1) / kThreads;
  sosfilt_time_major_kernel<S><<<blocks, kThreads, 0, stream>>>(x, zi, y, zf, coef, t_len, rows);
  return cudaGetLastError();
}

}  // namespace

// x, y: (t_len, rows) f32 on the device; zi, zf: (2 * n_sections, rows).
// sos_host: (n_sections, 6) f32 in host memory, already a0-normalised.
// Returns a cudaError_t (0 on success).
extern "C" int isd_sosfilt_time_major(const float* x, const float* zi, float* y, float* zf,
                                      const float* sos_host, int n_sections, int t_len,
                                      int rows, void* stream) {
  if ((n_sections != 1 && n_sections != 4) || t_len < 0 || rows < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  SosCoefficients coef = {};
  for (int s = 0; s < n_sections; ++s) {
    for (int j = 0; j < 6; ++j) coef.c[s][j] = sos_host[s * 6 + j];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err = n_sections == 1 ? launch<1>(x, zi, y, zf, coef, t_len, rows, st)
                                           : launch<4>(x, zi, y, zf, coef, t_len, rows, st);
  return static_cast<int>(err);
}

// Message for a code returned by any isd_* entry point of this library.
extern "C" const char* isd_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
