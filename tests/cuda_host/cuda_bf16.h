// A stand-in for the CUDA bf16 header (see cuda_runtime.h here): the
// storage type and the two conversions, rounding to nearest even as
// __float2bfloat16_rn does.

#pragma once

#include <stdint.h>
#include <string.h>

struct __nv_bfloat16 {
  uint16_t bits;
};

inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  uint32_t u;
  memcpy(&u, &f, 4);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {static_cast<uint16_t>((u >> 16) | 0x40u)};
  u += 0x7fffu + ((u >> 16) & 1u);
  return {static_cast<uint16_t>(u >> 16)};
}

inline float __bfloat162float(__nv_bfloat16 b) {
  const uint32_t u = static_cast<uint32_t>(b.bits) << 16;
  float f;
  memcpy(&f, &u, 4);
  return f;
}
