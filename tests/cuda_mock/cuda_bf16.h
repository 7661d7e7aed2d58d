// bf16 for the g++ mock of the CUDA runtime: round to nearest even.
#pragma once
#include "cuda_runtime.h"

struct __nv_bfloat16 {
  uint16_t bits;
};
inline float __bfloat162float(__nv_bfloat16 h) {
  return __uint_as_float((unsigned)h.bits << 16);
}
inline __nv_bfloat16 __float2bfloat16_rn(float f) {
  unsigned u = __float_as_uint(f);
  if ((u & 0x7fffffffu) > 0x7f800000u) return {(uint16_t)((u >> 16) | 64)};
  u += 0x7fffu + ((u >> 16) & 1);
  return {(uint16_t)(u >> 16)};
}
