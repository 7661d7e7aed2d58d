// The selective scan's step math, shared by the forward (csrc/mamba_scan.cu:
// K7, K7t) and the backward's recompute (csrc/mamba_scan_bwd.cu: K7b), so
// that the states the backward recomputes are bit for bit the forward's.
//
// One thread owns one channel d of d_inner and keeps its d_state (at most
// kMaxDs) f32 states in registers.  Every rounding is spelled out
// (__fmul_rn, __fmaf_rn): the compiler may not contract a product into a
// different fused multiply-add in one kernel than in the other.  The decay
// is expf, not __expf: expf is accurate to 2 ulp at any argument, __expf
// loses accuracy as |dt A| grows, and a decay near 1 multiplies its error
// into every later step.  An argument of -inf or below -104 gives 0, so a
// large dt A zeroes the decay and no 0 * inf appears.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mamba {

constexpr int kMaxDs = 16;     // states a thread keeps in registers
constexpr int kMaxTile = 128;  // threads (channels) of the widest block

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// a_t = exp(dt_t A[d][s]), the scan's one exponential.
__device__ __forceinline__ float decay(float dt, float a) {
  return expf(__fmul_rn(dt, a));
}

// One step of one channel: h <- a_t * h + (dt x) B_t, returning
// y = sum_s h[s] C_t[s] (summed from s = 0).  b and c are the step's rows
// of B and C (d_state floats, in shared memory).
__device__ __forceinline__ float step(float (&h)[kMaxDs],
                                      const float (&a)[kMaxDs], float x,
                                      float dt, const float* b,
                                      const float* c, int ds) {
  const float dtx = __fmul_rn(dt, x);
  float y = 0.f;
#pragma unroll
  for (int s = 0; s < kMaxDs; ++s) {
    if (s < ds) {
      h[s] = __fmaf_rn(decay(dt, a[s]), h[s], __fmul_rn(dtx, b[s]));
      y = __fmaf_rn(h[s], c[s], y);
    }
  }
  return y;
}

// A channel's row of d_state floats (of A, a state, a gradient) into
// registers, zero past d_state; 16-byte loads where the row allows.
__device__ __forceinline__ void load_row(const float* p, float (&v)[kMaxDs],
                                         int ds) {
  if ((ds & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int s = 0; s < kMaxDs; s += 4) {
      const float4 q = s < ds ? *reinterpret_cast<const float4*>(p + s)
                              : make_float4(0.f, 0.f, 0.f, 0.f);
      v[s] = q.x;
      v[s + 1] = q.y;
      v[s + 2] = q.z;
      v[s + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int s = 0; s < kMaxDs; ++s) v[s] = s < ds ? p[s] : 0.f;
  }
}

// The same row back to memory: adjacent threads write adjacent rows, with
// 16-byte stores where the row allows.
__device__ __forceinline__ void store_row(float* p, const float (&v)[kMaxDs],
                                          int ds) {
  if ((ds & 3) == 0 && (reinterpret_cast<uintptr_t>(p) & 15) == 0) {
#pragma unroll
    for (int s = 0; s < kMaxDs; s += 4)
      if (s < ds)
        *reinterpret_cast<float4*>(p + s) =
            make_float4(v[s], v[s + 1], v[s + 2], v[s + 3]);
  } else {
#pragma unroll
    for (int s = 0; s < kMaxDs; ++s)
      if (s < ds) p[s] = v[s];
  }
}

__device__ __forceinline__ void zero_row(float (&v)[kMaxDs]) {
#pragma unroll
  for (int s = 0; s < kMaxDs; ++s) v[s] = 0.f;
}

}  // namespace mamba
