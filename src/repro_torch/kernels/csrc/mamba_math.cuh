// The selective scan's step math, shared by the forward (csrc/mamba_scan.cu:
// K7, K7t and the one-phase T = 1 path) and the backward's recompute
// (csrc/mamba_scan_bwd.cu: K7b), so that the states the backward recomputes
// are bit for bit the forward's.
//
// A channel's d_state (at most kMaxDs) f32 states live in registers: of
// one thread in the forward's general path, of four adjacent lanes (four
// states each) in its one-phase T = 1 path and in the backward; each state
// is updated by update().  Every rounding is spelled out (__fmul_rn,
// __fmaf_rn, __fadd_rn): the compiler may not contract a product into a
// different fused multiply-add in one kernel than in another.  The decay
// is expf, not __expf: expf is accurate to 2 ulp at any argument, __expf
// loses accuracy as |dt A| grows, and a decay near 1 multiplies its error
// into every later step.  An argument of -inf or below -104 gives 0, so a
// large dt A zeroes the decay and no 0 * inf appears.
//
// y_t = sum_s h_t[s] C_t[s] has one order of summation, whatever the lanes
// (quarter_y, then channel_y): each quarter of four states is summed from
// 0 by fused multiply-adds in state order, then the quarters pairwise,
// (q0 + q1) + (q2 + q3).  So y is bit-identical across the forward's
// paths, chunks, tiles and row tilings; it is not the plain version's
// order, and is held to it at MAMBA_TOL.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mamba {

constexpr int kMaxDs = 16;  // states a channel keeps in registers

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

// One state's update: a_t h + (dt x) B_t[s], rounded as every path rounds
// it (the product, then the fused multiply-add).
__device__ __forceinline__ float update(float a_t, float h, float dtx,
                                        float b) {
  return __fmaf_rn(a_t, h, __fmul_rn(dtx, b));
}

// One quarter's term of y: sum of h[s] c[s] over its four states, from 0,
// in state order.
__device__ __forceinline__ float quarter_y(const float* h, const float* c) {
  float y = 0.f;
#pragma unroll
  for (int u = 0; u < 4; ++u) y = __fmaf_rn(h[u], c[u], y);
  return y;
}

// y of a channel whose states lie over kLanes adjacent lanes, from this
// lane's quarter terms p (kMaxDs / kLanes / 4 of them, in state order):
// the lane's quarters pairwise, then xor shuffles over the channel's
// lanes.  An add is commutative in IEEE arithmetic, so every lane of the
// channel ends with the same bits, and every kLanes gives the tree
// (q0 + q1) + (q2 + q3).  Every lane of the warp must call it.
template <int kLanes>
__device__ __forceinline__ float channel_y(float (&p)[kMaxDs / kLanes / 4]) {
  constexpr int kQ = kMaxDs / kLanes / 4;
#pragma unroll
  for (int w = 1; w < kQ; w *= 2)
#pragma unroll
    for (int i = 0; i + w < kQ; i += 2 * w) p[i] = __fadd_rn(p[i], p[i + w]);
  float y = p[0];
#pragma unroll
  for (int o = 1; o < kLanes; o *= 2)
    y = __fadd_rn(y, __shfl_xor_sync(0xffffffffu, y, o));
  return y;
}

// A lane's kN states s0 .. s0 + kN - 1 of a row of ds floats (of A, a
// state) into registers, zero past ds or for a channel that is not live;
// 16-byte loads when vec (ds a multiple of 4 and the row 16-byte aligned).
template <int kN>
__device__ __forceinline__ void load_part(const float* row, int s0, int ds,
                                          bool live, int vec,
                                          float (&v)[kN]) {
  if (vec) {
#pragma unroll
    for (int p = 0; p < kN; p += 4) {
      float4 f = make_float4(0.f, 0.f, 0.f, 0.f);
      if (live && s0 + p < ds)
        f = *reinterpret_cast<const float4*>(row + s0 + p);
      v[p] = f.x;
      v[p + 1] = f.y;
      v[p + 2] = f.z;
      v[p + 3] = f.w;
    }
  } else {
#pragma unroll
    for (int p = 0; p < kN; ++p)
      v[p] = live && s0 + p < ds ? row[s0 + p] : 0.f;
  }
}

// The same part back to memory (nothing past ds or for a channel that is
// not live).
template <int kN>
__device__ __forceinline__ void store_part(float* row, int s0, int ds,
                                           bool live, int vec,
                                           const float (&v)[kN]) {
  if (!live) return;
  if (vec) {
#pragma unroll
    for (int p = 0; p < kN; p += 4)
      if (s0 + p < ds)
        *reinterpret_cast<float4*>(row + s0 + p) =
            make_float4(v[p], v[p + 1], v[p + 2], v[p + 3]);
  } else {
#pragma unroll
    for (int p = 0; p < kN; ++p)
      if (s0 + p < ds) row[s0 + p] = v[p];
  }
}

}  // namespace mamba
