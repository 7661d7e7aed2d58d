// The gate pass of one stacked-LSTM layer-step, shared by the forward
// (lstm_seq.cu) and the backward's gate recompute (lstm_seq_bwd.cu).
//
// The backward recomputes the forward's gate activations from the stored
// f32 trajectories.  Both kernels include this one function, so the
// recompute runs the same multiply-adds in the same order, combines the
// lanes' partial sums by the same shuffles and applies the same sigmoid and
// tanh: its activations are the forward's to the bit.

#pragma once

#include <cuda_runtime.h>

namespace lstm_gates {

constexpr int kPad = 8;  // words of padding per W row in shared memory

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Lane (j, p) of `parts` lanes sharing gate column j: sums reduction rows
// p, p + parts, ... of inp @ W[:P] (the first in_w of them) and h @ W[P:]
// for each of the tile's ROWS rows, combines the lanes by xor shuffle in a
// fixed order, adds the bias and writes the activated gate to g_s (ROWS,
// 4H).  inp is (ROWS, in_w), h (ROWS, H); wl and wh point at column j of
// the layer's input and recurrent rows, row stride S.  Every lane of the
// warp calls this (the shuffles need all 32); only active lanes write.
template <int ROWS>
__device__ __forceinline__ void gate_pass(const float* inp, int in_w,
                                          const float* h, int H,
                                          const float* wl, const float* wh,
                                          int S, const float* bias, int j,
                                          int p, int parts, bool active,
                                          bool is_tanh, float* g_s) {
  const int G = 4 * H;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  for (int q = p; q < in_w; q += parts) {
    const float wv = wl[(size_t)q * S];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(inp[r * in_w + q], wv, acc[r]);
  }
  for (int q = p; q < H; q += parts) {
    const float wv = wh[(size_t)q * S];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(h[r * H + q], wv, acc[r]);
  }
  for (int off = 1; off < parts; off <<= 1) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
  }
  if (active) {
    const float bj = bias[j];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = acc[r] + bj;
      const float a = is_tanh ? tanhf(v) : sigmoid(v);
      if (p == 0) g_s[r * G + j] = a;
    }
  }
}

}  // namespace lstm_gates
