// The gate pass of one stacked-LSTM layer-step, shared by the forward
// (lstm_seq.cu) and the backward's gate recompute (lstm_seq_bwd.cu), and
// the weight-stack layout both kernels hold in shared memory.
//
// The backward recomputes the forward's gate activations from the stored
// f32 trajectories.  Both kernels include this one function, so the
// recompute runs the same multiply-adds in the same order, combines the
// lanes' partial sums by the same shuffles, folds the same scale and
// applies the same sigmoid and tanh: its activations are the forward's to
// the bit, for f32 weights and for int8 weights alike.
//
// Weight types.  WT = float: the f32 stack.  WT = int8_t: the int8 plan
// (fused_seq_q8), codes in [-127, 127] with one f32 scale per (layer, gate
// column).  Each code converts to f32 in a register (exactly), the f32
// multiply-add chain is the f32 instance's, and the column's scale is
// folded in once, after the lanes' shuffle reduction and before the bias:
// v = acc * s[j] + b[j], which is the JAX package's _step_layers
// ((x @ wq + h @ wq) * s + b).  No f32 copy of the stack is ever built.
//
// Row strides in shared memory (in elements of WT; both kernels and the
// host's working_set_bytes use these numbers):
//  * f32: 4H + kPad words.  Lane (j, p) of a warp (8 columns x 4 parts)
//    reads word q*S + j with q = p + 4k, and the pad puts the 4 rows a
//    warp reads at once 8 banks apart, so the 32 lanes hit 32 banks.
//  * int8: 4H rounded up to 16 bytes, plus 16 more when that is a multiple
//    of 64.  Row starts stay 16-byte aligned, so the stack is copied in
//    16-byte cp.async pieces (cp.async moves 4, 8 or 16 bytes, never 1).
//    With 1-byte weights 4 adjacent columns share one 32-bit word and lanes
//    reading one word are served by a broadcast: a warp's 8 columns x 4
//    parts read 2 words in each of 4 rows (16 columns x 2 parts: 4 words
//    in 2 rows; 32 x 1: 8 words in 1 row).  The rows lie S/4 words apart,
//    so their words fall into distinct banks whenever S/4 mod 32 is not 0
//    or 16, i.e. S mod 128 bytes is not 0 or 64 -- which the extra 16
//    bytes rule out.  (The f32 rule of 8 words of pad would give int8 rows
//    8 bytes apart from alignment.)

#pragma once

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace lstm_gates {

constexpr int kPad = 8;  // words of padding per f32 W row in shared memory

// Elements of WT per weight row in shared memory, for G = 4H gate columns.
template <typename WT>
__host__ __device__ constexpr int row_stride(int G) {
  if (sizeof(WT) == 1) {
    const int s = (G + 15) / 16 * 16;
    return s % 64 == 0 ? s + 16 : s;
  }
  return G + kPad;
}

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Start copying the (n_rows, G) stack w into shared rows of S elements
// (16-byte pieces when the rows allow, else 4-byte ones; a row of 4H int8
// codes is a multiple of 4 bytes).  The caller commits and waits.
template <typename WT>
__device__ __forceinline__ void load_stack(WT* w_s, const WT* w, int n_rows,
                                           int G, int S, int tid, int nt) {
  const char* src = reinterpret_cast<const char*>(w);
  char* dst = reinterpret_cast<char*>(w_s);
  const int rb = G * (int)sizeof(WT);  // bytes per row in device memory
  const int sb = S * (int)sizeof(WT);  // bytes per row in shared memory
  if (reinterpret_cast<uintptr_t>(w) % 16 == 0 && rb % 16 == 0) {
    const int per_row = rb / 16;
    for (int i = tid; i < n_rows * per_row; i += nt) {
      const int row = i / per_row;
      const int col = (i - row * per_row) * 16;
      __pipeline_memcpy_async(dst + (size_t)row * sb + col,
                              src + (size_t)row * rb + col, 16);
    }
  } else {
    const int per_row = rb / 4;
    for (int i = tid; i < n_rows * per_row; i += nt) {
      const int row = i / per_row;
      const int col = (i - row * per_row) * 4;
      __pipeline_memcpy_async(dst + (size_t)row * sb + col,
                              src + (size_t)row * rb + col, 4);
    }
  }
}

// Lane (j, p) of `parts` lanes sharing gate column j: sums reduction rows
// p, p + parts, ... of inp @ W[:P] (the first in_w of them) and h @ W[P:]
// for each of the tile's ROWS rows, combines the lanes by xor shuffle in a
// fixed order, folds the column's scale (int8 weights only), adds the bias
// and writes the activated gate to g_s (ROWS, 4H).  inp is (ROWS, in_w),
// h (ROWS, H); wl and wh point at column j of the layer's input and
// recurrent rows, row stride S; scale is the layer's (4H) f32 scales (unused
// for f32 weights).  Every lane of the warp calls this (the shuffles need
// all 32); only active lanes write.
template <int ROWS, typename WT>
__device__ __forceinline__ void gate_pass(const float* inp, int in_w,
                                          const float* h, int H,
                                          const WT* wl, const WT* wh, int S,
                                          const float* bias,
                                          const float* scale, int j, int p,
                                          int parts, bool active,
                                          bool is_tanh, float* g_s) {
  const int G = 4 * H;
  float acc[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
  for (int q = p; q < in_w; q += parts) {
    const float wv = static_cast<float>(wl[(size_t)q * S]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[r] = fmaf(inp[r * in_w + q], wv, acc[r]);
  }
  for (int q = p; q < H; q += parts) {
    const float wv = static_cast<float>(wh[(size_t)q * S]);
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
    const float sj = sizeof(WT) == 1 ? scale[j] : 1.0f;
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float v = sizeof(WT) == 1 ? fmaf(acc[r], sj, bj) : acc[r] + bj;
      const float a = is_tanh ? tanhf(v) : sigmoid(v);
      if (p == 0) g_s[r * G + j] = a;
    }
  }
}

}  // namespace lstm_gates
