// The gate arithmetic of one stacked-LSTM layer-step, shared by the forward
// (lstm_seq.cu) and the backward's gate recompute (lstm_seq_bwd.cu), and
// the weight-stack layout both kernels can hold in shared memory.
//
// The backward recomputes the forward's gate activations from the stored
// f32 trajectories.  Both kernels build each gate pre-activation with the
// functions below, so the recompute runs the same multiply-adds in the same
// order, combines the same partial sums in the same order, folds the same
// scale and applies the same sigmoid and tanh: its activations are the
// forward's to the bit, for f32 and int8 weights alike, whatever the two
// kernels' thread layouts.
//
// The canonical order of one gate column j (gate order i, f, g, o):
//  * a segment is one product, v (n) @ W[rows] (n): the input segment (x,
//    n = P rows, at layer 0; the layer below's h, n = H rows, above it) and
//    the recurrent segment (the layer's own h_{t-1}, n = H rows);
//  * a segment is four partial sums: accumulator k (0..3) sums the rows
//    q = k, k + 4, k + 8, ... < n in ascending order, fmaf(v[q], w[q], acc)
//    from 0 (partial_sums); the four are combined as (a0 + a1) + (a2 + a3)
//    (combine);
//  * pre = in + rec; f32: v = pre + b[j]; int8: v = fmaf(pre, s[j], b[j]),
//    the column's scale folded once after the products and before the bias
//    ((x @ wq + h @ wq) * s + b, the JAX package's _step_layers); then
//    sigmoid, or for the g gate tanh as 2 sigmoid(2v) - 1 (preact,
//    activate).
// The order does not depend on how many lanes share a column: lane p of
// `parts` (1, 2 or 4) lanes keeps accumulators k = p, p + parts, ..., and
// combine takes the lane bits first by xor shuffle and then its own
// accumulators, which gives (a0 + a1) + (a2 + a3) in every lane (float
// addition is commutative, so both partners of a shuffle get the same
// bits).  The forward (one lane a column) and the backward (gate_parts(H)
// lanes a column) therefore produce the same bits.  Every step's arithmetic
// is also the same at every time chunk, batch tile and weight home, so
// those never change a result either.
//
// Weight types.  WT = float: the f32 stack.  WT = int8_t: the int8 plan
// (fused_seq_q8), codes in [-127, 127] with one f32 scale per (layer, gate
// column).  Each code converts to f32 exactly, so the multiply-add chains
// are the f32 instance's; no f32 copy of the stack is kept in shared memory.
//
// Row strides in shared memory (in elements of WT; the kernels and the
// host's working_set_bytes use these numbers):
//  * f32: 4H + kPad words.  In the backward, lane (j, p) of a warp (8
//    columns x 4 parts) reads word q*S + j with q = p + 4k, and the pad puts
//    the 4 rows a warp reads at once 8 banks apart, so the 32 lanes hit 32
//    banks.  The forward's shared home groups four rows of a column
//    together (lstm_seq.cu), so its warps read 32 adjacent groups.
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

// The partial sums of one segment of n reduction rows for the ROWS rows of
// a tile: this lane's accumulators k = p + m * PARTS (m < 4 / PARTS) in
// acc[m], each summing rows q = k, k + 4, ... < n in ascending order as
// fmaf(v(r, q), w(q), acc) from 0.  v(r, q) is the segment's input of tile
// row r, w(q) the column's f32 weight of reduction row q.
template <int ROWS, int PARTS, class V, class W>
__device__ __forceinline__ void partial_sums(float (&acc)[4 / PARTS][ROWS],
                                             int p, int n, V v, W w) {
#pragma unroll
  for (int m = 0; m < 4 / PARTS; ++m)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[m][r] = 0.0f;
#pragma unroll
  for (int q0 = 0; q0 < n; q0 += 4) {
#pragma unroll
    for (int m = 0; m < 4 / PARTS; ++m) {
      const int q = q0 + p + m * PARTS;
      if (q < n) {
        const float wq = w(q);
#pragma unroll
        for (int r = 0; r < ROWS; ++r)
          acc[m][r] = fmaf(v(r, q), wq, acc[m][r]);
      }
    }
  }
}

// partial_sums<ROWS, 1> for a lane that loads its inputs four rows at a
// time: v4(r, g) gives rows 4g .. 4g + 3 of tile row r's segment input and
// w4(g) those rows' weights, as float4 (past n they are never used).
// Accumulator m takes rows 4g + m in ascending g, as in partial_sums, so
// the bits are partial_sums'.
template <int ROWS, class V4, class W4>
__device__ __forceinline__ void partial_sums4(float (&acc)[4][ROWS], int n,
                                              V4 v4, W4 w4) {
#pragma unroll
  for (int m = 0; m < 4; ++m)
#pragma unroll
    for (int r = 0; r < ROWS; ++r) acc[m][r] = 0.0f;
  for (int q0 = 0; q0 < n; q0 += 4) {
    const float4 w = w4(q0 / 4);
    const float wm[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
      const float4 x = v4(r, q0 / 4);
      const float xm[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
      for (int m = 0; m < 4; ++m)
        if (q0 + m < n) acc[m][r] = fmaf(xm[m], wm[m], acc[m][r]);
    }
  }
}

// (a0 + a1) + (a2 + a3) over the PARTS lanes of a column (adjacent lanes,
// p = lane % PARTS): the lane bits by xor shuffle first, then this lane's
// own accumulators.  Every lane of the warp calls it (the shuffles need
// all 32); every lane of a column gets the same bits.
template <int ROWS, int PARTS>
__device__ __forceinline__ void combine(float (&out)[ROWS],
                                        const float (&acc)[4 / PARTS][ROWS]) {
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if constexpr (PARTS == 4) {
      float a = acc[0][r];
      a += __shfl_xor_sync(0xffffffffu, a, 1);
      out[r] = a + __shfl_xor_sync(0xffffffffu, a, 2);
    } else if constexpr (PARTS == 2) {
      const float a = acc[0][r] + __shfl_xor_sync(0xffffffffu, acc[0][r], 1);
      const float b = acc[1][r] + __shfl_xor_sync(0xffffffffu, acc[1][r], 1);
      out[r] = a + b;
    } else {
      static_assert(PARTS == 1, "1, 2 or 4 lanes a column");
      out[r] = (acc[0][r] + acc[1][r]) + (acc[2][r] + acc[3][r]);
    }
  }
}

// One segment's canonical sum: partial_sums, then combine.
template <int ROWS, int PARTS, class V, class W>
__device__ __forceinline__ void segment_sum(float (&out)[ROWS], int p, int n,
                                            V v, W w) {
  float acc[4 / PARTS][ROWS];
  partial_sums<ROWS, PARTS>(acc, p, n, v, w);
  combine<ROWS, PARTS>(out, acc);
}

// The gate pre-activation from the two segments' sums: the bias added (f32)
// or the scale folded before it (int8).
template <typename WT>
__device__ __forceinline__ float preact(float in, float rec, float b,
                                        float s) {
  const float v = in + rec;
  return sizeof(WT) == 1 ? fmaf(v, s, b) : v + b;
}

// tanh(v) = 2 sigmoid(2v) - 1: the same expf and division as a sigmoid, so
// the four gate lanes of a unit run one instruction stream (a divergent
// tanhf beside the sigmoids serializes the two).  Within ~1e-7 of tanhf.
__device__ __forceinline__ float tanh_sig(float v) {
  return fmaf(2.0f, sigmoid(2.0f * v), -1.0f);
}

__device__ __forceinline__ float activate(float v, bool is_tanh) {
  const float s = sigmoid(is_tanh ? 2.0f * v : v);
  return is_tanh ? fmaf(2.0f, s, -1.0f) : s;
}

}  // namespace lstm_gates
