// Fused LSTM cell, f32 or bf16, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/lstm_cell.py:_kernel
// (launched by _lstm_cell_call): one cell step [x, h] @ W + b with the
// sigmoid/tanh gate math fused behind the product, writing (c', h').
//
// What bounds it on the H100: at the paper's cell (B=1, D=32, H=32) one
// call reads about 34 KB (W is (D+H) x 4H f32) and does about 16 KFLOP, so
// bytes bound it at roughly 0.01 us — far below one kernel launch.  What a
// call costs is its chain of dependent latencies: the launch, one round
// trip to memory, a barrier, the gates.  The fused_cell plan makes T x L
// such launches per window.
//
// Design: the K = D + H reduction of the four gates is split over the
// threads of a block instead of walked by one thread per output.
// - A block owns a tile of bm rows x bh hidden columns (all four gates of
//   them) and has ks x bh threads.  Thread (slice s, gate g, quad cq)
//   accumulates columns g*H + j0 + 4cq .. +3 of its bm rows over the K
//   rows s*kUnroll .. +kUnroll-1 of each ks*kUnroll-row slice of K (K is
//   streamed in such slices, so no K is refused).
// - Each slice issues all its loads before its FMAs: kUnroll 16-byte loads
//   of W (neighbouring threads on neighbouring words of a row) and the
//   kUnroll x bm values of [x, h], read through their two pointers (the
//   concatenation is never built), as they are stored: a bf16 value is
//   widened only where the FMAs use it, so no load waits for another (a
//   widening next to its load holds the thread for the load's round
//   trip, and measured 1.5x slower).  4 x bm independent accumulators.
// - The slices' partials meet in shared memory; after ONE barrier thread
//   (r, jj) sums its column's ks partials of each gate in slice order (a
//   fixed order: two runs agree bit for bit), adds the bias, applies the
//   gates in f32 and writes c' and h'.  Bias and c are loaded before the
//   barrier, with W.
// - The tile is small enough that a cell at B=1 spreads over several SMs
//   (kernels/lstm_cell.py:choose_blocks picks it; this side refuses any
//   launch the table did not price).  No integer division runs in a loop.
// - bf16 (T = __nv_bfloat16): w, b, x, c and h are bf16 and widened to f32
//   as they are loaded (4 columns of W are one 8-byte load); the products,
//   the partials, the bias and the gates are f32, as in the JAX kernel, and
//   only (c', h') are rounded to bf16.  The same order as the f32
//   instance, so a bf16 cell is the f32 cell of the widened operands,
//   rounded.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "lstm_gates.cuh"

namespace {

using lstm_gates::to_io;

// A value as stored, loaded with nothing on the load's path (an f32, or a
// bf16's 16 bits), and four adjacent columns of a W row as one load (a
// float4, or four bf16 in 8 bytes); widen/widen4 make them f32 where the
// FMAs use them.
template <typename T>
struct Raw {
  using one = float;
  using four = float4;
};
template <>
struct Raw<__nv_bfloat16> {
  using one = uint16_t;
  using four = uint2;
};
__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(uint16_t v) {
  return __uint_as_float((uint32_t)v << 16);
}
__device__ __forceinline__ float4 widen4(float4 v) { return v; }
using lstm_gates::widen4;

constexpr int kUnroll = 8;       // K rows of a slice whose loads fly at once
constexpr int kMaxThreads = 256;

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

// Shared memory of one block in floats: each slice's partial sums of its
// bm rows x 4 gates x bh columns.  kernels/lstm_cell.py:working_set_bytes
// prices the same.
__host__ __device__ inline long long smem_floats(int bm, int bh, int ks) {
  return (long long)ks * bm * 4 * bh;
}

template <int BM, bool VEC, typename T>
__global__ void __launch_bounds__(kMaxThreads)
    lstm_cell_kernel(const T* __restrict__ w, const T* __restrict__ b,
                     const T* __restrict__ x, const T* __restrict__ c,
                     const T* __restrict__ h, T* __restrict__ c_out,
                     T* __restrict__ h_out, int B, int D, int H,
                     long long x_row_stride, long long h_row_stride,
                     int log_bh, int ks) {
  extern __shared__ float4 part4[];
  float* part = reinterpret_cast<float*>(part4);
  const int K = D + H;
  const long long G = 4LL * H;
  const int bh = 1 << log_bh;
  const int log_nq = log_bh - 2;            // 4-column quads a gate
  const int tid = threadIdx.x;
  const int s = tid >> log_bh;              // K slice
  const int g = (tid & (bh - 1)) >> log_nq;  // gate
  const int cq = tid & ((1 << log_nq) - 1);  // quad
  const int j0 = blockIdx.x * bh;
  const int row0 = blockIdx.y * BM;
  const int col = j0 + 4 * cq;              // the first of the 4 columns
  const T* wcol = w + (long long)g * H + col;

  // the output this thread writes after the barrier, and its operands
  const int r_o = tid >> log_bh, jj = tid & (bh - 1);
  const int row_o = row0 + r_o, j_o = j0 + jj;
  const bool has_out = r_o < BM && row_o < B && j_o < H;
  using R1 = typename Raw<T>::one;
  using R4 = typename Raw<T>::four;
  R1 bias[4] = {};
  R1 c_prev = R1{};
  if (has_out) {
    const R1* br = reinterpret_cast<const R1*>(b);
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) bias[gg] = br[gg * H + j_o];
    c_prev = reinterpret_cast<const R1*>(c)[(long long)row_o * H + j_o];
  }

  float acc[BM][4];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[r][v] = 0.f;

  const R1* xr = reinterpret_cast<const R1*>(x);
  const R1* hr = reinterpret_cast<const R1*>(h);
  for (int q0 = s * kUnroll; q0 < K; q0 += ks * kUnroll) {
    R4 w4[VEC ? kUnroll : 1];
    R1 ws[VEC ? 1 : kUnroll][4];
    R1 xs[kUnroll][BM];
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      const int q = q0 + i;
      const R1* wq = reinterpret_cast<const R1*>(wcol + (long long)q * G);
      if constexpr (VEC) {
        w4[i] = R4{};
        if (q < K && col < H) w4[i] = *reinterpret_cast<const R4*>(wq);
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v)
          ws[i][v] = q < K && col + v < H ? wq[v] : R1{};
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const long long row = row0 + r;
        R1 xq = R1{};
        if (q < K && row < B)
          xq = q < D ? xr[row * x_row_stride + q]
                     : hr[row * h_row_stride + (q - D)];
        xs[i][r] = xq;
      }
    }
#pragma unroll
    for (int i = 0; i < kUnroll; ++i) {
      float wv[4];
      if constexpr (VEC) {
        const float4 t = widen4(w4[i]);
        wv[0] = t.x;
        wv[1] = t.y;
        wv[2] = t.z;
        wv[3] = t.w;
      } else {
#pragma unroll
        for (int v = 0; v < 4; ++v) wv[v] = widen(ws[i][v]);
      }
#pragma unroll
      for (int r = 0; r < BM; ++r)
#pragma unroll
        for (int v = 0; v < 4; ++v)
          acc[r][v] = fmaf(widen(xs[i][r]), wv[v], acc[r][v]);
    }
  }
#pragma unroll
  for (int r = 0; r < BM; ++r)
    *reinterpret_cast<float4*>(part + ((s * BM + r) * 4 + g) * bh +
                               4 * cq) =
        make_float4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]);
  __syncthreads();
  if (has_out) {
    float z[4];
#pragma unroll
    for (int gg = 0; gg < 4; ++gg) {
      const float* p = part + (r_o * 4 + gg) * bh + jj;
      const int step = BM * 4 * bh;          // one slice further
      float a = 0.f;
      for (int t = 0; t < ks; ++t) a += p[t * step];
      z[gg] = a + widen(bias[gg]);
    }
    const float ig = sigmoid(z[0]);
    const float fg = sigmoid(z[1]);
    const float gt = tanhf(z[2]);
    const float og = sigmoid(z[3]);
    const float cn = fg * widen(c_prev) + ig * gt;
    const long long o = (long long)row_o * H + j_o;
    c_out[o] = to_io<T>(cn);
    h_out[o] = to_io<T>(og * tanhf(cn));
  }
}

template <int BM, typename T>
int launch(const T* w, const T* b, const T* x, const T* c, const T* h,
           T* c_out, T* h_out, int B, int D, int H, long long xs,
           long long hs, int log_bh, int ks, size_t smem,
           cudaStream_t stream) {
  const dim3 grid((H + (1 << log_bh) - 1) >> log_bh, (B + BM - 1) / BM);
  const int threads = ks << log_bh;
  if (H % 4 == 0)
    lstm_cell_kernel<BM, true, T><<<grid, threads, smem, stream>>>(
        w, b, x, c, h, c_out, h_out, B, D, H, xs, hs, log_bh, ks);
  else
    lstm_cell_kernel<BM, false, T><<<grid, threads, smem, stream>>>(
        w, b, x, c, h, c_out, h_out, B, D, H, xs, hs, log_bh, ks);
  return (int)cudaGetLastError();
}

// The launch check of both entries: a tile of block_b in {1, 2, 4, 8}
// rows x block_h in {4, 8, 16, 32} columns, k_slices x block_h threads (at
// most 256, k_slices >= block_b), smem exactly 4 * smem_floats(...) bytes:
// what lstm_cell.py:choose_blocks prices.  Grid (ceil(H / block_h),
// ceil(B / block_b)).
template <typename T>
int launch_tile(const T* w, const T* b, const T* x, const T* c, const T* h,
                T* c_out, T* h_out, int B, int D, int H,
                long long x_row_stride, long long h_row_stride, int block_b,
                int block_h, int k_slices, long long smem, void* stream) {
  int log_bh = 0;
  while ((1 << log_bh) < block_h) ++log_bh;
  if (B < 1 || D < 0 || H < 1 || (1 << log_bh) != block_h || block_h < 4 ||
      block_h > 32 || k_slices < block_b || k_slices * block_h > kMaxThreads ||
      (B + block_b - 1) / block_b > 65535 ||
      smem != 4 * smem_floats(block_b, block_h, k_slices) ||
      smem > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (block_b) {
    case 1:
      return launch<1>(w, b, x, c, h, c_out, h_out, B, D, H, x_row_stride,
                       h_row_stride, log_bh, k_slices, smem, st);
    case 2:
      return launch<2>(w, b, x, c, h, c_out, h_out, B, D, H, x_row_stride,
                       h_row_stride, log_bh, k_slices, smem, st);
    case 4:
      return launch<4>(w, b, x, c, h, c_out, h_out, B, D, H, x_row_stride,
                       h_row_stride, log_bh, k_slices, smem, st);
    case 8:
      return launch<8>(w, b, x, c, h, c_out, h_out, B, D, H, x_row_stride,
                       h_row_stride, log_bh, k_slices, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// w (D+H, 4H) 16-byte aligned, b (4H), c (B, H), c_out/h_out (B, H)
// contiguous; x and h rows may be strided (last dim contiguous); the tile
// as launch_tile checks it.
int lstm_cell_f32(const float* w, const float* b, const float* x,
                  const float* c, const float* h, float* c_out, float* h_out,
                  int B, int D, int H, long long x_row_stride,
                  long long h_row_stride, int block_b, int block_h,
                  int k_slices, long long smem, void* stream) {
  return launch_tile(w, b, x, c, h, c_out, h_out, B, D, H, x_row_stride,
                     h_row_stride, block_b, block_h, k_slices, smem, stream);
}

// Every operand bf16, laid out as lstm_cell_f32's.
int lstm_cell_bf16(const __nv_bfloat16* w, const __nv_bfloat16* b,
                   const __nv_bfloat16* x, const __nv_bfloat16* c,
                   const __nv_bfloat16* h, __nv_bfloat16* c_out,
                   __nv_bfloat16* h_out, int B, int D, int H,
                   long long x_row_stride, long long h_row_stride,
                   int block_b, int block_h, int k_slices, long long smem,
                   void* stream) {
  return launch_tile(w, b, x, c, h, c_out, h_out, B, D, H, x_row_stride,
                     h_row_stride, block_b, block_h, k_slices, smem, stream);
}

const char* lstm_cell_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
