// Fused LSTM cell, f32, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/lstm_cell.py:_kernel
// (launched by _lstm_cell_call): one cell step [x, h] @ W + b with the
// sigmoid/tanh gate math fused behind the product, writing (c', h').
//
// What bounds it on the H100: at the paper's cell (B=1, D=32, H=32) one
// call reads about 34 KB (W is (D+H) x 4H f32) and does about 16 KFLOP, so
// bytes bound it at roughly 0.01 us — far below the few microseconds of one
// kernel launch.  The fused_cell plan makes T x L such launches per window,
// so launch latency, not this kernel's arithmetic, sets the plan's time;
// that is the paper's point and why fused_seq (lstm_seq.cu) exists.
//
// Design: a thread block owns a (bm rows) x (bh hidden columns) tile.  The
// block stages its bm rows of [x, h] in shared memory through two pointers
// (the concatenation is never built in global memory).  Each thread owns one
// (row, hidden column j) and accumulates the four gate dot products over
// K = D + H — columns j, H+j, 2H+j and 3H+j of W, so neighbouring threads
// read neighbouring words of W — in f32, then applies the gates in f32 and
// writes c' and h'.  Ragged tiles are masked.

#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

__global__ void lstm_cell_kernel(const float* __restrict__ w,
                                 const float* __restrict__ b,
                                 const float* __restrict__ x,
                                 const float* __restrict__ c,
                                 const float* __restrict__ h,
                                 float* __restrict__ c_out,
                                 float* __restrict__ h_out,
                                 int B, int D, int H,
                                 long long x_row_stride,
                                 long long h_row_stride) {
  extern __shared__ float xh[];  // (bm, K) rows of [x, h]
  const int K = D + H;
  const int G = 4 * H;
  const int bh = blockDim.x;
  const int bm = blockDim.y;
  const int row0 = blockIdx.x * bm;
  const int tid = threadIdx.y * bh + threadIdx.x;
  const int nt = bm * bh;

  for (int i = tid; i < bm * K; i += nt) {
    const int r = i / K;
    const int q = i - r * K;
    const int row = row0 + r;
    float v = 0.0f;
    if (row < B) {
      v = q < D ? x[row * x_row_stride + q] : h[row * h_row_stride + (q - D)];
    }
    xh[i] = v;
  }
  __syncthreads();

  const int row = row0 + threadIdx.y;
  const int j = blockIdx.y * bh + threadIdx.x;
  if (row >= B || j >= H) return;

  const float* xr = xh + threadIdx.y * K;
  float ai = 0.0f, af = 0.0f, ag = 0.0f, ao = 0.0f;
  for (int q = 0; q < K; ++q) {
    const float v = xr[q];
    const float* wq = w + (long long)q * G;
    ai = fmaf(v, wq[j], ai);
    af = fmaf(v, wq[H + j], af);
    ag = fmaf(v, wq[2 * H + j], ag);
    ao = fmaf(v, wq[3 * H + j], ao);
  }
  const float ig = sigmoid(ai + b[j]);
  const float fg = sigmoid(af + b[H + j]);
  const float gg = tanhf(ag + b[2 * H + j]);
  const float og = sigmoid(ao + b[3 * H + j]);
  const long long o = (long long)row * H + j;
  const float cn = fg * c[o] + ig * gg;
  c_out[o] = cn;
  h_out[o] = og * tanhf(cn);
}

}  // namespace

extern "C" {

// w (D+H, 4H), b (4H), c (B, H), c_out/h_out (B, H) contiguous; x and h
// rows may be strided (last dim contiguous).  Grid (ceil(B/bm), ceil(H/bh)).
int lstm_cell_f32(const float* w, const float* b, const float* x,
                  const float* c, const float* h, float* c_out, float* h_out,
                  int B, int D, int H, long long x_row_stride,
                  long long h_row_stride, int block_b, int block_h,
                  void* stream) {
  const dim3 block(block_h, block_b);
  const dim3 grid((B + block_b - 1) / block_b, (H + block_h - 1) / block_h);
  const size_t smem = sizeof(float) * (size_t)block_b * (D + H);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_cell_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  lstm_cell_kernel<<<grid, block, smem, (cudaStream_t)stream>>>(
      w, b, x, c, h, c_out, h_out, B, D, H, x_row_stride, h_row_stride);
  return (int)cudaGetLastError();
}

const char* lstm_cell_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
