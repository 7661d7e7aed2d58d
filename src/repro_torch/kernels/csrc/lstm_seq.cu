// Sequence-resident stacked-LSTM forward, f32, for Hopper (sm_90a).
//
// Replaces two Pallas kernels of the JAX package's kernels/lstm_seq.py:
// _seq_kernel (launched by _lstm_seq_call, whole (T, bm, P) input block
// resident) and _seq_chunked_kernel (launched by _lstm_seq_chunked_call,
// input streamed through two (tc, bm, P) windows).  Here they are one
// kernel: the input always streams through a shared-memory ring of
// time_chunk steps; a chunk of T or more is the whole-T layout with a single
// slot.  The per-step arithmetic does not depend on the chunking, so every
// time_chunk gives bit-identical results.
//
// What bounds it on the H100: at the paper's 2 x 32 config, B=1, T=128 one
// forward does about 4.2 MFLOP and reads under 100 KB, which the card could
// do in well under a microsecond.  The bound is the chain of T x L = 256
// dependent cell steps: every step needs the previous step's h across all
// hidden columns, so each step is a product, a barrier, the gate math and a
// barrier, one after another.
//
// Design: one persistent thread block per batch tile runs the whole T x L
// recurrence in one launch.  The hidden dimension is never split across
// thread blocks, because hidden tiles are not independent across steps.
// The (L, P+H, 4H) weight stack and the bias are copied into dynamic shared
// memory once (64 KiB + 1 KiB at 2 x 32) and the (c, h) state of every layer
// lives in f32 shared memory for the whole sequence, so nothing but x is
// read from device memory after the start and nothing but the final (c, h)
// is written.  Per step and layer: the gate pass computes
// inp @ W[:P] + h @ W[P:] + b, applies each gate's sigmoid or tanh and puts
// the activated gates in a shared gate buffer; a barrier; the update pass
// computes c' = f * c + i * g and h' = o * tanh(c'); a barrier.  The next
// layer's input is this layer's h (the zero padding of h to P contributes
// nothing, so it is skipped).  The ring is filled with cp.async: chunk k+1
// loads while chunk k computes.  Rows of a batch tail past B are zero in the
// ring and never written.
//
// The step chain is kept short.  `parts` adjacent lanes share each gate
// column: lane p of a column sums reduction rows p, p + parts, ... for every
// row of the tile (each weight word is read once and reused across the
// tile's rows), the lanes combine their sums with warp shuffles in a fixed
// order (so results stay deterministic), and each lane applies the gate's
// activation, so 4H columns' activations run in parallel and the update
// pass is two products and one tanh per element.  W rows are padded to
// 4H + 8 words in shared memory so the 32 lanes of a warp (8 columns x 4
// parts) read 32 different banks.  The wrapper keeps tiles small (one row
// per block until the batch outgrows the SMs, then a power of two up to 16
// rows, one kernel instance per size), so a block's work per step stays
// small.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kPad = 8;  // words of padding per W row in shared memory

__device__ __forceinline__ float sigmoid(float v) {
  return 1.0f / (1.0f + expf(-v));
}

template <int ROWS>
__global__ void lstm_seq_fwd_kernel(const float* __restrict__ w,
                                    const float* __restrict__ b,
                                    const float* __restrict__ x,
                                    float* __restrict__ c_out,
                                    float* __restrict__ h_out, int B, int T,
                                    int L, int P, int H, int tc, int parts,
                                    long long x_stride_b,
                                    long long x_stride_t) {
  extern __shared__ float smem[];
  const int G = 4 * H;
  const int S = G + kPad;  // row stride of W in shared memory
  const int K = P + H;
  const int nc = (T + tc - 1) / tc;
  const int slots = nc > 1 ? 2 : 1;
  const int slot_elems = tc * ROWS * P;
  float* w_s = smem;                                  // (L, K, S)
  float* b_s = w_s + (size_t)L * K * S;               // (L, G)
  float* ring = b_s + (size_t)L * G;                  // (slots, tc, ROWS, P)
  float* c_s = ring + (size_t)slots * slot_elems;     // (L, ROWS, H)
  float* h_s = c_s + (size_t)L * ROWS * H;            // (L, ROWS, H)
  float* g_s = h_s + (size_t)L * ROWS * H;            // (ROWS, G)

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, B - row0);

  // This thread's gate column j and reduction part p, fixed for the run.
  const bool active = tid < parts * G;
  const int p = tid % parts;
  const int j = active ? tid / parts : 0;
  const bool is_tanh = j / H == 2;  // gate order i, f, g, o

  // Weights into padded rows (16-byte copies when aligned), bias, state.
  const bool vec = (reinterpret_cast<uintptr_t>(w) % 16 == 0) && (G % 4 == 0);
  const int n_rows = L * K;
  if (vec) {
    const int per_row = G / 4;
    for (int i = tid; i < n_rows * per_row; i += nt) {
      const int row = i / per_row;
      const int col = (i - row * per_row) * 4;
      __pipeline_memcpy_async(w_s + (size_t)row * S + col,
                              w + (size_t)row * G + col, 16);
    }
  } else {
    for (int i = tid; i < n_rows * G; i += nt) {
      const int row = i / G;
      const int col = i - row * G;
      __pipeline_memcpy_async(w_s + (size_t)row * S + col,
                              w + (size_t)row * G + col, 4);
    }
  }
  for (int i = tid; i < L * G; i += nt) __pipeline_memcpy_async(b_s + i, b + i, 4);
  for (int i = tid; i < L * ROWS * H; i += nt) {
    c_s[i] = 0.0f;
    h_s[i] = 0.0f;
  }

  // Start copying chunk k's (steps, ROWS, P) window into its ring slot.
  auto load_chunk = [&](int k) {
    float* dst = ring + (size_t)(k % slots) * slot_elems;
    const int t0 = k * tc;
    const int n = min(tc, T - t0) * ROWS * P;
    for (int i = tid; i < n; i += nt) {
      const int q = i % P;
      const int r = (i / P) % ROWS;
      const int s = i / (P * ROWS);
      if (r < rows) {
        __pipeline_memcpy_async(
            dst + i,
            x + (long long)(t0 + s) * x_stride_t +
                (long long)(row0 + r) * x_stride_b + q,
            4);
      } else {
        dst[i] = 0.0f;
      }
    }
    __pipeline_commit();
  };

  load_chunk(0);  // the first group also carries the weights and bias
  for (int k = 0; k < nc; ++k) {
    if (k + 1 < nc) {
      load_chunk(k + 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const float* xs = ring + (size_t)(k % slots) * slot_elems;
    const int steps = min(tc, T - k * tc);
    for (int s = 0; s < steps; ++s) {
      const float* inp = xs + (size_t)s * ROWS * P;
      int in_w = P;  // layer 0 reads all P input columns, later layers H
      for (int l = 0; l < L; ++l) {
        const float* wl = w_s + (size_t)l * K * S + j;
        const float* wh = wl + (size_t)P * S;
        float* cl = c_s + (size_t)l * ROWS * H;
        float* hl = h_s + (size_t)l * ROWS * H;
        float acc[ROWS];
#pragma unroll
        for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
        for (int q = p; q < in_w; q += parts) {
          const float wv = wl[(size_t)q * S];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            acc[r] = fmaf(inp[r * in_w + q], wv, acc[r]);
        }
        for (int q = p; q < H; q += parts) {
          const float wv = wh[(size_t)q * S];
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            acc[r] = fmaf(hl[r * H + q], wv, acc[r]);
        }
        for (int off = 1; off < parts; off <<= 1) {
#pragma unroll
          for (int r = 0; r < ROWS; ++r)
            acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
        }
        if (active) {
          const float bias = b_s[(size_t)l * G + j];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) {
            const float v = acc[r] + bias;
            const float a = is_tanh ? tanhf(v) : sigmoid(v);
            if (p == 0) g_s[r * G + j] = a;
          }
        }
        __syncthreads();
        for (int e = tid; e < ROWS * H; e += nt) {
          const int r = e / H;
          const float* gr = g_s + r * G + (e - r * H);
          const float cn = gr[H] * cl[e] + gr[0] * gr[2 * H];
          cl[e] = cn;
          hl[e] = gr[3 * H] * tanhf(cn);
        }
        __syncthreads();
        inp = hl;
        in_w = H;
      }
    }
    // The barriers above also order this chunk's last reads of its slot
    // before the next iteration refills the slot.
  }

  for (int e = tid; e < L * ROWS * H; e += nt) {
    const int l = e / (ROWS * H);
    const int r = (e / H) % ROWS;
    const int jj = e % H;
    if (r < rows) {
      const long long o = ((long long)l * B + row0 + r) * H + jj;
      c_out[o] = c_s[e];
      h_out[o] = h_s[e];
    }
  }
}

template <int ROWS>
int launch(const float* w, const float* b, const float* x, float* c_out,
           float* h_out, int B, int T, int L, int P, int H,
           long long x_stride_b, long long x_stride_t, int time_chunk,
           int parts, int threads, long long smem_bytes,
           cudaStream_t stream) {
  static long long configured = 48 * 1024;
  if (smem_bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_fwd_kernel<ROWS>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    configured = smem_bytes;
  }
  const int grid = (B + ROWS - 1) / ROWS;
  lstm_seq_fwd_kernel<ROWS><<<grid, threads, (size_t)smem_bytes, stream>>>(
      w, b, x, c_out, h_out, B, T, L, P, H, time_chunk, parts, x_stride_b,
      x_stride_t);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// w (L, P+H, 4H), b (L, 4H), c_out/h_out (L, B, H) contiguous; x element
// (b, t, p) at x[b * x_stride_b + t * x_stride_t + p].  One thread block of
// `threads` (>= parts * 4H, a multiple of 32) threads per batch tile of
// block_b rows (1, 2, 4, 8 or 16), `parts` (1, 2 or 4) lanes to a gate
// column; smem_bytes is the wrapper's working_set_bytes for
// (block_b, time_chunk).  Returns cudaErrorInvalidValue for another
// block_b.
int lstm_seq_fwd_f32(const float* w, const float* b, const float* x,
                     float* c_out, float* h_out, int B, int T, int L, int P,
                     int H, long long x_stride_b, long long x_stride_t,
                     int block_b, int time_chunk, int parts, int threads,
                     long long smem_bytes, void* stream) {
#define LSTM_SEQ_LAUNCH(R)                                                  \
  case R:                                                                   \
    return launch<R>(w, b, x, c_out, h_out, B, T, L, P, H, x_stride_b,      \
                     x_stride_t, time_chunk, parts, threads, smem_bytes,    \
                     (cudaStream_t)stream);
  switch (block_b) {
    LSTM_SEQ_LAUNCH(1)
    LSTM_SEQ_LAUNCH(2)
    LSTM_SEQ_LAUNCH(4)
    LSTM_SEQ_LAUNCH(8)
    LSTM_SEQ_LAUNCH(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LSTM_SEQ_LAUNCH
}

const char* lstm_seq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
