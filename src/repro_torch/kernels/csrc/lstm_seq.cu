// Sequence-resident stacked-LSTM forward, f32 or int8 weights, for Hopper
// (sm_90a).
//
// Replaces eight Pallas kernels of the JAX package's kernels/lstm_seq.py:
// _seq_kernel (launched by _lstm_seq_call, whole (T, bm, P) input block
// resident) and _seq_chunked_kernel (launched by _lstm_seq_chunked_call,
// input streamed through two (tc, bm, P) windows), their
// trajectory-writing twins _seq_traj_kernel (_lstm_seq_traj_call) and
// _seq_traj_chunked_kernel (_lstm_seq_traj_chunked_call), which the training
// forward launches, and the int8-weight bodies of all four (_seq_q8_kernel,
// _seq_chunked_q8_kernel, _seq_traj_q8_kernel, _seq_traj_chunked_q8_kernel:
// the fused_seq_q8 plan).  Here they are one kernel: the input always
// streams through a shared-memory ring of time_chunk steps; a chunk of T or
// more is the whole-T layout with a single slot.  The per-step arithmetic
// does not depend on the chunking, so every time_chunk gives bit-identical
// results.  The TRAJ instance also writes every step's post-step f32 (c, h)
// of every layer into (T, L, B, H) trajectories, straight from the update
// pass to device memory (no shared memory), for the rows below B; nothing
// else differs, so its final (c, h) equal the plain instance's to the bit.
// The int8 instances (WT = int8_t) hold the stack as int8 codes in rows
// padded in bytes (lstm_gates.cuh), with the (L, 4H) f32 scales beside the
// bias; the gate pass converts each code to f32 in a register and folds the
// column's scale after the reduction, and everything after the gate pass,
// the f32 trajectories included, is the f32 instance's code.
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
// memory once (64 KiB + 1 KiB at 2 x 32; int8: 18 KiB + 2 KiB with the
// scales, and 68 KiB at 2 x 64, where the f32 stack's 256 KiB fits no
// block) and the (c, h) state of every layer
// lives in f32 shared memory for the whole sequence, so nothing but x is
// read from device memory after the start and nothing but the final (c, h)
// (and, for TRAJ, the trajectories) is written.  Per step and layer: the
// gate pass (lstm_gates.cuh, shared with the backward's recompute) computes
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
// pass is two products and one tanh per element.  W rows are padded in
// shared memory (f32: 4H + 8 words; int8: see lstm_gates.cuh) so the 32
// lanes of a warp (8 columns x 4 parts) read without bank conflicts.  The
// wrapper keeps tiles small (one row
// per block until the batch outgrows the SMs, then a power of two up to 16
// rows, one kernel instance per size), so a block's work per step stays
// small.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_gates.cuh"

namespace {

template <int ROWS, bool TRAJ, typename WT>
__global__ void lstm_seq_fwd_kernel(const WT* __restrict__ w,
                                    const float* __restrict__ scales,
                                    const float* __restrict__ b,
                                    const float* __restrict__ x,
                                    float* __restrict__ c_out,
                                    float* __restrict__ h_out,
                                    float* __restrict__ c_traj,
                                    float* __restrict__ h_traj, int B, int T,
                                    int L, int P, int H, int tc, int parts,
                                    long long x_stride_b,
                                    long long x_stride_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kQ8 = sizeof(WT) == 1;
  const int G = 4 * H;
  const int S = lstm_gates::row_stride<WT>(G);  // W row stride in shared mem
  const int K = P + H;
  const int nc = (T + tc - 1) / tc;
  const int slots = nc > 1 ? 2 : 1;
  const int slot_elems = tc * ROWS * P;
  WT* w_s = reinterpret_cast<WT*>(smem);              // (L, K, S)
  float* b_s = reinterpret_cast<float*>(w_s + (size_t)L * K * S);  // (L, G)
  float* s_s = b_s + (size_t)L * G;                   // (L, G), int8 only
  float* ring = s_s + (kQ8 ? (size_t)L * G : 0);      // (slots, tc, ROWS, P)
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

  // Weights into padded rows, bias (and scales), state.
  lstm_gates::load_stack(w_s, w, L * K, G, S, tid, nt);
  for (int i = tid; i < L * G; i += nt) {
    __pipeline_memcpy_async(b_s + i, b + i, 4);
    if (kQ8) __pipeline_memcpy_async(s_s + i, scales + i, 4);
  }
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
      const int t = k * tc + s;
      const float* inp = xs + (size_t)s * ROWS * P;
      int in_w = P;  // layer 0 reads all P input columns, later layers H
      for (int l = 0; l < L; ++l) {
        const WT* wl = w_s + (size_t)l * K * S + j;
        float* cl = c_s + (size_t)l * ROWS * H;
        float* hl = h_s + (size_t)l * ROWS * H;
        lstm_gates::gate_pass<ROWS>(inp, in_w, hl, H, wl, wl + (size_t)P * S,
                                    S, b_s + (size_t)l * G,
                                    s_s + (size_t)l * G, j, p, parts, active,
                                    is_tanh, g_s);
        __syncthreads();
        for (int e = tid; e < ROWS * H; e += nt) {
          const int r = e / H;
          const float* gr = g_s + r * G + (e - r * H);
          const float cn = gr[H] * cl[e] + gr[0] * gr[2 * H];
          const float hn = gr[3 * H] * tanhf(cn);
          cl[e] = cn;
          hl[e] = hn;
          if (TRAJ && r < rows) {
            const long long o =
                (((long long)t * L + l) * B + row0 + r) * H + (e - r * H);
            c_traj[o] = cn;
            h_traj[o] = hn;
          }
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

template <int ROWS, bool TRAJ, typename WT>
int launch(const WT* w, const float* scales, const float* b, const float* x,
           float* c_out, float* h_out, float* c_traj, float* h_traj, int B,
           int T, int L, int P, int H, long long x_stride_b,
           long long x_stride_t, int time_chunk, int parts, int threads,
           long long smem_bytes, cudaStream_t stream) {
  static long long configured = 48 * 1024;
  if (smem_bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_fwd_kernel<ROWS, TRAJ, WT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    configured = smem_bytes;
  }
  const int grid = (B + ROWS - 1) / ROWS;
  lstm_seq_fwd_kernel<ROWS, TRAJ, WT>
      <<<grid, threads, (size_t)smem_bytes, stream>>>(
          w, scales, b, x, c_out, h_out, c_traj, h_traj, B, T, L, P, H,
          time_chunk, parts, x_stride_b, x_stride_t);
  return (int)cudaGetLastError();
}

template <int ROWS, typename WT>
int launch_rows(const WT* w, const float* scales, const float* b,
                const float* x, float* c_out, float* h_out, float* c_traj,
                float* h_traj, int B, int T, int L, int P, int H,
                long long x_stride_b, long long x_stride_t, int time_chunk,
                int parts, int threads, long long smem_bytes,
                cudaStream_t stream) {
  if (c_traj != nullptr)
    return launch<ROWS, true>(w, scales, b, x, c_out, h_out, c_traj, h_traj,
                              B, T, L, P, H, x_stride_b, x_stride_t,
                              time_chunk, parts, threads, smem_bytes, stream);
  return launch<ROWS, false>(w, scales, b, x, c_out, h_out, nullptr, nullptr,
                             B, T, L, P, H, x_stride_b, x_stride_t,
                             time_chunk, parts, threads, smem_bytes, stream);
}

// One instance per tile size; another block_b is cudaErrorInvalidValue.
template <typename WT>
int launch_tile(const WT* w, const float* scales, const float* b,
                const float* x, float* c_out, float* h_out, float* c_traj,
                float* h_traj, int B, int T, int L, int P, int H,
                long long x_stride_b, long long x_stride_t, int block_b,
                int time_chunk, int parts, int threads, long long smem_bytes,
                void* stream) {
#define LSTM_SEQ_LAUNCH(R)                                                  \
  case R:                                                                   \
    return launch_rows<R>(w, scales, b, x, c_out, h_out, c_traj, h_traj, B, \
                          T, L, P, H, x_stride_b, x_stride_t, time_chunk,   \
                          parts, threads, smem_bytes, (cudaStream_t)stream);
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

}  // namespace

extern "C" {

// w (L, P+H, 4H), b (L, 4H), c_out/h_out (L, B, H) contiguous; x element
// (b, t, p) at x[b * x_stride_b + t * x_stride_t + p].  c_traj/h_traj are
// null, or (T, L, B, H) f32 that receive every step's post-step (c, h) (the
// training forward; the arithmetic is the same either way, so the final
// (c, h) are bit-identical with and without them).  One thread block of
// `threads` (>= parts * 4H, a multiple of 32) threads per batch tile of
// block_b rows (1, 2, 4, 8 or 16), `parts` (1, 2 or 4) lanes to a gate
// column; smem_bytes is the wrapper's working_set_bytes for
// (block_b, time_chunk).  Returns cudaErrorInvalidValue for another
// block_b.
int lstm_seq_fwd_f32(const float* w, const float* b, const float* x,
                     float* c_out, float* h_out, float* c_traj,
                     float* h_traj, int B, int T, int L, int P, int H,
                     long long x_stride_b, long long x_stride_t, int block_b,
                     int time_chunk, int parts, int threads,
                     long long smem_bytes, void* stream) {
  return launch_tile<float>(w, nullptr, b, x, c_out, h_out, c_traj, h_traj,
                            B, T, L, P, H, x_stride_b, x_stride_t, block_b,
                            time_chunk, parts, threads, smem_bytes, stream);
}

// The int8 plan: wq (L, P+H, 4H) int8 codes and scales (L, 4H) f32, the
// stack's weight being wq * scales[l, j]; everything else as
// lstm_seq_fwd_f32 (smem_bytes is working_set_bytes(quantized=True)).
int lstm_seq_fwd_q8(const int8_t* wq, const float* scales, const float* b,
                    const float* x, float* c_out, float* h_out,
                    float* c_traj, float* h_traj, int B, int T, int L, int P,
                    int H, long long x_stride_b, long long x_stride_t,
                    int block_b, int time_chunk, int parts, int threads,
                    long long smem_bytes, void* stream) {
  return launch_tile<int8_t>(wq, scales, b, x, c_out, h_out, c_traj, h_traj,
                             B, T, L, P, H, x_stride_b, x_stride_t, block_b,
                             time_chunk, parts, threads, smem_bytes, stream);
}

const char* lstm_seq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
