// Sequence-resident stacked-LSTM backward (the whole BPTT sweep), f32 or
// int8 weights, for Hopper (sm_90a).
//
// Replaces four Pallas kernels of the JAX package's kernels/lstm_seq_bwd.py:
// _seq_bwd_kernel (launched by _lstm_seq_bwd_call, x and both trajectories
// resident) and _seq_bwd_chunked_kernel (launched by
// _lstm_seq_bwd_chunked_call, x and the trajectories streamed in reverse
// chunk order), and their int8-weight bodies _seq_bwd_q8_kernel and
// _seq_bwd_chunked_q8_kernel (the fused_seq_q8 plan's training backward).
// Here they are one kernel: x and the trajectories always
// stream through a shared-memory ring of time_chunk steps, read from the
// last chunk to the first; a chunk of T is the whole-T layout with a single
// slot.  The unwind arithmetic does not depend on the chunking, so every
// time_chunk gives bit-identical gradients.
//
// Inputs: w (L, P+H, 4H), b (L, 4H), x (B, T, P) read through its strides,
// the forward's post-step f32 trajectories c_traj, h_traj (T, L, B, H) and
// the final-state cotangents dc, dh (L, B, H).  Outputs: dw (L, P+H, 4H),
// db (L, 4H) and dx (B, T, P), all f32.
//
// Int8 weights (WT = int8_t): w is the int8 stack the q8 forward ran with
// and scales (L, 4H) its f32 per-column scales, held beside the bias; the
// weight the forward used is wq * s.  The recompute (a) is the q8 forward's
// gate pass, scale fold included, so it stays bit-identical to it.  dW and
// db (c) take the UNSCALED dg: that is the straight-through gradient with
// respect to the dequantized weights, accumulated and written in f32 for
// the f32 master stack.  Only the outgoing products take the scale:
// dh_prev = (dg * s) W[P:]^T and dinp = (dg * s) W[:P]^T, as the JAX
// package's _unwind_step does, through a second (ROWS, 4H) buffer that (b)
// fills with dg * s beside dg -- scaling dg in place would scale dW and db
// too.
//
// What bounds it on the H100: like the forward, the chain of T x L dependent
// layer-steps, now three passes long each (gate recompute, gate gradients,
// the products), not FLOPs or bytes: at the paper's 2 x 32, B=64, T=128 the
// sweep does about 3x the forward's 4.2 MFLOP per row and moves a few MB.
//
// Design: one persistent thread block per batch tile (the forward's tile
// rule) unwinds the whole T x L recurrence in one launch, time backwards and
// layers top-down, with the (L, P+H, 4H) weight stack resident in shared
// memory and the (dc, dh) carries in f32 shared memory.  Per layer-step:
//  (a) recompute the gates with lstm_gates::gate_pass, the function the
//      forward ran, on the same f32 inputs read back from the trajectories,
//      so the recomputed activations are the forward's to the bit; barrier;
//  (b) form the gate gradients dg (ROWS, 4H) and the dc carry, as
//      _unwind_step does; barrier;
//  (c) accumulate dW += [inp | h_prev]^T dg and db += sum dg into f32
//      shared-memory accumulators (lane (j, p) owns the rows p, p + parts, ...
//      of column j it read in (a)), and form dh_prev = dg W[P:]^T (the
//      carry) and dinp = dg W[:P]^T (the layer below's input gradient, or dx
//      at layer 0, written straight to device memory), each row of W
//      summed by `dparts` lanes combined by shuffle in a fixed order.
// The trajectory window of a chunk is tc + 1 rows: row 0 holds the step
// before the chunk (zeros before t = 0), so the pre-step state of a chunk's
// first step is the same trajectory row the whole-T layout reads.  Rows of a
// batch tail past B are zero in the ring and their gate gradients are set to
// zero, so they never reach dW or db.
//
// dW and db across batch tiles: blocks run in parallel and in no order, and
// float atomics would make the sum differ run to run.  So each block writes
// its f32 partial to a workspace, and the last block to finish (an integer
// ticket: __threadfence, then atomicAdd on a counter of the launch's stream,
// which that block resets to 0 for the stream's next launch, so launches on
// two streams never share one) sums the partials in tile order 0 .. n-1 and
// writes dw and db.  One launch, no fill of the ticket, and results identical
// run to run.  A single tile writes dw and db directly.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "lstm_gates.cuh"

namespace {


// Bounded for MAX_T threads, so every block the wrapper sizes can launch:
// uncapped, the largest instance took 128 registers a thread, too many for
// the 576 threads of H = 36 (144 gate columns x 4 lanes) on one SM's 65,536
// registers.  Each tile size is built twice: MAX_T = 512 (up to 128
// registers, no spills) serves H <= 32, the paper's width included, and
// MAX_T = 1024 (64 registers) the wider blocks.
template <int ROWS, int MAX_T, typename WT>
__global__ void __launch_bounds__(MAX_T) lstm_seq_bwd_kernel(
    const WT* __restrict__ w, const float* __restrict__ scales,
    const float* __restrict__ b,
    const float* __restrict__ x, const float* __restrict__ c_traj,
    const float* __restrict__ h_traj, const float* __restrict__ dcf,
    const float* __restrict__ dhf, float* __restrict__ dw,
    float* __restrict__ db, float* __restrict__ dx,
    float* __restrict__ partials, int* __restrict__ ticket, int B, int T,
    int L, int P, int H, int tc, int parts, int dparts, long long x_stride_b,
    long long x_stride_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kQ8 = sizeof(WT) == 1;
  const int G = 4 * H;
  const int S = lstm_gates::row_stride<WT>(G);     // W row stride
  const int SF = lstm_gates::row_stride<float>(G);  // dW row stride (f32)
  const int K = P + H;
  const int nc = (T + tc - 1) / tc;
  const int slots = nc > 1 ? 2 : 1;
  const int x_slot = tc * ROWS * P;
  const int layer_state = ROWS * H;          // one layer's (ROWS, H)
  const int t_row = L * layer_state;         // one trajectory row
  const int t_slot = (tc + 1) * t_row;       // one trajectory window
  // The forward's terms first (lstm_seq.working_set_bytes), then the
  // backward's own; the sum is the launch's dynamic shared memory.
  WT* w_s = reinterpret_cast<WT*>(smem);            // (L, K, S)
  float* b_s = reinterpret_cast<float*>(w_s + (size_t)L * K * S);  // (L, G)
  float* s_s = b_s + (size_t)L * G;                 // (L, G), int8 only
  float* xr = s_s + (kQ8 ? (size_t)L * G : 0);      // (slots, tc, ROWS, P)
  float* dc_s = xr + (size_t)slots * x_slot;        // (L, ROWS, H)
  float* dh_s = dc_s + (size_t)L * layer_state;     // (L, ROWS, H)
  float* g_s = dh_s + (size_t)L * layer_state;      // (ROWS, G)
  float* dw_s = g_s + (size_t)ROWS * G;             // (L, K, SF)
  float* db_s = dw_s + (size_t)L * K * SF;          // (L, G)
  float* cr = db_s + (size_t)L * G;             // (slots, tc+1, L, ROWS, H)
  float* hr = cr + (size_t)slots * t_slot;      // (slots, tc+1, L, ROWS, H)
  float* dg_s = hr + (size_t)slots * t_slot;        // (ROWS, G)
  float* di_s = dg_s + (size_t)ROWS * G;            // (ROWS, H)
  float* dgs_s = di_s + (size_t)ROWS * H;           // (ROWS, G), int8 only
  // the gate gradients the outgoing products read: dg * s for int8
  const float* dprod = kQ8 ? dgs_s : dg_s;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, B - row0);

  // Gate lane (j, p), as in the forward, fixed for the run.
  const bool active = tid < parts * G;
  const int p = tid % parts;
  const int j = active ? tid / parts : 0;
  const bool is_tanh = j / H == 2;  // gate order i, f, g, o
  // Product lane: part dp of the dparts lanes that sum one row of W.
  const int dp = tid % dparts;
  const int q_lanes = nt / dparts;  // rows of W per sweep of the block

  // Weights into padded rows, bias (and scales).
  lstm_gates::load_stack(w_s, w, L * K, G, S, tid, nt);
  for (int i = tid; i < L * G; i += nt) {
    __pipeline_memcpy_async(b_s + i, b + i, 4);
    if (kQ8) __pipeline_memcpy_async(s_s + i, scales + i, 4);
  }
  for (int i = tid; i < L * K * SF; i += nt) dw_s[i] = 0.0f;
  for (int i = tid; i < L * G; i += nt) db_s[i] = 0.0f;
  // The carries start at the final-state cotangents (zero past B).
  for (int e = tid; e < L * layer_state; e += nt) {
    const int l = e / layer_state;
    const int r = (e / H) % ROWS;
    const int kk = e % H;
    float dcv = 0.0f, dhv = 0.0f;
    if (r < rows) {
      const long long o = ((long long)l * B + row0 + r) * H + kk;
      dcv = dcf[o];
      dhv = dhf[o];
    }
    dc_s[e] = dcv;
    dh_s[e] = dhv;
  }

  // Start copying chunk k into its ring slot: x rows t0 .. t0+steps-1 and
  // trajectory rows t0-1 .. t0+steps-1 (window row u holds step t0-1+u).
  auto load_chunk = [&](int k) {
    const int t0 = k * tc;
    const int steps = min(tc, T - t0);
    float* xd = xr + (size_t)(k % slots) * x_slot;
    for (int i = tid; i < steps * ROWS * P; i += nt) {
      const int q = i % P;
      const int r = (i / P) % ROWS;
      const int s = i / (P * ROWS);
      if (r < rows) {
        __pipeline_memcpy_async(
            xd + i,
            x + (long long)(t0 + s) * x_stride_t +
                (long long)(row0 + r) * x_stride_b + q,
            4);
      } else {
        xd[i] = 0.0f;
      }
    }
    float* cd = cr + (size_t)(k % slots) * t_slot;
    float* hd = hr + (size_t)(k % slots) * t_slot;
    for (int i = tid; i < (steps + 1) * t_row; i += nt) {
      const int kk = i % H;
      const int r = (i / H) % ROWS;
      const int l = (i / layer_state) % L;
      const int t = t0 - 1 + i / t_row;
      if (r < rows && t >= 0) {
        const long long o = (((long long)t * L + l) * B + row0 + r) * H + kk;
        __pipeline_memcpy_async(cd + i, c_traj + o, 4);
        __pipeline_memcpy_async(hd + i, h_traj + o, 4);
      } else {
        cd[i] = 0.0f;
        hd[i] = 0.0f;
      }
    }
    __pipeline_commit();
  };

  load_chunk(nc - 1);  // the first group also carries the weights and bias
  for (int k = nc - 1; k >= 0; --k) {
    if (k > 0) {
      load_chunk(k - 1);
      __pipeline_wait_prior(1);
    } else {
      __pipeline_wait_prior(0);
    }
    __syncthreads();
    const int slot = k % slots;
    const float* xs = xr + (size_t)slot * x_slot;
    const float* cw = cr + (size_t)slot * t_slot;
    const float* hw = hr + (size_t)slot * t_slot;
    const int t0 = k * tc;
    const int steps = min(tc, T - t0);
    for (int s = steps - 1; s >= 0; --s) {
      const int t = t0 + s;
      const float* c_now = cw + (size_t)(s + 1) * t_row;  // after step t
      const float* h_now = hw + (size_t)(s + 1) * t_row;
      const float* c_pre = cw + (size_t)s * t_row;        // before step t
      const float* h_pre = hw + (size_t)s * t_row;
      for (int l = L - 1; l >= 0; --l) {
        const float* inp = l == 0 ? xs + (size_t)s * ROWS * P
                                  : h_now + (size_t)(l - 1) * layer_state;
        const int in_w = l == 0 ? P : H;
        const float* hp = h_pre + (size_t)l * layer_state;
        const WT* wl = w_s + (size_t)l * K * S;
        const float* sl = s_s + (size_t)l * G;

        // (a) the forward's gates, recomputed bit for bit.
        lstm_gates::gate_pass<ROWS>(inp, in_w, hp, H, wl + j,
                                    wl + (size_t)P * S + j, S,
                                    b_s + (size_t)l * G, sl, j, p, parts,
                                    active, is_tanh, g_s);
        __syncthreads();

        // (b) gate gradients and the dc carry (_unwind_step's dgates).
        float* dcl = dc_s + (size_t)l * layer_state;
        float* dhl = dh_s + (size_t)l * layer_state;
        const float* cn = c_now + (size_t)l * layer_state;
        const float* cp = c_pre + (size_t)l * layer_state;
        for (int e = tid; e < layer_state; e += nt) {
          const int r = e / H;
          const int kk = e - r * H;
          const float* gr = g_s + r * G + kk;
          const float si = gr[0], sf = gr[H], tg = gr[2 * H], so = gr[3 * H];
          const float tcn = tanhf(cn[e]);
          const float dhv = dhl[e] + (l + 1 < L ? di_s[e] : 0.0f);
          const float dcv = dcl[e] + dhv * so * (1.0f - tcn * tcn);
          float* dgr = dg_s + r * G + kk;
          const bool ok = r < rows;
          dgr[0] = ok ? dcv * tg * si * (1.0f - si) : 0.0f;
          dgr[H] = ok ? dcv * cp[e] * sf * (1.0f - sf) : 0.0f;
          dgr[2 * H] = ok ? dcv * si * (1.0f - tg * tg) : 0.0f;
          dgr[3 * H] = ok ? dhv * tcn * so * (1.0f - so) : 0.0f;
          if (kQ8) {
            float* dsr = dgs_s + r * G + kk;
#pragma unroll
            for (int g = 0; g < 4; ++g)
              dsr[g * H] = dgr[g * H] * sl[g * H + kk];
          }
          dcl[e] = dcv * sf;
        }
        __syncthreads();

        // (c) dW and db, then the dh carry and the input gradient.
        if (active) {
          float* dwl = dw_s + (size_t)l * K * SF + j;
          for (int q = p; q < in_w; q += parts) {
            float sum = 0.0f;
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              sum = fmaf(inp[r * in_w + q], dg_s[r * G + j], sum);
            dwl[(size_t)q * SF] += sum;
          }
          for (int q = p; q < H; q += parts) {
            float sum = 0.0f;
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              sum = fmaf(hp[r * H + q], dg_s[r * G + j], sum);
            dwl[(size_t)(P + q) * SF] += sum;
          }
          if (p == 0) {
            float sum = 0.0f;
#pragma unroll
            for (int r = 0; r < ROWS; ++r) sum += dg_s[r * G + j];
            db_s[(size_t)l * G + j] += sum;
          }
        }
        for (int base = 0; base < K; base += q_lanes) {
          const int q = base + tid / dparts;
          const bool q_ok = q < K;
          const WT* wq = wl + (size_t)(q_ok ? q : 0) * S;
          float acc[ROWS];
#pragma unroll
          for (int r = 0; r < ROWS; ++r) acc[r] = 0.0f;
          for (int jj = dp; jj < G; jj += dparts) {
            const float wv = static_cast<float>(wq[jj]);
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc[r] = fmaf(dprod[r * G + jj], wv, acc[r]);
          }
          for (int off = 1; off < dparts; off <<= 1) {
#pragma unroll
            for (int r = 0; r < ROWS; ++r)
              acc[r] += __shfl_xor_sync(0xffffffffu, acc[r], off);
          }
          if (q_ok && dp == 0) {
            if (q >= P) {  // -> h_{t-1} of this layer: the dh carry
#pragma unroll
              for (int r = 0; r < ROWS; ++r) dhl[r * H + q - P] = acc[r];
            } else if (l == 0) {  // -> x: dx, straight to device memory
#pragma unroll
              for (int r = 0; r < ROWS; ++r)
                if (r < rows)
                  dx[((long long)(row0 + r) * T + t) * P + q] = acc[r];
            } else if (q < H) {  // -> the layer below's h_t
#pragma unroll
              for (int r = 0; r < ROWS; ++r) di_s[r * H + q] = acc[r];
            }
          }
        }
      }
    }
    __syncthreads();  // this chunk's last reads of its slot before a refill
  }

  // dW and db: this tile's f32 sums, then the fixed-order sum over tiles.
  const int nw = L * K * G;
  const int n_out = nw + L * G;
  if (gridDim.x == 1) {
    for (int i = tid; i < nw; i += nt)
      dw[i] = dw_s[(size_t)(i / G) * SF + i % G];
    for (int i = tid; i < L * G; i += nt) db[i] = db_s[i];
    return;
  }
  float* part = partials + (size_t)blockIdx.x * n_out;
  for (int i = tid; i < nw; i += nt)
    part[i] = dw_s[(size_t)(i / G) * SF + i % G];
  for (int i = tid; i < L * G; i += nt) part[nw + i] = db_s[i];
  __threadfence();
  __syncthreads();
  int* last = reinterpret_cast<int*>(g_s);  // g_s is free from here on
  if (tid == 0) last[0] = atomicAdd(ticket, 1) == (int)gridDim.x - 1;
  __syncthreads();
  if (!last[0]) return;
  __threadfence();
  for (int i = tid; i < n_out; i += nt) {
    float sum = __ldcg(partials + i);
    for (unsigned tile = 1; tile < gridDim.x; ++tile)
      sum += __ldcg(partials + (size_t)tile * n_out + i);
    if (i < nw)
      dw[i] = sum;
    else
      db[i - nw] = sum;
  }
  if (tid == 0) *ticket = 0;  // every block has drawn: ready for the next
}

template <int ROWS, int MAX_T, typename WT>
int launch(const WT* w, const float* scales, const float* b, const float* x,
           const float* c_traj, const float* h_traj, const float* dc,
           const float* dh, float* dw, float* db, float* dx, float* partials,
           int* ticket, int B, int T, int L, int P, int H,
           long long x_stride_b, long long x_stride_t, int time_chunk,
           int parts, int dparts, int threads, long long smem_bytes,
           cudaStream_t stream) {
  static long long configured = 48 * 1024;
  if (smem_bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_bwd_kernel<ROWS, MAX_T, WT>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    configured = smem_bytes;
  }
  const int grid = (B + ROWS - 1) / ROWS;
  lstm_seq_bwd_kernel<ROWS, MAX_T, WT>
      <<<grid, threads, (size_t)smem_bytes, stream>>>(
          w, scales, b, x, c_traj, h_traj, dc, dh, dw, db, dx, partials,
          ticket, B, T, L, P, H, time_chunk, parts, dparts, x_stride_b,
          x_stride_t);
  return (int)cudaGetLastError();
}

// One instance per (tile size, thread bound); another block_b or more than
// 1024 threads is cudaErrorInvalidValue.
template <typename WT>
int launch_tile(const WT* w, const float* scales, const float* b,
                const float* x, const float* c_traj, const float* h_traj,
                const float* dc, const float* dh, float* dw, float* db,
                float* dx, float* partials, int* ticket, int B, int T, int L,
                int P, int H, long long x_stride_b, long long x_stride_t,
                int block_b, int time_chunk, int parts, int dparts,
                int threads, long long smem_bytes, void* stream) {
  if (threads > 1024) return (int)cudaErrorInvalidValue;
#define LSTM_SEQ_BWD_LAUNCH(R)                                               \
  case R:                                                                    \
    return threads <= 512                                                    \
               ? launch<R, 512>(w, scales, b, x, c_traj, h_traj, dc, dh, dw, \
                                db, dx, partials, ticket, B, T, L, P, H,     \
                                x_stride_b, x_stride_t, time_chunk, parts,   \
                                dparts, threads, smem_bytes,                 \
                                (cudaStream_t)stream)                        \
               : launch<R, 1024>(w, scales, b, x, c_traj, h_traj, dc, dh,   \
                                 dw, db, dx, partials, ticket, B, T, L, P,   \
                                 H, x_stride_b, x_stride_t, time_chunk,      \
                                 parts, dparts, threads, smem_bytes,         \
                                 (cudaStream_t)stream);
  switch (block_b) {
    LSTM_SEQ_BWD_LAUNCH(1)
    LSTM_SEQ_BWD_LAUNCH(2)
    LSTM_SEQ_BWD_LAUNCH(4)
    LSTM_SEQ_BWD_LAUNCH(8)
    LSTM_SEQ_BWD_LAUNCH(16)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef LSTM_SEQ_BWD_LAUNCH
}

}  // namespace

extern "C" {

// w (L, P+H, 4H), b (L, 4H), c_traj/h_traj (T, L, B, H), dc/dh (L, B, H),
// dw, db and dx (B, T, P) contiguous f32; x element (b, t, p) at
// x[b * x_stride_b + t * x_stride_t + p].  partials holds
// ceil(B / block_b) x (L (P+H) 4H + L 4H) floats and ticket one int that
// is 0 at the launch and 0 again after it (both unused for one tile): one
// per stream serves every launch on it.  One thread
// block of `threads` (>= parts * 4H, a multiple of 32) threads per batch
// tile of block_b rows (1, 2, 4, 8 or 16); `parts` lanes to a gate column,
// `dparts` (a power of two up to 32) to a row of W in the products;
// smem_bytes is the wrapper's working_set_bytes(mode="bwd") for
// (block_b, time_chunk).  Returns cudaErrorInvalidValue for another
// block_b or more than 1024 threads.
int lstm_seq_bwd_f32(const float* w, const float* b, const float* x,
                     const float* c_traj, const float* h_traj,
                     const float* dc, const float* dh, float* dw, float* db,
                     float* dx, float* partials, int* ticket, int B, int T,
                     int L, int P, int H, long long x_stride_b,
                     long long x_stride_t, int block_b, int time_chunk,
                     int parts, int dparts, int threads, long long smem_bytes,
                     void* stream) {
  return launch_tile<float>(w, nullptr, b, x, c_traj, h_traj, dc, dh, dw, db,
                            dx, partials, ticket, B, T, L, P, H, x_stride_b,
                            x_stride_t, block_b, time_chunk, parts, dparts,
                            threads, smem_bytes, stream);
}

// The int8 plan: wq (L, P+H, 4H) int8 codes the q8 forward ran with and
// their (L, 4H) f32 scales; dw and db are the f32 straight-through
// gradients of the dequantized stack.  Everything else as lstm_seq_bwd_f32
// (smem_bytes is working_set_bytes(mode="bwd", quantized=True)).
int lstm_seq_bwd_q8(const int8_t* wq, const float* scales, const float* b,
                    const float* x, const float* c_traj, const float* h_traj,
                    const float* dc, const float* dh, float* dw, float* db,
                    float* dx, float* partials, int* ticket, int B, int T,
                    int L, int P, int H, long long x_stride_b,
                    long long x_stride_t, int block_b, int time_chunk,
                    int parts, int dparts, int threads, long long smem_bytes,
                    void* stream) {
  return launch_tile<int8_t>(wq, scales, b, x, c_traj, h_traj, dc, dh, dw,
                             db, dx, partials, ticket, B, T, L, P, H,
                             x_stride_b, x_stride_t, block_b, time_chunk,
                             parts, dparts, threads, smem_bytes, stream);
}

const char* lstm_seq_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
