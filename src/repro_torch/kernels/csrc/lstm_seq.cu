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
// more is the whole-T layout with a single slot.  The TRAJ instance also
// writes every step's post-step f32 (c, h) of every layer into (T, L, B, H)
// trajectories, straight from registers to device memory, for the rows
// below B; nothing else differs, so its final (c, h) equal the plain
// instance's to the bit.  The int8 instances (WT = int8_t) take the stack as
// int8 codes with (L, 4H) f32 scales, folded after the products
// (lstm_gates.cuh); everything after the gate sums is the f32 instance's.
//
// What bounds it on the H100: at the paper's 2 x 32 config, B=1, T=128 one
// forward does about 4.2 MFLOP and reads under 100 KB, which the card could
// do in well under a microsecond.  The bound is the chain of dependent
// steps: each step needs the previous step's h across all hidden units.
//
// Design: a layer wavefront in one persistent thread block per batch tile.
//  * Each layer has its own warps.  At wave-step s, layer l advances time
//    t = s - l, so all layers work at once and the chain is T + L - 1
//    wave-steps (129 at 2 x 32, T=128) instead of T x L layer-steps (256).
//    A layer-step reads h_{l-1}[t] (written by the layer below at wave-step
//    s - 1) and its own h_l[t-1], and writes h_l[t]: h of every layer lives
//    in a 2-slot shared buffer indexed by t mod 2, so ONE block barrier a
//    wave-step orders every dependency (a layer's write to slot t mod 2
//    never meets a read of that slot in the same wave-step).
//  * A warp owns 8 whole hidden units: lane 4u + g computes gate g (i, f,
//    g, o) of unit u, one lane a gate column.  The four activations meet in
//    registers by shuffles within the quad, every lane of the quad forms the
//    cell update, and c stays in a register for the whole sequence; only h
//    goes to shared memory (and, for TRAJ, c and h to device memory).  No
//    gate buffer, no gate/update barrier.
//  * Each segment's sum is four independent fmaf chains (lstm_gates.cuh's
//    canonical order, which the backward's recompute repeats to the bit):
//    a lane's 64 multiply-adds at 2 x 32 are 8 chains of 8, fed by 16
//    float4 loads of h issued before the first of them.  The four gate
//    lanes of a unit compute the same sigmoid (tanh as 2 sigmoid(2v) - 1),
//    so they do not diverge.
//  * Layer 0's input product x_t @ W0[:P] does not wait for h: its lanes
//    compute it for step t + 1 during step t, from the x ring, in the same
//    instruction stream as the layers above (whose second segment is the
//    layer below's h), so it is off the chain.  Ring slots and rows are
//    tracked by counters: an integer division per step costs as much as a
//    sigmoid on this chain.
//  * Weight home, chosen by the host's budget table (weight_home): the
//    register instance (REG: H = P = 32, at most 2 layers, one row a block:
//    the paper's config at B=1 serving and B=64 training) holds each lane's
//    64 weights, int8 codes converted once to their exact f32 values, in
//    registers; the block is 128 threads a layer and nothing but h and the
//    x ring is in shared memory.  (The codes are not kept packed 4 to a
//    register: I2F runs at a quarter of the FMA rate on Hopper, so
//    converting 64 codes a step would cost more than the multiply-adds.)
//    Every other shape keeps the (L, P+H, 4H) stack in shared memory with
//    rows padded to lstm_gates::row_stride, grouped four rows a column
//    (one float4, or one word of four int8 codes stored as c + 128 and
//    converted by an add, not the quarter-rate I2F), columns unit-major
//    (gate g of unit j at j * 4 + g), so a warp reads 32 adjacent groups;
//    h and x rows are padded to whole float4s, so a lane reads four rows
//    of weights and of inputs a load (lstm_gates::partial_sums4, the same
//    order).  Bias and scale live in each lane's registers.
// What is left on the chain, a wave-step at 2 x 32: the loads and the
// multiply-adds (about half of it), the gate sigmoid, the quad's shuffles,
// the cell update's tanh, the store of h and the barrier.  Two lanes a
// column (half the multiply-adds a lane, twice the warps) measured slower,
// and the fast __expf/__fdividef forms no faster: MUFU latency, not the
// Newton steps, sets the sigmoid's time.
// The ring is filled with cp.async, chunk k+1 while chunk k computes.  Rows
// of a batch tail past B are zero in the ring and never written.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lstm_gates.cuh"

namespace {

// A shared-home group of 4 rows of one column as f32: a float4, or four
// int8 codes stored as the bytes c + 128 of one word, each converted by
// placing the byte in the mantissa of 2^23 and subtracting 2^23 + 128
// (exact, an AND/OR and an add at full rate, where an int8-to-float
// conversion runs at a quarter of it on Hopper).
__device__ __forceinline__ float4 weight4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 weight4(const uint8_t* p) {
  const uint32_t w = *reinterpret_cast<const uint32_t*>(p);
  auto code = [](uint32_t b) {
    return __uint_as_float(0x4B000000u | b) - 8388736.0f;
  };
  return make_float4(code(w & 0xffu), code(w >> 8 & 0xffu),
                     code(w >> 16 & 0xffu), code(w >> 24));
}

constexpr int kUnitsPerWarp = 8;  // 8 hidden units x 4 gates = 32 lanes
constexpr int kRegH = 32;         // H (= P) of the register instance
constexpr int kRegThreads = 256;  // its block: at most 2 layers of 4 warps

// Most threads an instance launches with: the register bound of its
// __launch_bounds__ (64 registers a thread at 1024, 128 at 512, 255 at
// 256); the host's fwd_max_threads.
template <int ROWS, bool REG>
__host__ __device__ constexpr int max_threads() {
  return REG ? kRegThreads : (ROWS >= 8 ? 512 : 1024);
}

template <int ROWS, bool TRAJ, typename WT, bool REG>
__global__ void __launch_bounds__(max_threads<ROWS, REG>(), 1)
    lstm_seq_fwd_kernel(const WT* __restrict__ w,
                        const float* __restrict__ scales,
                        const float* __restrict__ b,
                        const float* __restrict__ x,
                        float* __restrict__ c_out, float* __restrict__ h_out,
                        float* __restrict__ c_traj,
                        float* __restrict__ h_traj, int B, int T, int L,
                        int P, int H, int tc, long long x_stride_b,
                        long long x_stride_t) {
  static_assert(!REG || ROWS == 1, "the register instance is one row");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kQ8 = sizeof(WT) == 1;
  // rows processed together: bounds the accumulators at 8 and 16 rows
  constexpr int RG = ROWS < 8 ? ROWS : 8;
  const int G = 4 * H;
  const int S = lstm_gates::row_stride<WT>(G);  // W row stride in shared mem
  const int K = P + H;
  // h and x rows are padded to whole float4s; the shared-home stack holds
  // each segment (the P input rows, the H recurrent rows) in groups of 4
  // rows, a group of a column being one float4 or one 32-bit word
  const int P4 = (P + 3) / 4 * 4;
  const int H4 = (H + 3) / 4 * 4;
  const int KG = (P4 + H4) / 4;  // row groups a layer
  const int nc = (T + tc - 1) / tc;
  const int slots = nc > 1 ? 2 : 1;
  const int slot_elems = tc * ROWS * P4;
  // the shared-home stack: f32, or each int8 code c as the byte c + 128
  using ST = typename std::conditional<kQ8, uint8_t, float>::type;
  const size_t w_bytes = REG ? 0 : (size_t)L * KG * S * 4 * sizeof(ST);
  ST* w_s = reinterpret_cast<ST*>(smem);                  // (L, KG, S, 4)
  float* hbuf = reinterpret_cast<float*>(smem + w_bytes);  // (L, 2, ROWS, H4)
  float* ring = hbuf + (size_t)L * 2 * ROWS * H4;    // (slots, tc, ROWS, P4)

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int wpl = (H + kUnitsPerWarp - 1) / kUnitsPerWarp;  // warps a layer
  const int layer = (tid >> 5) / wpl;
  const int unit = ((tid >> 5) % wpl) * kUnitsPerWarp + (lane >> 2);
  const int g = lane & 3;
  // lanes past H (H not a multiple of 8) repeat unit H-1 and write nothing
  const bool owner = unit < H;
  const int j = min(unit, H - 1);
  const int col = g * H + j;  // the lane's gate column
  const int pc = j * 4 + g;   // where that column sits in a shared row
  const int quad = lane & ~3;
  const bool is_tanh = g == 2;  // gate order i, f, g, o
  const int row0 = blockIdx.x * ROWS;
  const int rows = min(ROWS, B - row0);
  const float bias = b[layer * G + col];
  const float scale = kQ8 ? scales[layer * G + col] : 1.0f;

  // Weights: the register instance's 64 a lane (input rows, then the
  // recurrent rows), or the stack into unit-major padded shared rows.
  float wr[REG ? 2 * kRegH : 1] = {};
  if constexpr (REG) {
    const WT* wc = w + (size_t)layer * K * G + col;
#pragma unroll
    for (int q = 0; q < kRegH; ++q) {
      wr[q] = static_cast<float>(wc[(size_t)q * G]);
      wr[kRegH + q] = static_cast<float>(wc[(size_t)(P + q) * G]);
    }
  } else {
    for (int i = tid; i < L * K * G; i += nt) {
      const int row = i / G;
      const int c = i - row * G;
      const int l = row / K;
      const int q = row - l * K;
      const int qs = q < P ? q : q - P;                 // row of its segment
      const int grp = (q < P ? 0 : P4 / 4) + qs / 4;
      ST* dst = w_s + (((size_t)l * KG + grp) * S + (c % H) * 4 + c / H) * 4 +
                qs % 4;
      if constexpr (kQ8)
        *dst = static_cast<uint8_t>(w[i] + 128);
      else
        __pipeline_memcpy_async(dst, w + i, 4);
    }
  }
  for (int i = tid; i < L * 2 * ROWS * H4; i += nt) hbuf[i] = 0.0f;

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
            dst + (s * ROWS + r) * P4 + q,
            x + (long long)(t0 + s) * x_stride_t +
                (long long)(row0 + r) * x_stride_b + q,
            4);
      } else {
        dst[(s * ROWS + r) * P4 + q] = 0.0f;
      }
    }
    __pipeline_commit();
  };

  // Register home: 32 floats of shared memory into registers (float4
  // loads), and one segment's canonical sum of such a row with the lane's
  // weights wr[woff ..].
  auto reg_load = [&](float (&vv)[kRegH], const float* v) {
    const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll
    for (int i = 0; i < kRegH / 4; ++i) {
      const float4 f = v4[i];
      vv[4 * i] = f.x;
      vv[4 * i + 1] = f.y;
      vv[4 * i + 2] = f.z;
      vv[4 * i + 3] = f.w;
    }
  };
  auto reg_segment = [&](const float (&vv)[kRegH], int woff) {
    float out[1];
    lstm_gates::segment_sum<1, 1>(
        out, 0, kRegH, [&](int, int q) { return vv[q]; },
        [&](int q) { return wr[woff + q]; });
    return out[0];
  };
  // Shared home: segment seg's (0 input, 1 recurrent) canonical sum over
  // n rows for tile rows r0 .. r0 + RG - 1, v (ROWS, n) floats with row
  // stride vs (a multiple of 4), four rows of inputs and of weights a load.
  auto shared_segment = [&](float (&out)[RG], const float* v, int vs, int n,
                            int r0, int seg) {
    const ST* wg =
        w_s + (((size_t)layer * KG + (seg ? P4 / 4 : 0)) * S + pc) * 4;
    float acc[4][RG];
    lstm_gates::partial_sums4<RG>(
        acc, n,
        [&](int r, int grp) {
          return *reinterpret_cast<const float4*>(v + (r0 + r) * vs + 4 * grp);
        },
        [&](int grp) { return weight4(wg + (size_t)grp * S * 4); });
    lstm_gates::combine<RG, 1>(out, acc);
  };

  load_chunk(0);  // the first group also carries the shared-home stack
  if (nc > 1) load_chunk(1);
  __pipeline_wait_prior(nc > 1 ? 1 : 0);
  __syncthreads();

  // Layer 0's input product of step t, in its lanes' registers: xin
  // holds step t's during wave-step t, and the lanes form step t + 1's
  // from the ring row xrow.  Counters, not divisions, track that row:
  // xk = (t + 1) mod tc, xslot its ring slot, chunk the chunk last waited
  // for.
  float xin[ROWS];
  int xk = tc > 1 ? 1 : 0;
  int xslot = tc > 1 ? 0 : slots - 1;
  int chunk = 0;
  const float* xrow = ring + (size_t)xslot * slot_elems + (size_t)xk * ROWS * P4;
  if (layer == 0) {
    if constexpr (REG) {
      float vv[kRegH];
      reg_load(vv, ring);
      xin[0] = reg_segment(vv, 0);
    } else {
#pragma unroll
      for (int r0 = 0; r0 < ROWS; r0 += RG) {
        float out[RG];
        shared_segment(out, ring, P4, P, r0, 0);
#pragma unroll
        for (int r = 0; r < RG; ++r) xin[r0 + r] = out[r];
      }
    }
  }

  float c[ROWS];
#pragma unroll
  for (int r = 0; r < ROWS; ++r) c[r] = 0.0f;
  // (t, layer, row0 + r, j) of the (T, L, B, H) trajectories
  const long long traj_step = (long long)L * B * H;
  const long long traj_base = ((long long)layer * B + row0) * H + j;
  for (int s = 0; s < T + L - 1; ++s) {
    // layer 0 reads x[s + 1] this wave-step: its chunk must be in the ring
    if (s + 1 < T && xk == 0) {
      ++chunk;
      __pipeline_wait_prior(0);
      __syncthreads();
      // chunk + 1 refills the slot of chunk - 1, last read at s - 1
      if (chunk + 1 < nc) load_chunk(chunk + 1);
    }
    const int t = s - layer;
    if (t >= 0 && t < T) {  // uniform over the warp: a warp is one layer
      const float* h_own = hbuf + ((size_t)layer * 2 + ((t + 1) & 1)) * ROWS * H4;
      float* h_next = hbuf + ((size_t)layer * 2 + (t & 1)) * ROWS * H4;
      float in[ROWS], rec[ROWS];
      if constexpr (REG) {
        // one instruction stream for every layer: the second segment is
        // the layer below's h_t, or at layer 0 x_{t+1} (whose product is
        // next step's input; past T it reads a stale row, never used)
        const float* second =
            layer == 0 ? xrow
                       : hbuf + ((size_t)(layer - 1) * 2 + (t & 1)) * H4;
        // both rows' 16 loads go out before the first multiply-add
        float va[kRegH], vb[kRegH];
        reg_load(va, h_own);
        reg_load(vb, second);
        rec[0] = reg_segment(va, kRegH);
        const float other = reg_segment(vb, 0);
        in[0] = layer == 0 ? xin[0] : other;
        if (layer == 0) xin[0] = other;
      } else {
        const float* h_below =
            hbuf + ((size_t)(layer - 1) * 2 + (t & 1)) * ROWS * H4;
#pragma unroll
        for (int r0 = 0; r0 < ROWS; r0 += RG) {
          float rg[RG], ig[RG];
          shared_segment(rg, h_own, H4, H, r0, 1);
          if (layer == 0) {
#pragma unroll
            for (int r = 0; r < RG; ++r) ig[r] = xin[r0 + r];
          } else {
            shared_segment(ig, h_below, H4, H, r0, 0);
          }
#pragma unroll
          for (int r = 0; r < RG; ++r) {
            rec[r0 + r] = rg[r];
            in[r0 + r] = ig[r];
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float a = lstm_gates::activate(
            lstm_gates::preact<WT>(in[r], rec[r], bias, scale), is_tanh);
        const float ig = __shfl_sync(0xffffffffu, a, quad);
        const float fg = __shfl_sync(0xffffffffu, a, quad + 1);
        const float gg = __shfl_sync(0xffffffffu, a, quad + 2);
        const float og = __shfl_sync(0xffffffffu, a, quad + 3);
        const float cn = fmaf(fg, c[r], ig * gg);
        const float hn = og * lstm_gates::tanh_sig(cn);
        c[r] = cn;
        if (owner && g == 0) h_next[r * H4 + j] = hn;
        if (TRAJ && owner && r < rows) {
          const long long o = traj_base + t * traj_step + r * H;
          if (g == 0) c_traj[o] = cn;
          if (g == 1) h_traj[o] = hn;
        }
      }
      if constexpr (!REG) {
        if (layer == 0 && t + 1 < T) {
#pragma unroll
          for (int r0 = 0; r0 < ROWS; r0 += RG) {
            float out[RG];
            shared_segment(out, xrow, P4, P, r0, 0);
#pragma unroll
            for (int r = 0; r < RG; ++r) xin[r0 + r] = out[r];
          }
        }
      }
    }
    if (++xk == tc) {
      xk = 0;
      xslot ^= slots - 1;
    }
    xrow = ring + (size_t)xslot * slot_elems + (size_t)xk * ROWS * P4;
    __syncthreads();
  }

  // The final (c, h): c from the owners' registers, h from the last slot.
  const float* h_last = hbuf + ((size_t)layer * 2 + ((T - 1) & 1)) * ROWS * H4;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (owner && r < rows) {
      const long long o = ((long long)layer * B + row0 + r) * H + j;
      if (g == 0) c_out[o] = c[r];
      if (g == 1) h_out[o] = h_last[r * H4 + j];
    }
  }
}

template <int ROWS, bool TRAJ, typename WT, bool REG>
int launch(const WT* w, const float* scales, const float* b, const float* x,
           float* c_out, float* h_out, float* c_traj, float* h_traj, int B,
           int T, int L, int P, int H, long long x_stride_b,
           long long x_stride_t, int time_chunk, int threads,
           long long smem_bytes, cudaStream_t stream) {
  static long long configured = 48 * 1024;
  if (smem_bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_fwd_kernel<ROWS, TRAJ, WT, REG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    configured = smem_bytes;
  }
  const int grid = (B + ROWS - 1) / ROWS;
  lstm_seq_fwd_kernel<ROWS, TRAJ, WT, REG>
      <<<grid, threads, (size_t)smem_bytes, stream>>>(
          w, scales, b, x, c_out, h_out, c_traj, h_traj, B, T, L, P, H,
          time_chunk, x_stride_b, x_stride_t);
  return (int)cudaGetLastError();
}

template <int ROWS, bool REG, typename WT>
int launch_rows(const WT* w, const float* scales, const float* b,
                const float* x, float* c_out, float* h_out, float* c_traj,
                float* h_traj, int B, int T, int L, int P, int H,
                long long x_stride_b, long long x_stride_t, int time_chunk,
                int threads, long long smem_bytes, cudaStream_t stream) {
  const int wpl = (H + kUnitsPerWarp - 1) / kUnitsPerWarp;
  if (threads != L * wpl * 32 || threads > max_threads<ROWS, REG>() ||
      (REG && (H != kRegH || P != kRegH)))
    return (int)cudaErrorInvalidValue;
  if (c_traj != nullptr)
    return launch<ROWS, true, WT, REG>(w, scales, b, x, c_out, h_out, c_traj,
                                       h_traj, B, T, L, P, H, x_stride_b,
                                       x_stride_t, time_chunk, threads,
                                       smem_bytes, stream);
  return launch<ROWS, false, WT, REG>(w, scales, b, x, c_out, h_out, nullptr,
                                      nullptr, B, T, L, P, H, x_stride_b,
                                      x_stride_t, time_chunk, threads,
                                      smem_bytes, stream);
}

// One instance per tile size and weight home; another block_b, a register
// home at another shape, or a thread count that is not the layers' warps is
// cudaErrorInvalidValue.
template <typename WT>
int launch_tile(const WT* w, const float* scales, const float* b,
                const float* x, float* c_out, float* h_out, float* c_traj,
                float* h_traj, int B, int T, int L, int P, int H,
                long long x_stride_b, long long x_stride_t, int block_b,
                int time_chunk, int reg, int threads, long long smem_bytes,
                void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (reg) {
    if (block_b != 1) return (int)cudaErrorInvalidValue;
    return launch_rows<1, true>(w, scales, b, x, c_out, h_out, c_traj,
                                h_traj, B, T, L, P, H, x_stride_b,
                                x_stride_t, time_chunk, threads, smem_bytes,
                                st);
  }
#define LSTM_SEQ_LAUNCH(R)                                                 \
  case R:                                                                  \
    return launch_rows<R, false>(w, scales, b, x, c_out, h_out, c_traj,    \
                                 h_traj, B, T, L, P, H, x_stride_b,        \
                                 x_stride_t, time_chunk, threads,          \
                                 smem_bytes, st);
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
// `threads` = L x ceil(H / 8) warps per batch tile of block_b rows (1, 2, 4,
// 8 or 16); `reg` names the weight home (the wrapper's weight_home): 1 for
// the register instance (block_b 1, H = P = 32, at most 256 threads), 0 for
// the shared one (at most 1024 threads, 512 at 8 and 16 rows); smem_bytes
// is the wrapper's working_set_bytes for (block_b, time_chunk).  Returns
// cudaErrorInvalidValue for any other tiling.
int lstm_seq_fwd_f32(const float* w, const float* b, const float* x,
                     float* c_out, float* h_out, float* c_traj,
                     float* h_traj, int B, int T, int L, int P, int H,
                     long long x_stride_b, long long x_stride_t, int block_b,
                     int time_chunk, int reg, int threads,
                     long long smem_bytes, void* stream) {
  return launch_tile<float>(w, nullptr, b, x, c_out, h_out, c_traj, h_traj,
                            B, T, L, P, H, x_stride_b, x_stride_t, block_b,
                            time_chunk, reg, threads, smem_bytes, stream);
}

// The int8 plan: wq (L, P+H, 4H) int8 codes and scales (L, 4H) f32, the
// stack's weight being wq * scales[l, j]; everything else as
// lstm_seq_fwd_f32 (smem_bytes is working_set_bytes(quantized=True)).
int lstm_seq_fwd_q8(const int8_t* wq, const float* scales, const float* b,
                    const float* x, float* c_out, float* h_out,
                    float* c_traj, float* h_traj, int B, int T, int L, int P,
                    int H, long long x_stride_b, long long x_stride_t,
                    int block_b, int time_chunk, int reg, int threads,
                    long long smem_bytes, void* stream) {
  return launch_tile<int8_t>(wq, scales, b, x, c_out, h_out, c_traj, h_traj,
                             B, T, L, P, H, x_stride_b, x_stride_t, block_b,
                             time_chunk, reg, threads, smem_bytes, stream);
}

const char* lstm_seq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
