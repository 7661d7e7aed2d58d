// Sequence-resident stacked-LSTM forward, f32, bf16 or int8 weights, f32
// or bf16 input and output, for Hopper (sm_90a).
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
//    Every other shape one block holds (the split home, below the one-block
//    instances, takes the rest) keeps the (L, P+H, 4H) stack in shared
//    memory with rows padded to lstm_gates::row_stride, grouped four rows a
//    column (one float4, or one word of four int8 codes stored as c + 128
//    and converted by an add, not the quarter-rate I2F), columns unit-major
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
//
// bf16 (WT, IO template arguments; the pairs built are f32/f32,
// bf16/bf16, int8/f32 and int8/bf16): a bf16 stack, bias and x are read
// as they are and widened to f32 where they are used (the shared home's
// group of 4 rows of a column is 8 bytes, widened by shifts; the register
// home widens its 64 weights once at load), the x ring holds bf16 (two
// elements a 4-byte cp.async when P and x's rows are even, else copied
// through registers), and every product, the state and the trajectories
// stay f32; only the final (c, h) are written in bf16.  A bf16 value
// widens exactly, so a bf16 instance runs the f32 instance's multiply-add
// chains on the widened values, in lstm_gates.cuh's order.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lstm_gates.cuh"

namespace {

// A shared-home group of 4 rows of one column as f32: a float4, four bf16
// (8 bytes, lstm_gates::load4), or four int8 codes stored as the bytes
// c + 128 of one word, each converted by placing the byte in the mantissa
// of 2^23 and subtracting 2^23 + 128 (exact, an AND/OR and an add at full
// rate, where an int8-to-float conversion runs at a quarter of it on
// Hopper).
__device__ __forceinline__ float4 weight4(const float* p) {
  return lstm_gates::load4(p);
}
__device__ __forceinline__ float4 weight4(const __nv_bfloat16* p) {
  return lstm_gates::load4(p);
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

// Register home: 32 inputs of shared memory (f32 h, or x's type) into
// registers, four at a time (float4 or 8-byte loads).
template <typename V>
__device__ __forceinline__ void reg_load(float (&vv)[kRegH], const V* v) {
#pragma unroll
  for (int i = 0; i < kRegH / 4; ++i) {
    const float4 f = lstm_gates::load4(v + 4 * i);
    vv[4 * i] = f.x;
    vv[4 * i + 1] = f.y;
    vv[4 * i + 2] = f.z;
    vv[4 * i + 3] = f.w;
  }
}

// Shared home: one segment's canonical sum over n rows for the RG tile
// rows r0 .. r0 + RG - 1 of v (f32 h or x's type, row stride vs, a
// multiple of 4), four rows of inputs and of weights a load; wg is the
// lane's column in the segment's first group row, S groups a row.
template <int RG, typename ST, typename V>
__device__ __forceinline__ void shared_segment(float (&out)[RG],
                                               const ST* wg, int S,
                                               const V* v, int vs, int n,
                                               int r0) {
  float acc[4][RG];
  lstm_gates::partial_sums4<RG>(
      acc, n,
      [&](int r, int grp) {
        return lstm_gates::load4(v + (r0 + r) * vs + 4 * grp);
      },
      [&](int grp) { return weight4(wg + (size_t)grp * S * 4); });
  lstm_gates::combine<RG, 1>(out, acc);
}

// Most threads an instance launches with: the register bound of its
// __launch_bounds__ (64 registers a thread at 1024, 128 at 512, 255 at
// 256); the host's fwd_max_threads.
template <int ROWS, bool REG>
__host__ __device__ constexpr int max_threads() {
  return REG ? kRegThreads : (ROWS >= 8 ? 512 : 1024);
}

// Dynamic shared memory of one launch in bytes, the kernel's layout: the
// shared-home stack (L, KG, S, 4) of wb-byte weights (none in registers),
// the f32 h slots (L, 2, rows, H4), the register home's f32 copy of a bf16
// chunk (tc, rows, P4) and the x ring of iob-byte elements (slots, tc,
// rows, P4).  kernels/lstm_seq.py:working_set_bytes(mode="fwd") prices the
// same terms; a launch with any other smem is refused.
__host__ __device__ inline long long fwd_smem_bytes(int T, int L, int P,
                                                    int H, int rows, int tc,
                                                    bool reg, int wb,
                                                    int iob) {
  const long long P4 = (P + 3) / 4 * 4, H4 = (H + 3) / 4 * 4;
  const int G = 4 * H;
  const int S = wb == 4   ? lstm_gates::row_stride<float>(G)
                : wb == 2 ? lstm_gates::row_stride<__nv_bfloat16>(G)
                          : lstm_gates::row_stride<int8_t>(G);
  const long long w = reg ? 0 : L * (P4 + H4) / 4 * S * 4 * wb;
  const int slots = (T + tc - 1) / tc > 1 ? 2 : 1;
  const long long widened = reg && iob == 2 ? (long long)tc * rows * P4 * 4 : 0;
  return w + 2LL * L * rows * H4 * 4 + widened +
         (long long)slots * tc * rows * P4 * iob;
}

// The bias's type: the stack's, f32 beside an int8 stack.
template <typename WT>
using BiasT = typename std::conditional<sizeof(WT) == 1, float, WT>::type;

template <int ROWS, bool TRAJ, typename WT, typename IO, bool REG>
__global__ void __launch_bounds__(max_threads<ROWS, REG>(), 1)
    lstm_seq_fwd_kernel(
        const WT* __restrict__ w, const float* __restrict__ scales,
        const BiasT<WT>* __restrict__ b,
        const IO* __restrict__ x, IO* __restrict__ c_out,
        IO* __restrict__ h_out, float* __restrict__ c_traj,
        float* __restrict__ h_traj, int B, int T, int L, int P, int H, int tc,
        long long x_stride_b, long long x_stride_t) {
  static_assert(!REG || ROWS == 1, "the register instance is one row");
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kQ8 = sizeof(WT) == 1;
  // rows processed together: bounds the accumulators at 8 and 16 rows
  constexpr int RG = ROWS < 8 ? ROWS : 8;
  const int G = 4 * H;
  const int S = lstm_gates::row_stride<WT>(G);  // W row stride in shared mem
  const int K = P + H;
  // h and x rows are padded to whole groups of 4; the shared-home stack
  // holds each segment (the P input rows, the H recurrent rows) in groups
  // of 4 rows, a group of a column being 4 weights side by side
  const int P4 = (P + 3) / 4 * 4;
  const int H4 = (H + 3) / 4 * 4;
  const int KG = (P4 + H4) / 4;  // row groups a layer
  const int nc = (T + tc - 1) / tc;
  const int slots = nc > 1 ? 2 : 1;
  const int slot_elems = tc * ROWS * P4;
  // the shared-home stack: f32, bf16, or each int8 code c as the byte c + 128
  using ST = typename std::conditional<kQ8, uint8_t, WT>::type;
  const size_t w_bytes = REG ? 0 : (size_t)L * KG * S * 4 * sizeof(ST);
  ST* w_s = reinterpret_cast<ST*>(smem);                  // (L, KG, S, 4)
  float* hbuf = reinterpret_cast<float*>(smem + w_bytes);  // (L, 2, ROWS, H4)
  // The register home's layer 0 reads x as f32 rows, four at a load: the
  // ring itself for f32 x, for bf16 x an f32 copy of the current chunk,
  // widened by every thread when the chunk arrives.  (Widened in layer 0's
  // step, next to its loads, bf16 x cost 10% to 17% a wave-step.)
  constexpr bool kWiden = REG && sizeof(IO) == 2;
  float* xf = hbuf + (size_t)L * 2 * ROWS * H4;          // (tc, ROWS, P4)
  IO* ring = reinterpret_cast<IO*>(xf + (kWiden ? slot_elems : 0));
  // ring: (slots, tc, ROWS, P4) in x's type

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
  const float bias = lstm_gates::to_f32(b[layer * G + col]);
  const float scale = kQ8 ? scales[layer * G + col] : 1.0f;

  // Weights: the register instance's 64 a lane (input rows, then the
  // recurrent rows), or the stack into unit-major padded shared rows.
  float wr[REG ? 2 * kRegH : 1] = {};
  if constexpr (REG) {
    const WT* wc = w + (size_t)layer * K * G + col;
#pragma unroll
    for (int q = 0; q < kRegH; ++q) {
      wr[q] = lstm_gates::to_f32(wc[(size_t)q * G]);
      wr[kRegH + q] = lstm_gates::to_f32(wc[(size_t)(P + q) * G]);
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
      else if constexpr (sizeof(WT) == 4)
        __pipeline_memcpy_async(dst, w + i, 4);
      else  // a 2-byte weight: cp.async moves 4, 8 or 16 bytes
        *dst = w[i];
    }
  }
  for (int i = tid; i < L * 2 * ROWS * H4; i += nt) hbuf[i] = 0.0f;

  // bf16 x is copied two elements a 4-byte cp.async when every pair is
  // 4-byte aligned in x and in the ring (P and x's strides even, x
  // aligned), else an element at a time through registers
  const bool pairs = sizeof(IO) == 2 && P % 2 == 0 && x_stride_b % 2 == 0 &&
                     x_stride_t % 2 == 0 &&
                     reinterpret_cast<uintptr_t>(x) % 4 == 0;
  const IO zero = lstm_gates::to_io<IO>(0.0f);
  // Start copying chunk k's (steps, ROWS, P) window into its ring slot.
  auto load_chunk = [&](int k) {
    IO* dst = ring + (size_t)(k % slots) * slot_elems;
    const int t0 = k * tc;
    const int per = sizeof(IO) == 4 || pairs ? 4 / (int)sizeof(IO) : 1;
    const int PQ = P / per;  // pieces a row
    const int n = min(tc, T - t0) * ROWS * PQ;
    for (int i = tid; i < n; i += nt) {
      const int q = (i % PQ) * per;
      const int r = (i / PQ) % ROWS;
      const int s = i / (PQ * ROWS);
      IO* d = dst + (s * ROWS + r) * P4 + q;
      const IO* src = x + (long long)(t0 + s) * x_stride_t +
                      (long long)(row0 + r) * x_stride_b + q;
      if (r >= rows) {
        for (int e = 0; e < per; ++e) d[e] = zero;
      } else if (per * sizeof(IO) == 4) {
        __pipeline_memcpy_async(d, src, 4);
      } else {
        *d = *src;
      }
    }
    __pipeline_commit();
  };

  // Register home: the f32 row of x of step k of the chunk in ring slot
  // `slot`; bf16 x: widen chunk k into its f32 copy.
  auto x_row_f32 = [&](int slot, int k) -> const float* {
    if constexpr (kWiden)
      return xf + (size_t)k * ROWS * P4;
    else
      return reinterpret_cast<const float*>(ring + (size_t)slot * slot_elems +
                                            (size_t)k * ROWS * P4);
  };
  auto widen_chunk = [&](int k) {
    const IO* src = ring + (size_t)(k % slots) * slot_elems;
    const int n = min(tc, T - k * tc) * ROWS * P4;
    for (int i = tid; i < n; i += nt) xf[i] = lstm_gates::to_f32(src[i]);
  };
  // Register home: one segment's canonical sum of a row in registers with
  // the lane's weights wr[woff ..].
  auto reg_segment = [&](const float (&vv)[kRegH], int woff) {
    float out[1];
    lstm_gates::segment_sum<1, 1>(
        out, 0, kRegH, [&](int, int q) { return vv[q]; },
        [&](int q) { return wr[woff + q]; });
    return out[0];
  };
  // Shared home: the lane's column in the first group row of segment seg
  // (0 input, 1 recurrent) of its layer.
  const ST* w_in = w_s + ((size_t)layer * KG * S + pc) * 4;
  const ST* w_rec = w_s + (((size_t)layer * KG + P4 / 4) * S + pc) * 4;

  load_chunk(0);  // the first group also carries the shared-home stack
  if (nc > 1) load_chunk(1);
  __pipeline_wait_prior(nc > 1 ? 1 : 0);
  __syncthreads();
  if constexpr (kWiden) {
    widen_chunk(0);
    __syncthreads();
  }

  // Layer 0's input product of step t, in its lanes' registers: xin
  // holds step t's during wave-step t, and the lanes form step t + 1's
  // from the ring row xrow.  Counters, not divisions, track that row:
  // xk = (t + 1) mod tc, xslot its ring slot, chunk the chunk last waited
  // for.
  float xin[ROWS];
  int xk = tc > 1 ? 1 : 0;
  int xslot = tc > 1 ? 0 : slots - 1;
  int chunk = 0;
  const IO* xrow = ring + (size_t)xslot * slot_elems + (size_t)xk * ROWS * P4;
  const float* xrow_f = x_row_f32(xslot, xk);
  if (layer == 0) {
    if constexpr (REG) {
      float vv[kRegH];
      reg_load(vv, x_row_f32(0, 0));
      xin[0] = reg_segment(vv, 0);
    } else {
#pragma unroll
      for (int r0 = 0; r0 < ROWS; r0 += RG) {
        float out[RG];
        shared_segment<RG>(out, w_in, S, ring, P4, P, r0);
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
      if constexpr (kWiden) {
        widen_chunk(chunk);
        __syncthreads();
      }
    }
    const int t = s - layer;
    if (t >= 0 && t < T) {  // uniform over the warp: a warp is one layer
      const float* h_own = hbuf + ((size_t)layer * 2 + ((t + 1) & 1)) * ROWS * H4;
      float* h_next = hbuf + ((size_t)layer * 2 + (t & 1)) * ROWS * H4;
      float in[ROWS], rec[ROWS];
      if constexpr (REG) {
        // the second segment is the layer below's h_t, or at layer 0
        // x_{t+1} (whose product is next step's input; past T it reads a
        // stale row, never used); for f32 x one instruction stream for
        // every layer, for bf16 x a branch on the (warp-uniform) layer
        const float* below = hbuf + ((size_t)(layer - 1) * 2 + (t & 1)) * H4;
        // both rows' loads go out before the first multiply-add
        float va[kRegH], vb[kRegH];
        reg_load(va, h_own);
        reg_load(vb, layer == 0 ? xrow_f : below);
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
          shared_segment<RG>(rg, w_rec, S, h_own, H4, H, r0);
          if (layer == 0) {
#pragma unroll
            for (int r = 0; r < RG; ++r) ig[r] = xin[r0 + r];
          } else {
            shared_segment<RG>(ig, w_in, S, h_below, H4, H, r0);
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
            shared_segment<RG>(out, w_in, S, xrow, P4, P, r0);
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
    xrow_f = x_row_f32(xslot, xk);
    __syncthreads();
  }

  // The final (c, h), in x's type: c from the owners' registers, h from
  // the last slot.
  const float* h_last = hbuf + ((size_t)layer * 2 + ((T - 1) & 1)) * ROWS * H4;
#pragma unroll
  for (int r = 0; r < ROWS; ++r) {
    if (owner && r < rows) {
      const long long o = ((long long)layer * B + row0 + r) * H + j;
      if (g == 0) c_out[o] = lstm_gates::to_io<IO>(c[r]);
      if (g == 1) h_out[o] = lstm_gates::to_io<IO>(h_last[r * H4 + j]);
    }
  }
}

template <int ROWS, bool TRAJ, typename WT, typename IO, bool REG>
int launch(const WT* w, const float* scales, const BiasT<WT>* b, const IO* x,
           IO* c_out, IO* h_out, float* c_traj, float* h_traj, int B, int T,
           int L, int P, int H, long long x_stride_b, long long x_stride_t,
           int time_chunk, int threads, long long smem_bytes,
           cudaStream_t stream) {
  static long long configured = 48 * 1024;
  if (smem_bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_fwd_kernel<ROWS, TRAJ, WT, IO, REG>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    configured = smem_bytes;
  }
  const int grid = (B + ROWS - 1) / ROWS;
  lstm_seq_fwd_kernel<ROWS, TRAJ, WT, IO, REG>
      <<<grid, threads, (size_t)smem_bytes, stream>>>(
          w, scales, b, x, c_out, h_out, c_traj, h_traj, B, T, L, P, H,
          time_chunk, x_stride_b, x_stride_t);
  return (int)cudaGetLastError();
}

template <int ROWS, bool REG, typename WT, typename IO>
int launch_rows(const WT* w, const float* scales, const BiasT<WT>* b,
                const IO* x, IO* c_out, IO* h_out, float* c_traj,
                float* h_traj, int B, int T, int L, int P, int H,
                long long x_stride_b, long long x_stride_t, int time_chunk,
                int threads, long long smem_bytes, cudaStream_t stream) {
  const int wpl = (H + kUnitsPerWarp - 1) / kUnitsPerWarp;
  if (threads != L * wpl * 32 || threads > max_threads<ROWS, REG>() ||
      (REG && (H != kRegH || P != kRegH)) || time_chunk < 1 ||
      smem_bytes != fwd_smem_bytes(T, L, P, H, ROWS, time_chunk, REG,
                                   (int)sizeof(WT), (int)sizeof(IO)))
    return (int)cudaErrorInvalidValue;
  if (c_traj != nullptr)
    return launch<ROWS, true, WT, IO, REG>(
        w, scales, b, x, c_out, h_out, c_traj, h_traj, B, T, L, P, H,
        x_stride_b, x_stride_t, time_chunk, threads, smem_bytes, stream);
  return launch<ROWS, false, WT, IO, REG>(
      w, scales, b, x, c_out, h_out, nullptr, nullptr, B, T, L, P, H,
      x_stride_b, x_stride_t, time_chunk, threads, smem_bytes, stream);
}

// One instance per tile size and weight home; another block_b, a register
// home at another shape, or a thread count that is not the layers' warps is
// cudaErrorInvalidValue.
template <typename WT, typename IO>
int launch_tile(const WT* w, const float* scales, const BiasT<WT>* b,
                const IO* x, IO* c_out, IO* h_out, float* c_traj,
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

// ---------------------------------------------------------------------------
// The split home: the stack's gate columns over G co-resident blocks.
// ---------------------------------------------------------------------------
// Where one block cannot hold the stack (the f32 2 x 64 stack is 256 KiB,
// 3 x 256 is 6 MiB, against 227 KB a block), the host's table
// (choose_batch_block) splits it over G blocks of ONE cooperative launch,
// grid (G, tiles): block j of a tile owns the whole hidden units [j H/G,
// (j+1) H/G) of every layer, i.e. their four gate columns over all P + H
// rows, so c and the cell update stay in the block.  Its column slice sits
// in shared memory in the shared home's layout (four rows of a column side
// by side, columns unit-major), without the row pad: a warp reads 32
// adjacent groups of one row, whatever the row's length.  The layer
// wavefront is the one-block kernel's: T + L - 1 wave-steps, layer l at
// time s - l, each layer its own warps, lane 4u + g gate g of unit u; a
// layer has rw warps for each 8 of its units, warp i of them taking the
// row groups i, i + rw, ... of the tile.
// What a block cannot see is the h of the other blocks' units: every block
// writes the h of its units to a (tiles, L, 2, bmp, H4) f32 exchange in
// device memory (L2-resident; slot t mod 2, as the one-block kernel's
// shared slots), and ONE grid barrier a wave-step (grid_sync,
// cooperative_groups' grid sync) orders every write of
// wave-step s before every read of wave-step s + 1.  A wave-step begins by
// staging, with every thread of the block, the newest slot of every layer
// (L, bmp, H4) and x_s (bmp, P4, widened to f32) into shared memory, all
// loads in flight at once (read one lane at a time from L2, the sums
// waited on the latency of each group); then a block barrier, and the
// sums read shared memory as the shared home's do.  Each gate sum runs in
// one lane in lstm_gates.cuh's canonical order, on the same f32 values as
// the one-block kernels, so the results are the shared home's to the bit
// at any shape both can run (and the backward's recompute, lstm_seq_bwd.cu's
// split kernel, is this kernel's).  The tile's rows go through the sums RG
// at a time (1 for a one-row tile, else 4; the tile padded to bmp, a
// multiple of RG, in the buffers; rows past B read zero x and are never
// written out).  c of the block's units lives in shared memory, written
// and read by the unit's gate-0 lane only.

// Dynamic shared memory of one split block in bytes, the kernel's layout:
// the column slice (L, KG, 4U, 4) of wb-byte weights, the staged f32 h of
// every layer (L, bmp, H4) and x (bmp, P4), and the f32 c of its units
// (L, bmp, U).  kernels/lstm_seq.py:working_set_bytes(n_blocks=G) prices
// the same terms; a launch with any other smem is refused.
__host__ __device__ inline long long split_smem_bytes(int L, int P, int H,
                                                      int rows, int G,
                                                      int wb) {
  const long long P4 = (P + 3) / 4 * 4, H4 = (H + 3) / 4 * 4;
  const long long U = H / G;
  const int rg = rows == 1 ? 1 : 4;
  const long long bmp = (rows + rg - 1) / rg * rg;
  return L * (P4 + H4) * 4 * U * wb + 4 * (L * bmp * H4 + bmp * P4) +
         L * bmp * U * 4;
}

// Most threads a split block launches with (128 registers a thread): the
// host's SPLIT_MAX_THREADS.
constexpr int kSplitThreads = 512;

// Warps a layer of a split block gives each 8 of its units: as many row
// groups of the tile as the block's kSplitThreads allow (the host's
// split_row_warps).
__host__ __device__ inline int split_row_warps(int L, int H, int G,
                                               int rows) {
  const int rg = rows == 1 ? 1 : 4;
  const int groups = (rows + rg - 1) / rg;
  const int base = L * ((H / G + kUnitsPerWarp - 1) / kUnitsPerWarp);
  return max(1, min(groups, kSplitThreads / (32 * base)));
}

template <int RG, bool TRAJ, typename WT, typename IO>
__global__ void __launch_bounds__(kSplitThreads, 1) lstm_seq_split_kernel(
    const WT* __restrict__ w, const float* __restrict__ scales,
    const BiasT<WT>* __restrict__ b, const IO* __restrict__ x,
    IO* __restrict__ c_out, IO* __restrict__ h_out,
    float* __restrict__ c_traj, float* __restrict__ h_traj, float* hx,
    int B, int T, int L, int P, int H, int bm,
    long long x_stride_b, long long x_stride_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kQ8 = sizeof(WT) == 1;
  using ST = typename std::conditional<kQ8, uint8_t, WT>::type;
  const int G4 = 4 * H;
  const int U = H / gridDim.x;          // units a block owns
  const int j0 = blockIdx.x * U;        // its first unit
  const int SU = 4 * U;                 // its gate columns
  const int K = P + H;
  const int P4 = (P + 3) / 4 * 4;
  const int H4 = (H + 3) / 4 * 4;
  const int KG = (P4 + H4) / 4;
  const int bmp = (bm + RG - 1) / RG * RG;
  ST* w_s = reinterpret_cast<ST*>(smem);                 // (L, KG, SU, 4)
  float* hs = reinterpret_cast<float*>(smem + (size_t)L * KG * SU * 4 *
                                                  sizeof(ST));  // (L, bmp, H4)
  float* xs = hs + (size_t)L * bmp * H4;                 // (bmp, P4)
  float* c_s = xs + (size_t)bmp * P4;                    // (L, bmp, U)

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int wpl = (U + kUnitsPerWarp - 1) / kUnitsPerWarp;  // warps of units
  const int rw = nt / (32 * L * wpl);                       // row warps
  const int warp = tid >> 5;
  const int layer = warp / (wpl * rw);
  const int wr = warp % (wpl * rw);
  const int unit = (wr % wpl) * kUnitsPerWarp + (lane >> 2);
  const int rwi = wr / wpl;  // the warp's first row group
  const int g = lane & 3;
  // lanes past U repeat unit U-1 and write nothing
  const bool owner = unit < U;
  const int u = min(unit, U - 1);
  const int col = g * H + j0 + u;  // the lane's gate column of the stack
  const int pc = u * 4 + g;        // where it sits in a shared row
  const int quad = lane & ~3;
  const bool is_tanh = g == 2;
  const int row0 = blockIdx.y * bm;
  const int rows = min(bm, B - row0);
  const float bias = lstm_gates::to_f32(b[layer * G4 + col]);
  const float scale = kQ8 ? scales[layer * G4 + col] : 1.0f;

  // The block's columns into its slice; c and both h slots of its units
  // zero (slot 1 is h_{-1} of every layer).
  for (int i = tid; i < L * K * SU; i += nt) {
    const int row = i / SU;
    const int cl = i - row * SU;
    const int l = row / K;
    const int q = row - l * K;
    const int qs = q < P ? q : q - P;
    const int grp = (q < P ? 0 : P4 / 4) + qs / 4;
    const WT v = w[((size_t)l * K + q) * G4 + (cl & 3) * H + j0 + (cl >> 2)];
    ST* dst = w_s + (((size_t)l * KG + grp) * SU + cl) * 4 + qs % 4;
    if constexpr (kQ8)
      *dst = static_cast<uint8_t>(v + 128);
    else
      *dst = v;
  }
  for (int i = tid; i < L * bmp * U; i += nt) c_s[i] = 0.0f;
  const size_t slot = (size_t)bmp * H4;                     // one (bmp, H4)
  float* hx_t = hx + (size_t)blockIdx.y * L * 2 * slot;    // (L, 2, bmp, H4)
  for (int i = tid; i < L * 2 * bmp * U; i += nt)
    hx_t[(size_t)(i / U) * H4 + j0 + i % U] = 0.0f;
  lstm_gates::grid_sync();

  const ST* w_in = w_s + ((size_t)layer * KG * SU + pc) * 4;
  const ST* w_rec = w_s + (((size_t)layer * KG + P4 / 4) * SU + pc) * 4;
  float* c_l = c_s + (size_t)layer * bmp * U;
  const float* h_own = hs + (size_t)layer * slot;
  const float* h_below = hs + (size_t)(layer - 1) * slot;
  const long long traj_step = (long long)L * B * H;
  for (int s = 0; s < T + L - 1; ++s) {
    // stage layer l's newest h (h_l[s - 1 - l], slot (s - 1 - l) mod 2:
    // layer l's own h_{t-1} and layer l + 1's input) and x_s
    for (int i = tid; i < L * bmp * H4 / 4; i += nt) {
      const int l = i / (bmp * H4 / 4);
      const size_t e = (size_t)(i - l * (bmp * H4 / 4)) * 4;
      const float4 v = lstm_gates::load4_cg(
          hx_t + ((size_t)l * 2 + ((s - 1 - l) & 1)) * slot + e);
      *reinterpret_cast<float4*>(hs + (size_t)l * slot + e) = v;
    }
    if (s < T) {
      for (int i = tid; i < bmp * P4; i += nt) {
        const int r = i / P4, q = i - r * P4;
        xs[i] = r < rows && q < P
                    ? lstm_gates::to_f32(x[(long long)(row0 + r) * x_stride_b +
                                           (long long)s * x_stride_t + q])
                    : 0.0f;
      }
    }
    __syncthreads();
    const int t = s - layer;
    if (t >= 0 && t < T) {  // uniform over the warp: a warp is one layer
      float* h_next = hx_t + ((size_t)layer * 2 + (t & 1)) * slot;
      for (int r0 = rwi * RG; r0 < bmp; r0 += rw * RG) {
        float rec[RG], in[RG];
        shared_segment<RG>(rec, w_rec, SU, h_own, H4, H, r0);
        if (layer == 0)
          shared_segment<RG>(in, w_in, SU, xs, P4, P, r0);
        else
          shared_segment<RG>(in, w_in, SU, h_below, H4, H, r0);
#pragma unroll
        for (int r = 0; r < RG; ++r) {
          const float a = lstm_gates::activate(
              lstm_gates::preact<WT>(in[r], rec[r], bias, scale), is_tanh);
          const float ig = __shfl_sync(0xffffffffu, a, quad);
          const float fg = __shfl_sync(0xffffffffu, a, quad + 1);
          const float gg = __shfl_sync(0xffffffffu, a, quad + 2);
          const float og = __shfl_sync(0xffffffffu, a, quad + 3);
          const int rr = r0 + r;
          if (owner && g == 0) {
            float* cp = c_l + (size_t)rr * U + u;
            const float cn = fmaf(fg, *cp, ig * gg);
            const float hn = og * lstm_gates::tanh_sig(cn);
            *cp = cn;
            h_next[(size_t)rr * H4 + j0 + u] = hn;
            if (rr < rows) {
              const long long o =
                  ((long long)layer * B + row0 + rr) * H + j0 + u;
              if (TRAJ) {
                c_traj[o + t * traj_step] = cn;
                h_traj[o + t * traj_step] = hn;
              }
              if (t == T - 1) {
                c_out[o] = lstm_gates::to_io<IO>(cn);
                h_out[o] = lstm_gates::to_io<IO>(hn);
              }
            }
          }
        }
      }
    }
    lstm_gates::grid_sync();
  }
}

// One cooperative launch of the split instance: every block of the (G,
// tiles) grid resident at once, or the launch is refused
// (cudaErrorCooperativeLaunchTooLarge) and nothing runs.
template <int RG, bool TRAJ, typename WT, typename IO>
int launch_split_inst(const WT* w, const float* scales, const BiasT<WT>* b,
                      const IO* x, IO* c_out, IO* h_out, float* c_traj,
                      float* h_traj, float* hx, int B, int T, int L,
                      int P, int H, long long x_stride_b,
                      long long x_stride_t, int block_b, int G, int threads,
                      long long smem_bytes, cudaStream_t stream) {
  static long long configured = 48 * 1024;
  if (smem_bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_split_kernel<RG, TRAJ, WT, IO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    configured = smem_bytes;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(G, (B + block_b - 1) / block_b);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = (size_t)smem_bytes;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, lstm_seq_split_kernel<RG, TRAJ, WT, IO>, w, scales, b, x, c_out,
      h_out, c_traj, h_traj, hx, B, T, L, P, H, block_b, x_stride_b,
      x_stride_t);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The split launch's checks and instance: G >= 2 dividing H, the layers'
// warps of H / G units, the table's shared memory; RG 1 for a one-row
// tile, else 4.
template <typename WT, typename IO>
int launch_split(const WT* w, const float* scales, const BiasT<WT>* b,
                 const IO* x, IO* c_out, IO* h_out, float* c_traj,
                 float* h_traj, float* hx, int B, int T, int L, int P,
                 int H, long long x_stride_b, long long x_stride_t,
                 int block_b, int G, int threads, long long smem_bytes,
                 void* stream) {
  if (G < 2 || H % G != 0 || block_b < 1 ||
      threads != L * ((H / G + kUnitsPerWarp - 1) / kUnitsPerWarp) *
                     split_row_warps(L, H, G, block_b) * 32 ||
      threads > kSplitThreads ||
      smem_bytes != split_smem_bytes(L, P, H, block_b, G, (int)sizeof(WT)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define LSTM_SEQ_SPLIT(RG, TRAJ)                                              \
  return launch_split_inst<RG, TRAJ, WT, IO>(                                 \
      w, scales, b, x, c_out, h_out, c_traj, h_traj, hx, B, T, L, P, H,      \
      x_stride_b, x_stride_t, block_b, G, threads, smem_bytes, st)
  if (block_b == 1) {
    if (c_traj != nullptr) LSTM_SEQ_SPLIT(1, true);
    LSTM_SEQ_SPLIT(1, false);
  }
  if (c_traj != nullptr) LSTM_SEQ_SPLIT(4, true);
  LSTM_SEQ_SPLIT(4, false);
#undef LSTM_SEQ_SPLIT
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
// is the wrapper's working_set_bytes for (block_b, time_chunk) and the
// dtypes (fwd_smem_bytes).  Returns cudaErrorInvalidValue for any other
// tiling or shared memory.
int lstm_seq_fwd_f32(const float* w, const float* b, const float* x,
                     float* c_out, float* h_out, float* c_traj,
                     float* h_traj, int B, int T, int L, int P, int H,
                     long long x_stride_b, long long x_stride_t, int block_b,
                     int time_chunk, int reg, int threads,
                     long long smem_bytes, void* stream) {
  return launch_tile<float, float>(
      w, nullptr, b, x, c_out, h_out, c_traj, h_traj, B, T, L, P, H,
      x_stride_b, x_stride_t, block_b, time_chunk, reg, threads, smem_bytes,
      stream);
}

// The bf16 plans: w, b, x, c_out and h_out bf16, the trajectories f32;
// everything else as lstm_seq_fwd_f32 (smem_bytes is working_set_bytes(
// dtype_bytes=2, w_dtype_bytes=2)).
int lstm_seq_fwd_bf16(const __nv_bfloat16* w, const __nv_bfloat16* b,
                      const __nv_bfloat16* x, __nv_bfloat16* c_out,
                      __nv_bfloat16* h_out, float* c_traj, float* h_traj,
                      int B, int T, int L, int P, int H,
                      long long x_stride_b, long long x_stride_t,
                      int block_b, int time_chunk, int reg, int threads,
                      long long smem_bytes, void* stream) {
  return launch_tile<__nv_bfloat16, __nv_bfloat16>(
      w, nullptr, b, x, c_out, h_out, c_traj, h_traj, B, T, L, P, H,
      x_stride_b, x_stride_t, block_b, time_chunk, reg, threads, smem_bytes,
      stream);
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
  return launch_tile<int8_t, float>(
      wq, scales, b, x, c_out, h_out, c_traj, h_traj, B, T, L, P, H,
      x_stride_b, x_stride_t, block_b, time_chunk, reg, threads, smem_bytes,
      stream);
}

// The int8 plan of a bf16 model: as lstm_seq_fwd_q8 (f32 scales and bias)
// with x, c_out and h_out bf16 (smem_bytes is working_set_bytes(
// dtype_bytes=2, quantized=True)).
int lstm_seq_fwd_q8_bf16(const int8_t* wq, const float* scales,
                         const float* b, const __nv_bfloat16* x,
                         __nv_bfloat16* c_out, __nv_bfloat16* h_out,
                         float* c_traj, float* h_traj, int B, int T, int L,
                         int P, int H, long long x_stride_b,
                         long long x_stride_t, int block_b, int time_chunk,
                         int reg, int threads, long long smem_bytes,
                         void* stream) {
  return launch_tile<int8_t, __nv_bfloat16>(
      wq, scales, b, x, c_out, h_out, c_traj, h_traj, B, T, L, P, H,
      x_stride_b, x_stride_t, block_b, time_chunk, reg, threads, smem_bytes,
      stream);
}

// fwd_smem_bytes for a launch of block_b rows, time chunk tc (T for the
// whole sequence), reg the weight home, wb and iob the bytes of a weight
// and of an input element: what kernels/lstm_seq.py's table is held to.
long long lstm_seq_fwd_smem_bytes(int T, int L, int P, int H, int block_b,
                                  int tc, int reg, int wb, int iob) {
  return fwd_smem_bytes(T, L, P, H, block_b, tc, reg != 0, wb, iob);
}

// The split home (kernels/lstm_seq.py weight_home "split"): one
// cooperative launch of G = n_blocks blocks a tile of block_b rows (any
// number), grid (G, ceil(B / block_b)), every block resident at once; G
// divides H and block j of a tile owns units [j H/G, (j+1) H/G) of every
// layer.  hx is the h exchange, ceil(B / block_b) x L x 2 x bmp x H4 f32
// (bmp: block_b rounded up to 1 or 4, H4: H rounded up to 4), 16-byte
// aligned, written and read within the launch.  threads = L x ceil(H /
// G / 8) x split_row_warps warps (the host's split_threads); smem_bytes is
// working_set_bytes(n_blocks=G) (lstm_seq_split_smem_bytes).  Operands,
// dtypes and outputs as lstm_seq_fwd_*: c_traj/h_traj null or the f32
// trajectories.  Returns cudaErrorInvalidValue for another split, thread
// count or shared memory, and the launch's error when the card cannot hold
// every block at once.
int lstm_seq_split_f32(const float* w, const float* b, const float* x,
                       float* c_out, float* h_out, float* c_traj,
                       float* h_traj, float* hx, int B, int T,
                       int L, int P, int H, long long x_stride_b,
                       long long x_stride_t, int block_b, int n_blocks,
                       int threads, long long smem_bytes, void* stream) {
  return launch_split<float, float>(
      w, nullptr, b, x, c_out, h_out, c_traj, h_traj, hx, B, T, L, P, H,
      x_stride_b, x_stride_t, block_b, n_blocks, threads, smem_bytes, stream);
}

int lstm_seq_split_bf16(const __nv_bfloat16* w, const __nv_bfloat16* b,
                        const __nv_bfloat16* x, __nv_bfloat16* c_out,
                        __nv_bfloat16* h_out, float* c_traj, float* h_traj,
                        float* hx, int B, int T, int L, int P,
                        int H, long long x_stride_b, long long x_stride_t,
                        int block_b, int n_blocks, int threads,
                        long long smem_bytes, void* stream) {
  return launch_split<__nv_bfloat16, __nv_bfloat16>(
      w, nullptr, b, x, c_out, h_out, c_traj, h_traj, hx, B, T, L, P, H,
      x_stride_b, x_stride_t, block_b, n_blocks, threads, smem_bytes, stream);
}

int lstm_seq_split_q8(const int8_t* wq, const float* scales, const float* b,
                      const float* x, float* c_out, float* h_out,
                      float* c_traj, float* h_traj, float* hx,
                      int B, int T, int L, int P, int H, long long x_stride_b,
                      long long x_stride_t, int block_b, int n_blocks,
                      int threads, long long smem_bytes, void* stream) {
  return launch_split<int8_t, float>(
      wq, scales, b, x, c_out, h_out, c_traj, h_traj, hx, B, T, L, P, H,
      x_stride_b, x_stride_t, block_b, n_blocks, threads, smem_bytes, stream);
}

int lstm_seq_split_q8_bf16(const int8_t* wq, const float* scales,
                           const float* b, const __nv_bfloat16* x,
                           __nv_bfloat16* c_out, __nv_bfloat16* h_out,
                           float* c_traj, float* h_traj, float* hx,
                           int B, int T, int L, int P, int H,
                           long long x_stride_b, long long x_stride_t,
                           int block_b, int n_blocks, int threads,
                           long long smem_bytes, void* stream) {
  return launch_split<int8_t, __nv_bfloat16>(
      wq, scales, b, x, c_out, h_out, c_traj, h_traj, hx, B, T, L, P, H,
      x_stride_b, x_stride_t, block_b, n_blocks, threads, smem_bytes, stream);
}

// split_smem_bytes of a split launch of block_b rows over G blocks, wb the
// bytes of a weight: what kernels/lstm_seq.py's table is held to.
long long lstm_seq_split_smem_bytes(int L, int P, int H, int block_b, int G,
                                    int wb) {
  return split_smem_bytes(L, P, H, block_b, G, wb);
}

const char* lstm_seq_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
