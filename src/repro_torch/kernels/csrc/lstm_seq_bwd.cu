// Sequence-resident stacked-LSTM backward (the whole BPTT sweep), f32,
// bf16 or int8 weights, f32 or bf16 input, for Hopper (sm_90a).
//
// Replaces four Pallas kernels of the JAX package's kernels/lstm_seq_bwd.py:
// _seq_bwd_kernel (launched by _lstm_seq_bwd_call, x and both trajectories
// resident) and _seq_bwd_chunked_kernel (launched by
// _lstm_seq_bwd_chunked_call, x and the trajectories streamed in reverse
// chunk order), and their int8-weight bodies _seq_bwd_q8_kernel and
// _seq_bwd_chunked_q8_kernel (the fused_seq_q8 plan's training backward).
// Here they are one source with two kernels, one per weight home (below):
// x and the trajectories always stream through a shared-memory ring read
// from the last step to the first, so the whole-T and the chunked layouts
// are one code path.  The unwind arithmetic does not depend on the
// chunking, so every time_chunk gives bit-identical gradients.
//
// Inputs: w (L, P+H, 4H), b (L, 4H), x (B, T, P) read through its strides,
// the forward's post-step f32 trajectories c_traj, h_traj (T, L, B, H) and
// the final-state cotangents dc, dh (L, B, H).  Outputs: dw (L, P+H, 4H),
// db (L, 4H) and dx (B, T, P), all f32.
//
// bf16 (WT, IO template arguments; the pairs built are f32/f32,
// bf16/bf16, int8/f32 and int8/bf16): a bf16 stack, bias, x and
// cotangents are widened to f32 as they are read (x as it is copied into
// the ring, which stays f32), the trajectories are f32, every sum is f32,
// and dx and a bf16 stack's dw and db are rounded to bf16 once, as they
// are written (an int8 stack's stay f32).  The recompute runs on the same
// widened values as K2t's bf16 instance, in the same order, so it is K2t's
// to the bit.
//
// Int8 weights (WT = int8_t): w is the int8 stack the q8 forward ran with
// and scales (L, 4H) its f32 per-column scales, held beside the bias; the
// weight the forward used is wq * s.  The recompute (a) is the q8 forward's
// gate pass, scale fold included, so it stays bit-identical to it.  dW and
// db (c) take the UNSCALED dg: that is the straight-through gradient with
// respect to the dequantized weights, accumulated and written in f32 for
// the f32 master stack.  Only the outgoing products take the scale:
// dh_prev = (dg * s) W[P:]^T and dinp = (dg * s) W[:P]^T, as the JAX
// package's _unwind_step does, through a second (ROWS, 4H) buffer filled
// with dg * s beside dg -- scaling dg in place would scale dW and db too.
//
// What bounds it on the H100: like the forward, the chain of dependent
// steps, not FLOPs or bytes: at the paper's 2 x 32, B=64, T=128 the sweep
// does about 3x the forward's 4.2 MFLOP per row and moves a few MB.  Of a
// layer-step only the gate gradients dg (elementwise) and the two products
// dh_prev = dg W[P:]^T and dinp = dg W[:P]^T feed the next layer-step; the
// gate recompute reads only the trajectories, and dW and db feed nothing
// until the end.
//
// Two one-block weight homes, as in the forward (the host's weight_home;
// its third, the split home over co-resident blocks, is the kernel at the
// end of this file):
//
// Register home (lstm_seq_bwd_wave_kernel: H = P = 32, at most 2 layers,
// one row a block -- the paper's width trained at batch 64): a layer
// wavefront mirrored from the forward's.  In wave-step s layer l unwinds
// step t = T-1-(s-(L-1-l)), so the chain is T + L - 1 wave-steps (129 at
// 2 x 32, T=128) instead of T x L layer-steps, and only the chain is in
// the chain.  Each layer has two roles of four warps:
//  * chain warps: lane (unit u, gate g) forms dg of its gate column and
//    the unit's dc carry (in a register) from the activations, the carries
//    and the trajectories; the layer's chain warps meet at a named barrier
//    (bar.sync 1 + l, 128 threads), then lane (row q, half p) sums half of
//    q's 4H products with the 64 weights of its half-row, which it keeps
//    in registers for the whole launch, the halves meet by one shuffle,
//    and q's sum goes to dh_prev (the layer's own carry), to dinp (the
//    layer below's) or, at layer 0, to dx;
//  * worker warps: lane j (a gate column) recomputes the gates of the step
//    the chain takes next from its column's 64 weights in registers, with
//    lstm_gates.cuh's canonical order, so they are K2t's to the bit.
// Everything a wave-step hands on (activations, dg, dh_prev, dinp) lives
// in two slots by wave-step parity, so one block barrier a wave-step
// orders every dependency.  dW and db feed nothing in the sweep: the chain
// lanes also write each step's dg to a workspace (L2-resident), and after
// the sweep every lane sums dW[l][k][j] = sum_t v_t[k] dg_t[j] (v the
// layer's input and previous h) and db over t from T-1 down to 0, for
// 32 rows of one column, from that workspace and the trajectories, staged
// through shared memory 32 steps at a time.  (Summed during the sweep,
// dW cost no time of its own but its loads slowed the chain: 1.3 against
// 0.85 us a wave-step.)  The trajectories and x stream through a ring of
// 16 rows (one row a time step, (c, h) of every layer and x), filled by
// the workers with cp.async 8 wave-steps ahead; the ring does not depend
// on time_chunk, so no chunking changes a result.
//
// Shared home (lstm_seq_bwd_kernel: every other shape): one persistent
// thread block per batch tile unwinds the whole T x L recurrence in one
// launch, time backwards and layers top-down, with the (L, P+H, 4H) weight
// stack resident in shared memory and the (dc, dh) carries in f32 shared
// memory.  Per layer-step:
//  (a) recompute the gates with lstm_gates.cuh's segment sums, preact and
//      activate, the functions the forward runs, in their canonical order
//      (recompute_gates), on the same f32 inputs read back from the
//      trajectories, so the recomputed activations are the forward's to the
//      bit; barrier;
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
// dW and db across batch tiles (close_sums, both homes): blocks run in
// parallel and in no order, and float atomics would make the sum differ
// run to run.  So each block writes its f32 partial to a workspace and
// draws an integer ticket of its group of kGroup tiles (__threadfence,
// then atomicAdd); the last of a group sums the group's partials in tile
// order into a group partial and draws the top ticket, and the last group
// sums the group partials in group order into dw and db.  Each last block
// resets its ticket to 0 for the stream's next launch (the wrapper keeps
// one set of tickets a stream, so launches on two streams never share
// one).  At 64 tiles the last block reads 16 partials instead of 64 (the
// flat sum took 70 us of a 0.71 ms launch), results stay identical run to
// run, and a single tile writes dw and db directly.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#include "lstm_gates.cuh"

namespace {

constexpr int kGroup = 8;  // tiles a group of the closing sum

// The closing sum of dW and db over the launch's tiles (see the top of the
// file).  Each block has written its n_out-float partial at partials +
// blockIdx.x * n_out (dw's nw floats, then db's); the group partials
// follow the tiles' at partials + gridDim.x * n_out.  Every thread of the
// block calls it.
template <typename OT>
__device__ __forceinline__ void close_sums(float* partials, int* tickets,
                                           int n_out, int nw, OT* dw,
                                           OT* db, int tid, int nt) {
  __shared__ int last_flag;
  const int tiles = gridDim.x;
  const int groups = (tiles + kGroup - 1) / kGroup;
  const int grp = blockIdx.x / kGroup;
  const int first = grp * kGroup;
  const int in_group = min(kGroup, tiles - first);
  float* group_parts = partials + (size_t)tiles * n_out;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_flag = atomicAdd(tickets + grp, 1) == in_group - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  // the group's tiles in tile order; straight out when it is the only group
  float* gout = group_parts + (size_t)grp * n_out;
  for (int e = tid; e < n_out; e += nt) {
    float sum = __ldcg(partials + (size_t)first * n_out + e);
    for (int k = 1; k < in_group; ++k)
      sum += __ldcg(partials + (size_t)(first + k) * n_out + e);
    if (groups > 1)
      gout[e] = sum;
    else if (e < nw)
      dw[e] = lstm_gates::to_io<OT>(sum);
    else
      db[e - nw] = lstm_gates::to_io<OT>(sum);
  }
  if (tid == 0) tickets[grp] = 0;  // the group has drawn: ready for the next
  if (groups == 1) return;
  __threadfence();
  __syncthreads();
  if (tid == 0) last_flag = atomicAdd(tickets + groups, 1) == groups - 1;
  __syncthreads();
  if (!last_flag) return;
  __threadfence();
  for (int e = tid; e < n_out; e += nt) {
    float sum = __ldcg(group_parts + e);
    for (int k = 1; k < groups; ++k)
      sum += __ldcg(group_parts + (size_t)k * n_out + e);
    if (e < nw)
      dw[e] = lstm_gates::to_io<OT>(sum);
    else
      db[e - nw] = lstm_gates::to_io<OT>(sum);
  }
  if (tid == 0) tickets[groups] = 0;
}

// Step (a): lane (j, p) of PARTS lanes a column writes the forward's
// activated gate of column j for the tile's ROWS rows to g_s (ROWS, 4H):
// the input segment (inp (ROWS, in_w) @ W[:in_w]) and the recurrent one
// (h (ROWS, H) @ W[P:]) in lstm_gates.cuh's canonical order, combined over
// the PARTS lanes by shuffle, then the bias (or scale and bias) and the
// gate's sigmoid or tanh.  wl and wh point at column j of the layer's
// input and recurrent rows, row stride S.  Every lane of the warp calls it
// (the shuffles need all 32); only active lanes with p = 0 write.
template <int ROWS, int PARTS, typename WT>
__device__ __forceinline__ void recompute_gates(
    const float* inp, int in_w, const float* h, int H, const WT* wl,
    const WT* wh, int S, float bj, float sj, int j, int p, bool active,
    bool is_tanh, float* g_s) {
  float in_s[ROWS], rec_s[ROWS];
  lstm_gates::segment_sum<ROWS, PARTS>(
      in_s, p, in_w, [&](int r, int q) { return inp[r * in_w + q]; },
      [&](int q) { return lstm_gates::to_f32(wl[(size_t)q * S]); });
  lstm_gates::segment_sum<ROWS, PARTS>(
      rec_s, p, H, [&](int r, int q) { return h[r * H + q]; },
      [&](int q) { return lstm_gates::to_f32(wh[(size_t)q * S]); });
  if (active && p == 0) {
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
      g_s[r * 4 * H + j] = lstm_gates::activate(
          lstm_gates::preact<WT>(in_s[r], rec_s[r], bj, sj), is_tanh);
  }
}

// Dynamic shared memory of one shared-home launch in bytes, the kernel's
// layout (below): the stack (L, K, S) of wb-byte weights, then f32 bias,
// scales (int8), the x ring (slots, tc, rows, P), the dc and dh carries,
// the gate buffer, the dW/db accumulators (rows of the f32 stride), the two
// trajectory windows (slots, tc + 1, L, rows, H), dg, dinp and dg * s
// (int8).  kernels/lstm_seq.py:working_set_bytes(mode="bwd") prices the
// same terms; a launch with any other smem is refused.
__host__ __device__ inline long long bwd_smem_bytes(int T, int L, int P,
                                                    int H, int rows, int tc,
                                                    int wb) {
  const int G = 4 * H, K = P + H;
  const int S = wb == 4   ? lstm_gates::row_stride<float>(G)
                : wb == 2 ? lstm_gates::row_stride<__nv_bfloat16>(G)
                          : lstm_gates::row_stride<int8_t>(G);
  const long long SF = lstm_gates::row_stride<float>(G);
  const bool q8 = wb == 1;
  const long long slots = (T + tc - 1) / tc > 1 ? 2 : 1;
  const long long floats =
      (long long)L * G * (q8 ? 2 : 1) + slots * tc * rows * P +
      2LL * L * rows * H + (long long)rows * G + (long long)L * K * SF +
      (long long)L * G + 2 * slots * (tc + 1) * L * rows * H +
      (long long)rows * G + (long long)rows * H +
      (q8 ? (long long)rows * G : 0);
  return (long long)L * K * S * wb + 4 * floats;
}

// The type of the bias and of dw and db: the stack's, f32 beside an int8
// stack (the straight-through gradients of the f32 master).
template <typename WT>
using GradT = typename std::conditional<sizeof(WT) == 1, float, WT>::type;

// Bounded for MAX_T threads, so every block the wrapper sizes can launch:
// uncapped, the largest instance took 128 registers a thread, too many for
// the 576 threads of H = 36 (144 gate columns x 4 lanes) on one SM's 65,536
// registers.  Each tile size is built twice: MAX_T = 512 (up to 128
// registers, no spills) serves H <= 32, the paper's width included, and
// MAX_T = 1024 (64 registers) the wider blocks.
template <int ROWS, int MAX_T, typename WT, typename IO>
__global__ void __launch_bounds__(MAX_T) lstm_seq_bwd_kernel(
    const WT* __restrict__ w, const float* __restrict__ scales,
    const GradT<WT>* __restrict__ b,
    const IO* __restrict__ x, const float* __restrict__ c_traj,
    const float* __restrict__ h_traj, const IO* __restrict__ dcf,
    const IO* __restrict__ dhf, GradT<WT>* __restrict__ dw,
    GradT<WT>* __restrict__ db, IO* __restrict__ dx,
    float* __restrict__ partials, int* __restrict__ tickets, int B, int T,
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
    if constexpr (sizeof(GradT<WT>) == 4)
      __pipeline_memcpy_async(b_s + i, b + i, 4);
    else
      b_s[i] = lstm_gates::to_f32(b[i]);
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
      dcv = lstm_gates::to_f32(dcf[o]);
      dhv = lstm_gates::to_f32(dhf[o]);
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
      const IO* src = x + (long long)(t0 + s) * x_stride_t +
                      (long long)(row0 + r) * x_stride_b + q;
      if (r >= rows)
        xd[i] = 0.0f;
      else if constexpr (sizeof(IO) == 4)
        __pipeline_memcpy_async(xd + i, src, 4);
      else  // widened as it is copied
        xd[i] = lstm_gates::to_f32(*src);
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
        {
          const float bj = b_s[(size_t)l * G + j];
          const float sj = kQ8 ? sl[j] : 1.0f;
          const WT* wi = wl + j;
          const WT* wh = wl + (size_t)P * S + j;
          if (parts == 4)
            recompute_gates<ROWS, 4>(inp, in_w, hp, H, wi, wh, S, bj, sj, j,
                                     p, active, is_tanh, g_s);
          else if (parts == 2)
            recompute_gates<ROWS, 2>(inp, in_w, hp, H, wi, wh, S, bj, sj, j,
                                     p, active, is_tanh, g_s);
          else
            recompute_gates<ROWS, 1>(inp, in_w, hp, H, wi, wh, S, bj, sj, j,
                                     p, active, is_tanh, g_s);
        }
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
            const float wv = lstm_gates::to_f32(wq[jj]);
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
                  dx[((long long)(row0 + r) * T + t) * P + q] =
                      lstm_gates::to_io<IO>(acc[r]);
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
      dw[i] = lstm_gates::to_io<GradT<WT>>(dw_s[(size_t)(i / G) * SF + i % G]);
    for (int i = tid; i < L * G; i += nt)
      db[i] = lstm_gates::to_io<GradT<WT>>(db_s[i]);
    return;
  }
  float* part = partials + (size_t)blockIdx.x * n_out;
  for (int i = tid; i < nw; i += nt)
    part[i] = dw_s[(size_t)(i / G) * SF + i % G];
  for (int i = tid; i < L * G; i += nt) part[nw + i] = db_s[i];
  close_sums(partials, tickets, n_out, nw, dw, db, tid, nt);
}

// The register home's wavefront (see the top of the file): H = P = 32, L
// of 1 or 2 layers, one batch row a block, 256 threads a layer (four chain
// warps, then four worker warps, layer by layer).
constexpr int kWaveH = 32;              // H = P of the register home
constexpr int kWaveG = 4 * kWaveH;      // gate columns
constexpr int kWaveK = 2 * kWaveH;      // rows of a layer's stack
constexpr int kWaveThreads = 256;       // threads a layer
constexpr int kRing = 16;               // trajectory rows in the ring
constexpr int kLead = 8;                // wave-steps a row is loaded ahead
constexpr int kStage = 32;              // steps a block of the dW pass stages

// The register home's dynamic shared memory, in bytes, for L layers and
// weight type size wb (4 f32, 2 bf16, 1 int8), all f32: the ring (kRing rows of
// (c, h) of every layer and x), the two parity slots of the activations
// (L, G), tanh(c) (L, H), dg (L, G) (and dg * s, int8), dh_prev (L, H)
// and dinp (L, P), and the dW pass's two stages of kStage + 1 rows of dg
// (L, G), h (L, H) and x (P).  The weights are in the lanes' registers.
// kernels/lstm_seq.py:working_set_bytes(mode="bwd") prices the same terms.
__host__ __device__ inline long long wave_smem_bytes(int L, int wb) {
  const long long ring_row = 2LL * L * kWaveH + kWaveH;
  const long long slots = 2LL * L * (kWaveG + kWaveH + kWaveG + kWaveH +
                                     kWaveH + (wb == 1 ? kWaveG : 0));
  const long long stage_row = (long long)L * (kWaveG + kWaveH) + kWaveH;
  return 4 * (kRing * ring_row + slots + 2LL * (kStage + 1) * stage_row);
}

template <typename WT, typename IO>
__global__ void __launch_bounds__(2 * kWaveThreads, 1)
    lstm_seq_bwd_wave_kernel(
        const WT* __restrict__ w, const float* __restrict__ scales,
        const GradT<WT>* __restrict__ b, const IO* __restrict__ x,
        const float* __restrict__ c_traj, const float* __restrict__ h_traj,
        const IO* __restrict__ dcf, const IO* __restrict__ dhf,
        GradT<WT>* __restrict__ dw, GradT<WT>* __restrict__ db,
        IO* __restrict__ dx, float* __restrict__ partials,
        int* __restrict__ tickets, float* __restrict__ dg_work, int B, int T,
        int L, long long x_stride_b, long long x_stride_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kQ8 = sizeof(WT) == 1;
  constexpr int H = kWaveH, P = kWaveH, G = kWaveG, K = kWaveK;
  float* ring = reinterpret_cast<float*>(smem);
  const int RW = 2 * L * H + P;  // a ring row: c (L, H), h (L, H), x (P)
  float* act = ring + kRing * RW;   // (2, L, G) activations
  float* tcb = act + 2 * L * G;     // (2, L, H) tanh(c_t)
  float* dgb = tcb + 2 * L * H;     // (2, L, G) dg
  float* dhb = dgb + 2 * L * G;     // (2, L, H) dh_prev, the layer's carry
  float* dib = dhb + 2 * L * H;     // (2, L, P) dinp, the layer below's
  float* dgs = dib + 2 * L * P;     // (2, L, G) dg * s, int8 only
  float* stage = dgs + (kQ8 ? 2 * L * G : 0);  // (2, kStage + 1, SRW)
  const int SRW = L * (G + H) + P;  // a stage row: dg (L, G), h (L, H), x
  const float* dprod = kQ8 ? dgs : dgb;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int row = blockIdx.x;
  const bool chain = warp < 4 * L;
  const int l = chain ? warp / 4 : (warp - 4 * L) / 4;
  const int i = (chain ? tid : tid - 128 * L) - 128 * l;  // 0 .. 127
  // chain lanes: unit u, gate g (column g H + u) for dg; row q, half p
  // for the products.  Worker lanes: column j.
  const int u = i >> 2, g = i & 3, q = i >> 1, p = i & 1;
  const int j = i;
  const int col = chain ? g * H + u : j;
  const float bias = lstm_gates::to_f32(b[l * G + col]);
  const float scale = kQ8 ? scales[l * G + col] : 1.0f;

  // A lane's 64 weights in registers (the codes' exact f32 values for
  // int8): a chain lane's half of row q, columns 8k + 4p .. 8k + 4p + 3; a
  // worker lane's column j, rows 0 .. 63 (one array, so the two roles
  // share registers).
  static_assert(G / 2 == K, "a half-row and a column have K values");
  float rv[K];
  const WT* wl = w + (size_t)l * K * G;
#pragma unroll
  for (int k = 0; k < K; ++k)
    rv[k] = lstm_gates::to_f32(chain ? wl[q * G + 8 * (k / 4) + 4 * p + k % 4]
                                      : wl[k * G + j]);
  // The carries at their first wave-step: dh into the layer's slot, dc in
  // the chain lanes' registers.
  float dc = 0.0f;
  if (chain) {
    dc = lstm_gates::to_f32(dcf[((long long)l * B + row) * H + u]);
    if (g == 0)
      dhb[((L - 1 - l) & 1) * L * H + l * H + u] =
          lstm_gates::to_f32(dhf[((long long)l * B + row) * H + u]);
  }
  // Start copying trajectory row r (step r: (c, h) of every layer and x)
  // into ring slot r mod kRing; row -1, the state before t = 0, is zeros.
  // The worker lanes copy, off the chain.  A bf16 x element cannot go by
  // cp.async (it is widened, and 2 bytes): its load goes out here and its
  // store waits in x_dst/x_val for store_x, after the wave-step's work
  // (a worker copies at most one x element a row: 2 L H + P <= 128 L).
  float* x_dst = nullptr;
  IO x_val = lstm_gates::to_io<IO>(0.0f);
  auto store_x = [&] {
    if constexpr (sizeof(IO) == 2) {
      if (x_dst != nullptr) *x_dst = lstm_gates::to_f32(x_val);
      x_dst = nullptr;
    }
  };
  auto load_row = [&](int r) {
    if (r < -1 || chain) return;
    float* dst = ring + (r & (kRing - 1)) * RW;
    for (int e = tid - 128 * L; e < RW; e += 128 * L) {
      if (r < 0) {
        dst[e] = 0.0f;
      } else if (e < 2 * L * H) {
        const int ll = (e % (L * H)) / H, k = e % H;
        const float* src = e < L * H ? c_traj : h_traj;
        __pipeline_memcpy_async(
            dst + e, src + (((long long)r * L + ll) * B + row) * H + k, 4);
      } else {
        const IO* src = x + row * x_stride_b + r * x_stride_t + (e - 2 * L * H);
        if constexpr (sizeof(IO) == 4) {
          __pipeline_memcpy_async(dst + e, src, 4);
        } else {
          x_dst = dst + e;
          x_val = *src;
        }
      }
    }
  };
  auto ring_row = [&](int r) { return ring + (r & (kRing - 1)) * RW; };
  // rows T-1 .. T-1-kLead, one copy group each, each kLead wave-steps
  // ahead of its first use
  for (int k = 0; k <= kLead; ++k) {
    load_row(T - 1 - k);
    store_x();
    __pipeline_commit();
  }
  __pipeline_wait_prior(kLead - 1);
  __syncthreads();

  // Wave-step s: the chain unwinds step t of layer l; the workers
  // recompute the gates of step t - 1 (the chain's next).  s = -1 only
  // recomputes.
  for (int s = -1; s <= T + L - 2; ++s) {
    load_row(T - 3 - kLead - s);
    __pipeline_commit();
    const int t = T - 1 - s + (L - 1 - l);
    const int now = s & 1, nxt = (s + 1) & 1;
    if (chain) {
      if (t >= 0 && t < T) {
        // (chain) dg of the lane's gate column, and the unit's dc carry
        const float* a = act + (now * L + l) * G;
        const float si = a[u], sf = a[H + u], tg = a[2 * H + u],
                    so = a[3 * H + u];
        const float tcn = tcb[(now * L + l) * H + u];
        const float cp = ring_row(t - 1)[l * H + u];
        const float dhv = dhb[(now * L + l) * H + u] +
                          (l + 1 < L ? dib[(now * L + l + 1) * P + u] : 0.0f);
        const float dcv = dc + dhv * so * (1.0f - tcn * tcn);
        float dg;
        if (g == 0)
          dg = dcv * tg * si * (1.0f - si);
        else if (g == 1)
          dg = dcv * cp * sf * (1.0f - sf);
        else if (g == 2)
          dg = dcv * si * (1.0f - tg * tg);
        else
          dg = dhv * tcn * so * (1.0f - so);
        dc = dcv * sf;
        dgb[(now * L + l) * G + col] = dg;
        dg_work[(((long long)row * L + l) * T + t) * G + col] = dg;
        if (kQ8) dgs[(now * L + l) * G + col] = dg * scale;
        lstm_gates::bar_sync(1 + l, 128);
        // (chain) row q's product with dg (dg * s for int8): half p of its
        // columns, four at a time, then the halves by one shuffle
        const float* dgp = dprod + (now * L + l) * G + 4 * p;
        float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
        for (int k = 0; k < G / 8; ++k) {
          const float4 d4 = *reinterpret_cast<const float4*>(dgp + 8 * k);
          acc[0] = fmaf(d4.x, rv[4 * k], acc[0]);
          acc[1] = fmaf(d4.y, rv[4 * k + 1], acc[1]);
          acc[2] = fmaf(d4.z, rv[4 * k + 2], acc[2]);
          acc[3] = fmaf(d4.w, rv[4 * k + 3], acc[3]);
        }
        float out = (acc[0] + acc[1]) + (acc[2] + acc[3]);
        out += __shfl_xor_sync(0xffffffffu, out, 1);
        if (p == 0) {
          if (q >= P)  // -> h_{t-1} of this layer: the dh carry
            dhb[(nxt * L + l) * H + q - P] = out;
          else if (l == 0)  // -> x: dx, straight to device memory
            dx[((long long)row * T + t) * P + q] = lstm_gates::to_io<IO>(out);
          else  // -> the layer below's h_t
            dib[(nxt * L + l) * P + q] = out;
        }
      }
    } else {
      const int tr = t - 1;  // the chain's next step
      if (tr >= 0 && tr < T) {
        // (workers) the gates of step tr, lstm_gates.cuh's order
        const float* rr = ring_row(tr);
        const float* inp = l == 0 ? rr + 2 * L * H : rr + L * H + (l - 1) * H;
        const float* hp = ring_row(tr - 1) + L * H + l * H;
        float sum[2];
#pragma unroll
        for (int seg = 0; seg < 2; ++seg) {
          const float* v = seg ? hp : inp;
          float acc4[4][1];
          lstm_gates::partial_sums4<1>(
              acc4, H,
              [&](int, int grp) {
                return *reinterpret_cast<const float4*>(v + 4 * grp);
              },
              [&](int grp) {
                const int k = seg * H + 4 * grp;
                return make_float4(rv[k], rv[k + 1], rv[k + 2], rv[k + 3]);
              });
          float o[1];
          lstm_gates::combine<1, 1>(o, acc4);
          sum[seg] = o[0];
        }
        const int gj = j / H;
        act[(nxt * L + l) * G + j] = lstm_gates::activate(
            lstm_gates::preact<WT>(sum[0], sum[1], bias, scale), gj == 2);
        if (j < H) tcb[(nxt * L + l) * H + j] = tanhf(rr[l * H + j]);
      }
    }
    store_x();
    __pipeline_wait_prior(kLead - 1);  // the rows the next wave-step reads
    __syncthreads();
  }

  // dW and db (the barrier above makes every dg of the workspace visible):
  // lane e sums rows k0 .. k0 + 31 of column c of layer ll, and db[ll][c]
  // with its input rows, over t = T-1 .. 0, from stages of kStage steps
  // that cp.async brings into shared memory (rows t0 - 1 .. t0 + kStage -
  // 1 of dg, h and x, the row before t = 0 zeros), the next stage in
  // flight while this one is summed; straight out for one tile, else as
  // this tile's partial and the fixed-order sum over tiles
  __pipeline_wait_prior(0);
  const int nw = L * K * G;
  const int n_out = nw + L * G;
  // this tile's partial (several tiles) or dw and db themselves (one)
  float* part = partials + (size_t)row * n_out;
  const bool alone = gridDim.x == 1;
  // f32 x rows copy 16 bytes at a time when every row is 16-byte aligned
  const bool x16 = (reinterpret_cast<uintptr_t>(x) | x_stride_b * 4 |
                    x_stride_t * 4) % 16 == 0;
  auto stage_rows = [&](int t_hi, int buf) {
    const int t0 = max(0, t_hi - kStage);
    const int pieces = SRW / 4;  // 16-byte pieces a row
    float* dst = stage + (size_t)buf * (kStage + 1) * SRW;
    for (int e = tid; e < (t_hi - t0 + 1) * pieces; e += nt) {
      const int r = e / pieces, f = (e - r * pieces) * 4;
      const int t = t0 - 1 + r;
      float* d = dst + r * SRW + f;
      if (t < 0) {
        for (int u = 0; u < 4; ++u) d[u] = 0.0f;
      } else if (f < L * G) {
        __pipeline_memcpy_async(
            d, dg_work + (((long long)row * L + f / G) * T + t) * G + f % G,
            16);
      } else if (f < L * (G + H)) {
        const int ff = f - L * G;
        __pipeline_memcpy_async(
            d, h_traj + (((long long)t * L + ff / H) * B + row) * H + ff % H,
            16);
      } else {
        const IO* src =
            x + row * x_stride_b + t * x_stride_t + f - L * (G + H);
        if constexpr (sizeof(IO) == 2)  // widened as it is copied
          for (int u = 0; u < 4; ++u) d[u] = lstm_gates::to_f32(src[u]);
        else if (x16)
          __pipeline_memcpy_async(d, src, 16);
        else
          for (int u = 0; u < 4; ++u)
            __pipeline_memcpy_async(d + u, src + u, 4);
      }
    }
  };
  {
    const int c = tid % G;
    const int r32 = tid / G;  // 32-row group of the L x K rows
    const int ll = r32 / 2, k0 = (r32 % 2) * 32;
    float acc[32], bacc = 0.0f;
#pragma unroll
    for (int k = 0; k < 32; ++k) acc[k] = 0.0f;
    stage_rows(T, 0);
    __pipeline_commit();
    for (int t_hi = T, buf = 0; t_hi > 0; t_hi -= kStage, buf ^= 1) {
      const int t0 = max(0, t_hi - kStage);
      if (t0 > 0) stage_rows(t0, buf ^ 1);
      __pipeline_commit();
      __pipeline_wait_prior(1);
      __syncthreads();
      const float* st = stage + (size_t)buf * (kStage + 1) * SRW;
      for (int t = t_hi - 1; t >= t0; --t) {
        const float* rw = st + (t - t0 + 1) * SRW;  // row t; row t-1 before
        const float dgv = rw[ll * G + c];
        bacc += dgv;
        // the 32 inputs of rows k0 ..: the layer's input (x, or the layer
        // below's h_t) or its own h_{t-1}
        const float* v = k0 == 0 ? (ll == 0 ? rw + L * (G + H)
                                            : rw + L * G + (ll - 1) * H)
                                 : rw - SRW + L * G + ll * H;
#pragma unroll
        for (int k = 0; k < 32; k += 4) {
          const float4 q4 = *reinterpret_cast<const float4*>(v + k);
          acc[k] = fmaf(q4.x, dgv, acc[k]);
          acc[k + 1] = fmaf(q4.y, dgv, acc[k + 1]);
          acc[k + 2] = fmaf(q4.z, dgv, acc[k + 2]);
          acc[k + 3] = fmaf(q4.w, dgv, acc[k + 3]);
        }
      }
      __syncthreads();  // the stage is read before the next refill
    }
#pragma unroll
    for (int k = 0; k < 32; ++k) {
      const size_t o = ((size_t)ll * K + k0 + k) * G + c;
      if (alone)
        dw[o] = lstm_gates::to_io<GradT<WT>>(acc[k]);
      else
        part[o] = acc[k];
    }
    if (k0 == 0) {
      if (alone)
        db[ll * G + c] = lstm_gates::to_io<GradT<WT>>(bacc);
      else
        part[nw + ll * G + c] = bacc;
    }
  }
  if (!alone) close_sums(partials, tickets, n_out, nw, dw, db, tid, nt);
}

template <int ROWS, int MAX_T, typename WT, typename IO>
int launch(const WT* w, const float* scales, const GradT<WT>* b, const IO* x,
           const float* c_traj, const float* h_traj, const IO* dc,
           const IO* dh, GradT<WT>* dw, GradT<WT>* db, IO* dx,
           float* partials, int* tickets, int B, int T, int L, int P, int H,
           long long x_stride_b, long long x_stride_t, int time_chunk,
           int parts, int dparts, int threads, long long smem_bytes,
           cudaStream_t stream) {
  if (time_chunk < 1 ||
      smem_bytes != bwd_smem_bytes(T, L, P, H, ROWS, time_chunk,
                                   (int)sizeof(WT)))
    return (int)cudaErrorInvalidValue;
  static long long configured = 48 * 1024;
  if (smem_bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_bwd_kernel<ROWS, MAX_T, WT, IO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    configured = smem_bytes;
  }
  const int grid = (B + ROWS - 1) / ROWS;
  lstm_seq_bwd_kernel<ROWS, MAX_T, WT, IO>
      <<<grid, threads, (size_t)smem_bytes, stream>>>(
          w, scales, b, x, c_traj, h_traj, dc, dh, dw, db, dx, partials,
          tickets, B, T, L, P, H, time_chunk, parts, dparts, x_stride_b,
          x_stride_t);
  return (int)cudaGetLastError();
}

template <typename WT, typename IO>
int launch_wave(const WT* w, const float* scales, const GradT<WT>* b,
                const IO* x, const float* c_traj, const float* h_traj,
                const IO* dc, const IO* dh, GradT<WT>* dw, GradT<WT>* db,
                IO* dx, float* partials, int* tickets, float* dg_work,
                int B, int T, int L, int P, int H, long long x_stride_b,
                long long x_stride_t, int threads, long long smem_bytes,
                cudaStream_t stream) {
  if (P != kWaveH || H != kWaveH || L < 1 || L > 2 ||
      threads != L * kWaveThreads ||
      smem_bytes != wave_smem_bytes(L, (int)sizeof(WT)))
    return (int)cudaErrorInvalidValue;
  static long long configured = 48 * 1024;
  if (smem_bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_bwd_wave_kernel<WT, IO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_bytes);
    if (e != cudaSuccess) return (int)e;
    configured = smem_bytes;
  }
  lstm_seq_bwd_wave_kernel<WT, IO><<<B, threads, (size_t)smem_bytes, stream>>>(
      w, scales, b, x, c_traj, h_traj, dc, dh, dw, db, dx, partials, tickets,
      dg_work, B, T, L, x_stride_b, x_stride_t);
  return (int)cudaGetLastError();
}

// One instance per (tile size, thread bound) of the shared home and one
// register-home wavefront; another block_b, more than 1024 threads or a
// register home at another shape is cudaErrorInvalidValue.
template <typename WT, typename IO>
int launch_tile(const WT* w, const float* scales, const GradT<WT>* b,
                const IO* x, const float* c_traj, const float* h_traj,
                const IO* dc, const IO* dh, GradT<WT>* dw, GradT<WT>* db,
                IO* dx, float* partials, int* tickets, float* dg_work,
                int B, int T, int L, int P, int H, long long x_stride_b,
                long long x_stride_t, int block_b, int time_chunk, int reg,
                int parts, int dparts, int threads, long long smem_bytes,
                void* stream) {
  if (threads > 1024) return (int)cudaErrorInvalidValue;
  if (reg) {
    if (block_b != 1) return (int)cudaErrorInvalidValue;
    return launch_wave<WT, IO>(w, scales, b, x, c_traj, h_traj, dc, dh, dw,
                               db, dx, partials, tickets, dg_work, B, T, L, P,
                               H, x_stride_b, x_stride_t, threads,
                               smem_bytes, (cudaStream_t)stream);
  }
#define LSTM_SEQ_BWD_LAUNCH(R)                                               \
  case R:                                                                    \
    return threads <= 512                                                    \
               ? launch<R, 512>(w, scales, b, x, c_traj, h_traj, dc, dh, dw, \
                                db, dx, partials, tickets, B, T, L, P, H,    \
                                x_stride_b, x_stride_t, time_chunk, parts,   \
                                dparts, threads, smem_bytes,                 \
                                (cudaStream_t)stream)                        \
               : launch<R, 1024>(w, scales, b, x, c_traj, h_traj, dc, dh,   \
                                 dw, db, dx, partials, tickets, B, T, L, P,  \
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

// ---------------------------------------------------------------------------
// The split home: the reverse sweep over G co-resident blocks.
// ---------------------------------------------------------------------------
// Where the stack and its f32 dW fit no block (lstm_seq.cu's split
// forward), one cooperative launch of grid (G, tiles) runs the sweep as a
// reverse layer wavefront: in wave-step s layer l unwinds step t = T - 1 -
// s + (L - 1 - l).  Block j of a tile owns the units [j H/G, (j+1) H/G)
// of every layer, i.e. 4U gate columns (local column c = g U + u), and
// holds their rows of the stack (L, P+H, 4U; each row padded by one word),
// their f32 dW and db, their activations and gate gradients and the dc
// carry of their units.  A wave-step is three phases and ONE grid barrier:
//  (1) recompute the forward's gates of its columns from the trajectories
//      (and x), in lstm_gates.cuh's canonical order, four lanes a (row,
//      column) as the one-block backward's parts, a warp's loads of a
//      row's inputs one sector: the forward's activations to the bit;
//  (2) for each of its units and the tile's rows, the incoming dh: the dh
//      carry (dhf at t = T - 1) plus, below the top layer, the input
//      gradient of the layer above, each the sum of the G blocks' partials
//      of the previous wave-step, in block order; then the gate gradients
//      and the dc carry (_unwind_step), zero past the batch; and the sum
//      of layer 0's dx partials of the previous wave-step, its columns q
//      = j, j + G, ...;
//  (3) dW += [inp | h_prev]^T dg and db += sum dg for its columns (f32,
//      in shared memory; a lane a row of W, its inputs loaded once for 16
//      columns), and its partial of every row of W's products, sum over
//      its columns c of dg[r][c] W[q][c] (dg * s for int8; a lane a row q,
//      its 16 weights in registers for every tile row), to
//      (2, tiles, G, L, bmp, P+H) f32 partials in device memory, slot s
//      mod 2: rows q >= P the dh carry, q < P the layer-below input
//      gradient (dx at layer 0).
// Then the grid barrier; the two slots keep a wave-step's reads of slot
// s - 1 apart from its writes of slot s, so one barrier a wave-step orders
// everything.  No atomics: every sum runs in a fixed order, so the
// gradients are the same bits run to run (not the shared home's: its
// products sum the 4H columns of a row in another order).  One extra
// wave-step sums layer 0's last dx.  After the sweep each block writes its
// columns of dw and db; for several tiles it writes its tile's f32 partial
// instead, and after one more barrier block (j, y) sums the tiles, in tile
// order, of rows (l, q) with (l (P+H+1) + q) mod tiles = y of its columns.
// Where the time goes (python -m repro_torch.obs.stamps --kernel
// lstm_seq_bwd_split, an H100 80GB HBM3 at 700 W): at 3 x 256, B = 64,
// about 80 us a wave-step in (1), 20 in (2) and 90 in (3) with the
// barrier; each phase waits on loads from device memory that no shared
// memory is left to stage (the stack and its f32 dW fill the block).

// Dynamic shared memory of one split block of the backward in bytes, the
// kernel's layout: f32 dW (L, K, 4U), db, bias (and scales) (L, 4U), the
// activations, dg (and dg * s) (L, bmp, 4U) and dc (L, bmp, U), then the
// weights (L, K, 4U + 4 / wb) of wb bytes.  kernels/lstm_seq.py:
// working_set_bytes(mode="bwd", n_blocks=G) prices the same terms.
__host__ __device__ inline long long split_bwd_smem_bytes(int L, int P, int H,
                                                          int rows, int G,
                                                          int wb) {
  const long long K = P + H, SU = 4LL * (H / G), U = H / G;
  const int rg = rows == 1 ? 1 : 4;
  const long long bmp = (rows + rg - 1) / rg * rg;
  const bool q8 = wb == 1;
  const long long floats = L * K * SU + L * SU * (q8 ? 3 : 2) +
                           L * bmp * SU * (q8 ? 3 : 2) + L * bmp * U;
  return 4 * floats + L * K * (SU * wb + 4);
}

// One lane's share of a gate sum in the split backward's recompute: lane p
// of the four of a column sums v[q] w[q * SW] over the reduction rows q =
// p, p + 4, ... < n in ascending order from 0, as fmaf (accumulator p of
// lstm_gates.cuh's canonical order), its loads of v (a row of n inputs of
// unit stride, zero when !valid) NA at a time ahead of the multiply-adds.
template <int NA, typename V, typename WT>
__device__ __forceinline__ float quad_sum(const V* v, bool valid, int n,
                                          const WT* w, int SW, int p) {
  float acc = 0.0f;
  for (int q0 = p; q0 < n; q0 += 4 * NA) {
    float xv[NA];
#pragma unroll
    for (int k = 0; k < NA; ++k)
      xv[k] = valid && q0 + 4 * k < n ? lstm_gates::to_f32(v[q0 + 4 * k])
                                      : 0.0f;
#pragma unroll
    for (int k = 0; k < NA; ++k)
      if (q0 + 4 * k < n)
        acc = fmaf(xv[k], lstm_gates::to_f32(w[(size_t)(q0 + 4 * k) * SW]),
                   acc);
  }
  return acc;
}

template <int RG, typename WT, typename IO>
__global__ void __launch_bounds__(512, 1) lstm_seq_bwd_split_kernel(
    const WT* __restrict__ w, const float* __restrict__ scales,
    const GradT<WT>* __restrict__ b, const IO* __restrict__ x,
    const float* __restrict__ c_traj, const float* __restrict__ h_traj,
    const IO* __restrict__ dcf, const IO* __restrict__ dhf,
    GradT<WT>* __restrict__ dw, GradT<WT>* __restrict__ db,
    IO* __restrict__ dx, float* part, float* tile_part, int B,
    int T, int L, int P, int H, int bm, long long x_stride_b,
    long long x_stride_t) {
  extern __shared__ __align__(16) unsigned char smem[];
  constexpr bool kQ8 = sizeof(WT) == 1;
  const int G = gridDim.x;
  const int U = H / G;
  const int j0 = blockIdx.x * U;
  const int SU = 4 * U;
  const int SW = SU + 4 / (int)sizeof(WT);  // weight row stride (elements)
  const int K = P + H;
  const int G4 = 4 * H;
  const int bmp = (bm + RG - 1) / RG * RG;
  const int tiles = gridDim.y;
  const int tile = blockIdx.y;
  float* dw_s = reinterpret_cast<float*>(smem);     // (L, K, SU)
  float* db_s = dw_s + (size_t)L * K * SU;          // (L, SU)
  float* b_s = db_s + (size_t)L * SU;               // (L, SU)
  float* s_s = b_s + (size_t)L * SU;                // (L, SU), int8 only
  float* act = s_s + (kQ8 ? (size_t)L * SU : 0);    // (L, bmp, SU)
  float* dg_s = act + (size_t)L * bmp * SU;         // (L, bmp, SU)
  float* dgs_s = dg_s + (size_t)L * bmp * SU;       // (L, bmp, SU), int8
  float* dc_s = dgs_s + (kQ8 ? (size_t)L * bmp * SU : 0);  // (L, bmp, U)
  WT* w_s = reinterpret_cast<WT*>(dc_s + (size_t)L * bmp * U);  // (L, K, SW)
  const float* dprod = kQ8 ? dgs_s : dg_s;
  // the recompute's (row, column) items and the inputs a lane loads ahead
  // of its multiply-adds; the columns an item of dW sums and the tile rows
  // it loads ahead
  const int n_quads = L * bmp * SU;
  constexpr int kAhead = 8;
  constexpr int DW = 16;
  constexpr int kAheadDW = 8;
  constexpr int kProd = 16;  // W's columns a products item holds at once
  const int ndw = (SU + DW - 1) / DW;

  const int tid = threadIdx.x;
  const int nt = blockDim.x;
  const int row0 = tile * bm;
  const int rows = min(bm, B - row0);
  // the stack's column of local column c
  auto gcol = [&](int c) { return (c / U) * H + j0 + c % U; };

  for (int i = tid; i < L * K * SU; i += nt) {
    const int lq = i / SU, c = i - lq * SU;
    w_s[(size_t)lq * SW + c] = w[(size_t)lq * G4 + gcol(c)];
    dw_s[i] = 0.0f;
  }
  for (int i = tid; i < L * SU; i += nt) {
    const int l = i / SU, c = i - l * SU;
    b_s[i] = lstm_gates::to_f32(b[l * G4 + gcol(c)]);
    if (kQ8) s_s[i] = scales[l * G4 + gcol(c)];
    db_s[i] = 0.0f;
  }
  for (int i = tid; i < L * bmp * U; i += nt) {
    const int l = i / (bmp * U), r = (i / U) % bmp, u = i % U;
    dc_s[i] = r < rows ? lstm_gates::to_f32(
                             dcf[((long long)l * B + row0 + r) * H + j0 + u])
                       : 0.0f;
  }
  __syncthreads();

  // (t, l, row r of the tile, unit k) of the (T, L, B, H) trajectories
  auto traj = [&](const float* tr, int t, int l, int r, int k) {
    return tr[(((long long)t * L + l) * B + row0 + r) * H + k];
  };
  // the partials of block k, layer l, tile row r in slot sl: (K) floats
  auto part_row = [&](int sl, int k, int l, int r) {
    return part + ((((size_t)sl * tiles + tile) * G + k) * L + l) *
                      (size_t)bmp * K + (size_t)r * K;
  };
  // the layer's input (x, or the layer below's h_t) and its own h_{t-1} of
  // tile row r at reduction row q, zero past the batch and before t = 0
  auto inp_v = [&](int l, int t, int r, int q) -> float {
    if (r >= rows) return 0.0f;
    if (l == 0)
      return lstm_gates::to_f32(x[(long long)(row0 + r) * x_stride_b +
                                  (long long)t * x_stride_t + q]);
    return traj(h_traj, t, l - 1, r, q);
  };
  auto hprev_v = [&](int l, int t, int r, int q) -> float {
    return r < rows && t > 0 ? traj(h_traj, t - 1, l, r, q) : 0.0f;
  };

  for (int s = 0; s <= T + L - 1; ++s) {
    const int cur = s & 1, prev = cur ^ 1;
    // (1) the forward's gates of the block's columns, canonical order:
    // four lanes a (row, column), lane p summing the reduction rows q = p,
    // p + 4, ... (quad_sum), the four combined by shuffles as
    // lstm_gates::combine<1, 4>; a warp is 8 columns of one row, so each
    // of its loads of the row's inputs is one sector.  The loop is
    // warp-uniform (the shuffles need every lane); lanes past the items
    // or on a layer idle this wave-step compute zeros and write nothing.
    for (int base = tid & ~31; base < n_quads * 4; base += nt) {
      const int i = base + (tid & 31);
      const int p = i & 3;
      const int c = (i >> 2) % SU;
      const int r = (i >> 2) / SU % bmp;
      const int l = min((i >> 2) / (SU * bmp), L - 1);
      const int t = T - 1 - s + (L - 1 - l);
      const bool live = i < n_quads * 4 && t >= 0 && t < T;
      const bool ok = live && r < rows;
      const int tt = live ? t : 0;  // a step that exists, for the pointers
      const WT* wl = w_s + (size_t)l * K * SW + c;
      float in_s = l == 0
          ? quad_sum<kAhead>(x + (long long)(row0 + r) * x_stride_b +
                                 (long long)tt * x_stride_t,
                             ok, P, wl, SW, p)
          : quad_sum<kAhead>(
                h_traj + (((long long)tt * L + l - 1) * B + row0 + r) * H,
                ok, H, wl, SW, p);
      float rec_s = quad_sum<kAhead>(
          h_traj + (((long long)(tt > 0 ? tt - 1 : 0) * L + l) * B + row0 +
                    r) * H,
          ok && tt > 0, H, wl + (size_t)P * SW, SW, p);
      in_s += __shfl_xor_sync(0xffffffffu, in_s, 1);
      in_s += __shfl_xor_sync(0xffffffffu, in_s, 2);
      rec_s += __shfl_xor_sync(0xffffffffu, rec_s, 1);
      rec_s += __shfl_xor_sync(0xffffffffu, rec_s, 2);
      if (live && p == 0)
        act[((size_t)l * bmp + r) * SU + c] = lstm_gates::activate(
            lstm_gates::preact<WT>(in_s, rec_s, b_s[l * SU + c],
                                   kQ8 ? s_s[l * SU + c] : 1.0f),
            c / U == 2);
    }
    __syncthreads();
    // (2) the incoming dh of the block's units, the gate gradients and the
    // dc carry; and layer 0's dx of the previous wave-step
    for (int i = tid; i < L * bmp * U; i += nt) {
      const int u = i % U;
      const int r = (i / U) % bmp;
      const int l = i / (U * bmp);
      const int t = T - 1 - s + (L - 1 - l);
      if (t < 0 || t >= T) continue;
      const int k = j0 + u;
      float dhc = 0.0f, dinp = 0.0f;
      if (t == T - 1) {
        if (r < rows)
          dhc = lstm_gates::to_f32(dhf[((long long)l * B + row0 + r) * H + k]);
      } else {
        dhc = lstm_gates::load_cg(part_row(prev, 0, l, r) + P + k);
#pragma unroll 8
        for (int blk = 1; blk < G; ++blk)
          dhc += lstm_gates::load_cg(part_row(prev, blk, l, r) + P + k);
      }
      if (l + 1 < L) {
        dinp = lstm_gates::load_cg(part_row(prev, 0, l + 1, r) + k);
#pragma unroll 8
        for (int blk = 1; blk < G; ++blk)
          dinp += lstm_gates::load_cg(part_row(prev, blk, l + 1, r) + k);
      }
      const float* a = act + ((size_t)l * bmp + r) * SU + u;
      const float si = a[0], sf = a[U], tg = a[2 * U], so = a[3 * U];
      const bool ok = r < rows;
      const float cn = ok ? traj(c_traj, t, l, r, k) : 0.0f;
      const float cp = ok && t > 0 ? traj(c_traj, t - 1, l, r, k) : 0.0f;
      const float tcn = tanhf(cn);
      const float dhv = dhc + (l + 1 < L ? dinp : 0.0f);
      float* dcp = dc_s + ((size_t)l * bmp + r) * U + u;
      const float dcv = *dcp + dhv * so * (1.0f - tcn * tcn);
      float* dgr = dg_s + ((size_t)l * bmp + r) * SU + u;
      dgr[0] = ok ? dcv * tg * si * (1.0f - si) : 0.0f;
      dgr[U] = ok ? dcv * cp * sf * (1.0f - sf) : 0.0f;
      dgr[2 * U] = ok ? dcv * si * (1.0f - tg * tg) : 0.0f;
      dgr[3 * U] = ok ? dhv * tcn * so * (1.0f - so) : 0.0f;
      if (kQ8) {
        float* dsr = dgs_s + ((size_t)l * bmp + r) * SU + u;
#pragma unroll
        for (int g = 0; g < 4; ++g)
          dsr[g * U] = dgr[g * U] * s_s[l * SU + g * U + u];
      }
      *dcp = dcv * sf;
    }
    {
      const int t0 = T - s + (L - 1);  // layer 0's step of wave-step s - 1
      if (s > 0 && t0 >= 0 && t0 < T) {
        const int nq = (P - blockIdx.x + G - 1) / G;  // q = j, j + G, ...
        for (int i = tid; i < rows * nq; i += nt) {
          const int r = i / nq;
          const int q = blockIdx.x + (i % nq) * G;
          float sum = lstm_gates::load_cg(part_row(prev, 0, 0, r) + q);
#pragma unroll 8
          for (int blk = 1; blk < G; ++blk)
            sum += lstm_gates::load_cg(part_row(prev, blk, 0, r) + q);
          dx[((long long)(row0 + r) * T + t0) * P + q] =
              lstm_gates::to_io<IO>(sum);
        }
      }
    }
    __syncthreads();
    // (3) dW and db of the block's columns (row K of a layer: db), an item
    // one row of W and DW columns, whose inputs it loads once; then its
    // partial of every row of the products
    for (int i = tid; i < L * (K + 1) * ndw; i += nt) {
      const int c0 = (i % ndw) * DW;
      const int q = (i / ndw) % (K + 1);
      const int l = i / (ndw * (K + 1));
      const int t = T - 1 - s + (L - 1 - l);
      const int in_w = l == 0 ? P : H;
      if (t < 0 || t >= T || (q >= in_w && q < P)) continue;
      const float* dgl = dg_s + (size_t)l * bmp * SU + c0;
      float sum[DW];
#pragma unroll
      for (int cc = 0; cc < DW; ++cc) sum[cc] = 0.0f;
      if (q == K) {
        for (int r = 0; r < bmp; ++r)
#pragma unroll
          for (int cc = 0; cc < DW; ++cc)
            if (c0 + cc < SU) sum[cc] += dgl[(size_t)r * SU + cc];
      } else {
        for (int r0 = 0; r0 < bmp; r0 += kAheadDW) {
          float v[kAheadDW];
#pragma unroll
          for (int k = 0; k < kAheadDW; ++k)
            v[k] = r0 + k >= bmp ? 0.0f
                   : q < P     ? inp_v(l, t, r0 + k, q)
                               : hprev_v(l, t, r0 + k, q - P);
#pragma unroll
          for (int k = 0; k < kAheadDW; ++k)
            if (r0 + k < bmp)
#pragma unroll
              for (int cc = 0; cc < DW; ++cc)
                if (c0 + cc < SU)
                  sum[cc] = fmaf(v[k], dgl[(size_t)(r0 + k) * SU + cc],
                                 sum[cc]);
        }
      }
      float* dst = q == K ? db_s + l * SU + c0
                          : dw_s + ((size_t)l * K + q) * SU + c0;
#pragma unroll
      for (int cc = 0; cc < DW; ++cc)
        if (c0 + cc < SU) dst[cc] += sum[cc];
    }
    // the products: an item is one row q of W, kProd of its columns in
    // registers at a time, for every row of the tile
    for (int i = tid; i < L * K; i += nt) {
      const int q = i % K;
      const int l = i / K;
      const int t = T - 1 - s + (L - 1 - l);
      if (t < 0 || t >= T || (l > 0 && q >= H && q < P)) continue;
      const WT* wq = w_s + ((size_t)l * K + q) * SW;
      for (int c0 = 0; c0 < SU; c0 += kProd) {
        float wv[kProd];
#pragma unroll
        for (int cc = 0; cc < kProd; ++cc)
          wv[cc] = c0 + cc < SU ? lstm_gates::to_f32(wq[c0 + cc]) : 0.0f;
        for (int r = 0; r < bmp; ++r) {
          const float* d = dprod + ((size_t)l * bmp + r) * SU + c0;
          float* out = part_row(cur, blockIdx.x, l, r) + q;
          float sum = c0 == 0 ? 0.0f : *out;
#pragma unroll
          for (int cc = 0; cc < kProd; ++cc)
            if (c0 + cc < SU) sum = fmaf(d[cc], wv[cc], sum);
          *out = sum;
        }
      }
    }
    lstm_gates::grid_sync();
  }

  // dW and db of the block's columns: straight out for one tile, else this
  // tile's partial, then the fixed-order sum over tiles
  const int KB = K + 1;  // a layer's dW rows, then its db row
  auto grad_s = [&](int l, int q, int c) {
    return q < K ? dw_s[((size_t)l * K + q) * SU + c] : db_s[l * SU + c];
  };
  if (tiles == 1) {
    for (int i = tid; i < L * KB * SU; i += nt) {
      const int c = i % SU, q = (i / SU) % KB, l = i / (SU * KB);
      const GradT<WT> v = lstm_gates::to_io<GradT<WT>>(grad_s(l, q, c));
      if (q < K)
        dw[((size_t)l * K + q) * G4 + gcol(c)] = v;
      else
        db[l * G4 + gcol(c)] = v;
    }
    return;
  }
  for (int i = tid; i < L * KB * SU; i += nt) {
    const int c = i % SU, lq = i / SU;
    tile_part[((size_t)tile * L * KB + lq) * G4 + gcol(c)] =
        grad_s(lq / KB, lq % KB, c);
  }
  lstm_gates::grid_sync();
  for (int i = tid; i < L * KB * SU; i += nt) {
    const int c = i % SU, lq = i / SU;
    if (lq % tiles != tile) continue;
    const size_t o = (size_t)lq * G4 + gcol(c);
    float sum = lstm_gates::load_cg(tile_part + o);
    for (int y = 1; y < tiles; ++y)
      sum += lstm_gates::load_cg(tile_part + (size_t)y * L * KB * G4 + o);
    const int l = lq / KB, q = lq % KB;
    const GradT<WT> v = lstm_gates::to_io<GradT<WT>>(sum);
    if (q < K)
      dw[((size_t)l * K + q) * G4 + gcol(c)] = v;
    else
      db[l * G4 + gcol(c)] = v;
  }
}

template <int RG, typename WT, typename IO>
int launch_split_inst(const WT* w, const float* scales, const GradT<WT>* b,
                      const IO* x, const float* c_traj, const float* h_traj,
                      const IO* dc, const IO* dh, GradT<WT>* dw,
                      GradT<WT>* db, IO* dx, float* part, float* tile_part,
                      int B, int T, int L, int P, int H,
                      long long x_stride_b, long long x_stride_t, int block_b,
                      int G, int threads, long long smem_bytes,
                      cudaStream_t stream) {
  static long long configured = 48 * 1024;
  if (smem_bytes > configured) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_seq_bwd_split_kernel<RG, WT, IO>,
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
      &cfg, lstm_seq_bwd_split_kernel<RG, WT, IO>, w, scales, b, x, c_traj,
      h_traj, dc, dh, dw, db, dx, part, tile_part, B, T, L, P, H,
      block_b, x_stride_b, x_stride_t);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The split launch's checks and instance: G >= 2 dividing H, kSplitThreads
// threads, the table's shared memory; RG 1 for a one-row tile, else 4.
constexpr int kSplitThreads = 512;

template <typename WT, typename IO>
int launch_split(const WT* w, const float* scales, const GradT<WT>* b,
                 const IO* x, const float* c_traj, const float* h_traj,
                 const IO* dc, const IO* dh, GradT<WT>* dw, GradT<WT>* db,
                 IO* dx, float* part, float* tile_part, int B,
                 int T, int L, int P, int H, long long x_stride_b,
                 long long x_stride_t, int block_b, int G, int threads,
                 long long smem_bytes, void* stream) {
  if (G < 2 || H % G != 0 || block_b < 1 || threads != kSplitThreads ||
      smem_bytes !=
          split_bwd_smem_bytes(L, P, H, block_b, G, (int)sizeof(WT)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (block_b == 1)
    return launch_split_inst<1, WT, IO>(
        w, scales, b, x, c_traj, h_traj, dc, dh, dw, db, dx, part, tile_part,
        B, T, L, P, H, x_stride_b, x_stride_t, block_b, G, threads,
        smem_bytes, st);
  return launch_split_inst<4, WT, IO>(
      w, scales, b, x, c_traj, h_traj, dc, dh, dw, db, dx, part, tile_part,
      B, T, L, P, H, x_stride_b, x_stride_t, block_b, G, threads,
      smem_bytes, st);
}

}  // namespace

extern "C" {

// w (L, P+H, 4H), b (L, 4H), c_traj/h_traj (T, L, B, H), dc/dh (L, B, H),
// dw, db and dx (B, T, P) contiguous f32; x element (b, t, p) at
// x[b * x_stride_b + t * x_stride_t + p].  partials holds (n + ceil(n /
// 8)) x (L (P+H) 4H + L 4H) floats for n = ceil(B / block_b) tiles, and
// tickets ceil(n / 8) + 1 ints that are 0 at the launch and 0 again after
// it (both unused for one tile): one set per stream serves every launch
// on it.  reg = 1 takes the register home (block_b 1, H = P = 32, 1 or 2
// layers, 256 threads a layer; smem_bytes is lstm_seq_bwd_wave_smem_bytes;
// dg_work holds B L T 4H floats, written and read within the launch);
// reg = 0 the shared home: one thread block of `threads` (>= parts * 4H,
// a multiple of 32) threads per batch tile of block_b rows (1, 2, 4, 8 or
// 16); `parts` lanes to a gate column, `dparts` (a power of two up to 32)
// to a row of W in the products; smem_bytes is the wrapper's
// working_set_bytes(mode="bwd") for (block_b, time_chunk).  Returns
// cudaErrorInvalidValue for any other tiling.
int lstm_seq_bwd_f32(const float* w, const float* b, const float* x,
                     const float* c_traj, const float* h_traj,
                     const float* dc, const float* dh, float* dw, float* db,
                     float* dx, float* partials, int* tickets,
                     float* dg_work, int B, int T, int L, int P, int H,
                     long long x_stride_b, long long x_stride_t, int block_b,
                     int time_chunk, int reg, int parts, int dparts,
                     int threads, long long smem_bytes, void* stream) {
  return launch_tile<float, float>(
      w, nullptr, b, x, c_traj, h_traj, dc, dh, dw, db, dx, partials,
      tickets, dg_work, B, T, L, P, H, x_stride_b, x_stride_t, block_b,
      time_chunk, reg, parts, dparts, threads, smem_bytes, stream);
}

// The bf16 plans: w, b, x, dc, dh, dw, db and dx bf16 (dw, db and dx summed
// in f32 and rounded once), the trajectories f32; everything else as
// lstm_seq_bwd_f32 (smem_bytes is working_set_bytes(mode="bwd",
// dtype_bytes=2, w_dtype_bytes=2)).
int lstm_seq_bwd_bf16(const __nv_bfloat16* w, const __nv_bfloat16* b,
                      const __nv_bfloat16* x, const float* c_traj,
                      const float* h_traj, const __nv_bfloat16* dc,
                      const __nv_bfloat16* dh, __nv_bfloat16* dw,
                      __nv_bfloat16* db, __nv_bfloat16* dx, float* partials,
                      int* tickets, float* dg_work, int B, int T, int L,
                      int P, int H, long long x_stride_b,
                      long long x_stride_t, int block_b, int time_chunk,
                      int reg, int parts, int dparts, int threads,
                      long long smem_bytes, void* stream) {
  return launch_tile<__nv_bfloat16, __nv_bfloat16>(
      w, nullptr, b, x, c_traj, h_traj, dc, dh, dw, db, dx, partials,
      tickets, dg_work, B, T, L, P, H, x_stride_b, x_stride_t, block_b,
      time_chunk, reg, parts, dparts, threads, smem_bytes, stream);
}

// The int8 plan: wq (L, P+H, 4H) int8 codes the q8 forward ran with and
// their (L, 4H) f32 scales; dw and db are the f32 straight-through
// gradients of the dequantized stack.  Everything else as lstm_seq_bwd_f32
// (smem_bytes is working_set_bytes(mode="bwd", quantized=True)).
int lstm_seq_bwd_q8(const int8_t* wq, const float* scales, const float* b,
                    const float* x, const float* c_traj, const float* h_traj,
                    const float* dc, const float* dh, float* dw, float* db,
                    float* dx, float* partials, int* tickets, float* dg_work,
                    int B, int T, int L, int P, int H, long long x_stride_b,
                    long long x_stride_t, int block_b, int time_chunk,
                    int reg, int parts, int dparts, int threads,
                    long long smem_bytes, void* stream) {
  return launch_tile<int8_t, float>(
      wq, scales, b, x, c_traj, h_traj, dc, dh, dw, db, dx, partials,
      tickets, dg_work, B, T, L, P, H, x_stride_b, x_stride_t, block_b,
      time_chunk, reg, parts, dparts, threads, smem_bytes, stream);
}

// The int8 plan of a bf16 model: as lstm_seq_bwd_q8 (f32 scales, bias, dw
// and db) with x, dc, dh and dx bf16.
int lstm_seq_bwd_q8_bf16(const int8_t* wq, const float* scales,
                         const float* b, const __nv_bfloat16* x,
                         const float* c_traj, const float* h_traj,
                         const __nv_bfloat16* dc, const __nv_bfloat16* dh,
                         float* dw, float* db, __nv_bfloat16* dx,
                         float* partials, int* tickets, float* dg_work, int B,
                         int T, int L, int P, int H, long long x_stride_b,
                         long long x_stride_t, int block_b, int time_chunk,
                         int reg, int parts, int dparts, int threads,
                         long long smem_bytes, void* stream) {
  return launch_tile<int8_t, __nv_bfloat16>(
      wq, scales, b, x, c_traj, h_traj, dc, dh, dw, db, dx, partials,
      tickets, dg_work, B, T, L, P, H, x_stride_b, x_stride_t, block_b,
      time_chunk, reg, parts, dparts, threads, smem_bytes, stream);
}

// The register home's dynamic shared memory for L layers and weights of
// wb bytes (4 f32, 2 bf16, 1 int8): what kernels/lstm_seq.py's table is
// held to.
long long lstm_seq_bwd_wave_smem_bytes(int L, int wb) {
  return wave_smem_bytes(L, wb);
}

// The shared home's: bwd_smem_bytes for a launch of block_b rows, time
// chunk tc (T for the whole sequence) and weights of wb bytes.
long long lstm_seq_bwd_smem_bytes(int T, int L, int P, int H, int block_b,
                                  int tc, int wb) {
  return bwd_smem_bytes(T, L, P, H, block_b, tc, wb);
}

// The split home (kernels/lstm_seq.py weight_home "split"): one
// cooperative launch of G = n_blocks blocks a tile of block_b rows, grid
// (G, ceil(B / block_b)), every block resident at once; G divides H.
// part holds 2 x tiles x G x L x bmp x (P+H) floats (bmp: block_b rounded
// up to 1 or 4) and tile_part, for more than one tile, tiles x L x (P+H+1)
// x 4H, both written and read within the launch.  threads is 512; smem_bytes is working_set_bytes(mode="bwd",
// n_blocks=G) (lstm_seq_bwd_split_smem_bytes).  Operands, dtypes and
// outputs as lstm_seq_bwd_* (the trajectories of the split forward or any
// other: they are the same bits).  Returns cudaErrorInvalidValue for
// another split, thread count or shared memory, and the launch's error
// when the card cannot hold every block at once.
int lstm_seq_bwd_split_f32(const float* w, const float* b, const float* x,
                           const float* c_traj, const float* h_traj,
                           const float* dc, const float* dh, float* dw,
                           float* db, float* dx, float* part,
                           float* tile_part, int B, int T,
                           int L, int P, int H, long long x_stride_b,
                           long long x_stride_t, int block_b, int n_blocks,
                           int threads, long long smem_bytes, void* stream) {
  return launch_split<float, float>(
      w, nullptr, b, x, c_traj, h_traj, dc, dh, dw, db, dx, part, tile_part,
      B, T, L, P, H, x_stride_b, x_stride_t, block_b, n_blocks, threads,
      smem_bytes, stream);
}

int lstm_seq_bwd_split_bf16(const __nv_bfloat16* w, const __nv_bfloat16* b,
                            const __nv_bfloat16* x, const float* c_traj,
                            const float* h_traj, const __nv_bfloat16* dc,
                            const __nv_bfloat16* dh, __nv_bfloat16* dw,
                            __nv_bfloat16* db, __nv_bfloat16* dx, float* part,
                            float* tile_part, int B, int T,
                            int L, int P, int H, long long x_stride_b,
                            long long x_stride_t, int block_b, int n_blocks,
                            int threads, long long smem_bytes, void* stream) {
  return launch_split<__nv_bfloat16, __nv_bfloat16>(
      w, nullptr, b, x, c_traj, h_traj, dc, dh, dw, db, dx, part, tile_part,
      B, T, L, P, H, x_stride_b, x_stride_t, block_b, n_blocks, threads,
      smem_bytes, stream);
}

int lstm_seq_bwd_split_q8(const int8_t* wq, const float* scales,
                          const float* b, const float* x, const float* c_traj,
                          const float* h_traj, const float* dc,
                          const float* dh, float* dw, float* db, float* dx,
                          float* part, float* tile_part, int B,
                          int T, int L, int P, int H, long long x_stride_b,
                          long long x_stride_t, int block_b, int n_blocks,
                          int threads, long long smem_bytes, void* stream) {
  return launch_split<int8_t, float>(
      wq, scales, b, x, c_traj, h_traj, dc, dh, dw, db, dx, part, tile_part,
      B, T, L, P, H, x_stride_b, x_stride_t, block_b, n_blocks, threads,
      smem_bytes, stream);
}

int lstm_seq_bwd_split_q8_bf16(const int8_t* wq, const float* scales,
                               const float* b, const __nv_bfloat16* x,
                               const float* c_traj, const float* h_traj,
                               const __nv_bfloat16* dc,
                               const __nv_bfloat16* dh, float* dw, float* db,
                               __nv_bfloat16* dx, float* part,
                               float* tile_part, int B, int T,
                               int L, int P, int H, long long x_stride_b,
                               long long x_stride_t, int block_b,
                               int n_blocks, int threads,
                               long long smem_bytes, void* stream) {
  return launch_split<int8_t, __nv_bfloat16>(
      wq, scales, b, x, c_traj, h_traj, dc, dh, dw, db, dx, part, tile_part,
      B, T, L, P, H, x_stride_b, x_stride_t, block_b, n_blocks, threads,
      smem_bytes, stream);
}

// split_bwd_smem_bytes of a split launch of block_b rows over G blocks, wb
// the bytes of a weight: what kernels/lstm_seq.py's table is held to.
long long lstm_seq_bwd_split_smem_bytes(int L, int P, int H, int block_b,
                                        int G, int wb) {
  return split_bwd_smem_bytes(L, P, H, block_b, G, wb);
}

const char* lstm_seq_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
