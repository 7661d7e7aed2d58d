// Mamba selective scan (K7) and its trajectory-writing instance (K7t), f32
// and bf16 IO, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels kernels/mamba_scan.py:_kernel and
// _traj_kernel (body _fwd_body, step math _chunk_math), launched by
// _fwd_call: per channel d of d_inner and state s of d_state,
//   h_t = exp(dt_t A) * h_{t-1} + (dt_t x_t) B_t,   y_t = sum_s h_t C_t,
// over whole sequences, with the f32 state carried from the first step to
// the last in one launch (MobiRNN's preallocated-state rule).
//
// What bounds it on the H100: at the training and serving shapes (B = 4,
// T = 512, d_inner 16384, d_state 16) one call moves ~412 MB with f32 IO
// (x, dt and y are 134 MB each; ~278 MB with bf16 x and y), ~0.12 ms at
// 3.35 TB/s, over 537 M state-steps.  A state-step issues 12 instructions
// that no layout removes (dt A, the accurate expf's 8, (dt x) B, the
// update's and y's fused multiply-adds), ~0.2 ms at 132 SMs x 128 lanes
// and 1.98 GHz: the kernel is bound by issue, and its design spends as
// few instructions as it can beside those.
//
// Design.  The JAX kernel keeps a tile's whole (block_b, d_inner, d_state)
// state in VMEM: 1 MiB a row at Jamba's width, four times a thread block's
// shared memory.  A channel's recurrence reads no other channel, so d_inner
// is tiled, and a block runs di_tile channels of one batch row (its block_b
// rows one after another, each exactly as alone).
//  * One thread a channel, its kMaxDs states and its row of A in
//    registers: the step's overhead (x and dt, the B and C loads, y's tree
//    and store, the pointers) is paid once for 16 states, ~1.6 instructions
//    a state-step beside the 12.  Two lanes a channel (32 warps an SM, 64
//    registers) measured slower: ~16 a state-step.  At Jamba's width 2,048
//    warps, 15.5 an SM, one wave (a block runs all T steps of its rows).
//  * The step is branch-free: the B and C rows are staged padded to
//    kMaxDs states with zeros, so a state past d_state (A 0, h 0) stays 0
//    and adds 0 to y, and the compiler interleaves the 16 states' chains;
//    B and C are read as 16-byte shared loads (broadcast to the warp), and
//    a tile with no channel past d_inner stores y without a test (its own
//    copy of the step loop).
//    The states are mamba_math.cuh's update(), bit for bit what K7b
//    recomputes; y is mamba_math.cuh's one order (quarters, then
//    pairwise), the same in every path.
//  * A chunk of C steps is read in windows of at most kWindow steps (x, dt,
//    and the B and C rows), which a two-slot ring in shared memory takes in
//    by cp.async, 16 bytes a copy where every row allows: window w + 1
//    lands while window w computes, with one barrier a window.  C sets only
//    the windows and K7t's cadence, no arithmetic: y and the final state
//    are bit-identical at every chunk, tile and row tiling, and at a T that
//    C does not divide (the last chunk is shorter).
//  * T = 1 (a served decode step) takes a path of one phase
//    (mamba_step_kernel): four lanes a channel, a quarter of its states
//    each; every load of a lane (its quarter of A, h0, B and C, and x and
//    dt) goes in flight before the first arithmetic; no shared memory and
//    no barrier.  It calls the same update() and y order, so its y and
//    state are bit for bit the general path's at T = 1.
//
// K7t (kTraj = true) is the same kernel with one more output: before each
// chunk a thread writes its states, the state the chunk starts from, to
// h_traj[row][chunk][d] (f32, 16-byte stores: a warp writes 32 adjacent
// 64-byte rows), the residual csrc/mamba_scan_bwd.cu recomputes each chunk
// from.  It writes nothing the scan reads, so its y and final state are
// bit for bit K7's; it adds B T / C d_inner d_state 4 bytes of stores,
// 67 MB at the shapes above and the training chunk C = 32.

#include <cuda_pipeline.h>

#include <type_traits>

#include "mamba_math.cuh"

namespace {

using mamba::kMaxDs;

constexpr int kMaxTile = 128;      // channels (threads) of the widest block
constexpr int kMinBlocks = 4;      // blocks of kMaxTile an SM: 128 registers
constexpr int kWindow = 16;        // steps a window, at most
constexpr int kStepLanes = 4;      // lanes a channel at T = 1
constexpr int kStepThreads = 128;  // threads a block at T = 1
constexpr int kStepChannels = kStepThreads / kStepLanes;

__host__ __device__ inline int window_steps(int C) {
  return C < kWindow ? C : kWindow;
}

// One window of the ring, in bytes: dt (W, tile) f32, x (W, tile) in the
// IO type, the B and C rows (W, kMaxDs) f32, in that order (each part
// starts at a multiple of 16 bytes: tile is a multiple of 32).
__host__ __device__ inline long long slot_bytes(int C, int tile, int io) {
  const long long w = window_steps(C);
  return w * tile * (4 + io) + 2 * w * kMaxDs * 4;
}

// The dynamic shared memory a launch at (T, C, tile, IO bytes) asks for:
// the two windows of the ring, or none on the one-phase path (T = 1).
// kernels/mamba_scan.py:working_set_bytes(mode="fwd") prices the same.
inline long long smem_bytes(int T, int C, int tile, int io) {
  return T == 1 ? 0 : 2 * slot_bytes(C, tile, io);
}

template <typename T>
__device__ __forceinline__ void set_zero(T* p) {
  *p = T();
}

template <typename IO, bool kTraj>
__global__ void __launch_bounds__(kMaxTile, kMinBlocks)
    mamba_scan_kernel(const IO* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, IO* __restrict__ y,
                      float* __restrict__ h_out, float* __restrict__ h_traj,
                      int B, int T, int di, int ds, int C, int block_b,
                      int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int tile = blockDim.x;  // a power of two
  const int tshift = __ffs(tile) - 1;
  const int tid = threadIdx.x;
  const int d0 = blockIdx.x * tile;
  const int d = d0 + tid;
  const bool live = d < di;  // threads past d_inner run zeros, store nothing
  const int W = window_steps(C);
  const int nchunks = (T + C - 1) / C;
  const long long slot = slot_bytes(C, tile, (int)sizeof(IO));
  // where a window's parts start
  auto s_dt = [&](int sl) {
    return reinterpret_cast<float*>(smem + sl * slot);
  };
  auto s_x = [&](int sl) {
    return reinterpret_cast<IO*>(s_dt(sl) + W * tile);
  };
  auto s_b = [&](int sl) {
    return reinterpret_cast<float*>(s_x(sl) + W * tile);
  };
  auto s_c = [&](int sl) { return s_b(sl) + W * kMaxDs; };

  float arow[kMaxDs];
  mamba::load_part(a + (long long)d * ds, 0, ds, live, vec, arow);

  for (int rr = 0; rr < block_b; ++rr) {
    const int row = blockIdx.y * block_b + rr;
    if (row >= B) break;  // uniform across the block
    const long long srow = ((long long)row * di + d) * ds;
    float h[kMaxDs];
    mamba::load_part(h0 + srow, 0, ds, live, vec, h);

    // Start copying the window of steps t0 .. t0 + n - 1 into ring slot
    // sl: 16 bytes a copy where every row allows (vec), else 4-byte copies
    // and plain loads of bf16 x; zeros for channels past d_inner and for
    // the B and C states past d_state.
    auto issue = [&](int t0, int n, int sl) {
      float* pdt = s_dt(sl);
      IO* px = s_x(sl);
      float* pb = s_b(sl);
      float* pc = s_c(sl);
      const long long r0 = (long long)row * T + t0;  // (row, t0) of (B, T)
      if (vec) {
        // a (n, tile) window in pieces of `per` elements: the thread's
        // piece is column c of rows i0, i0 + per, ... (tile threads cover
        // per rows a pass)
        auto rows16 = [&](auto* dst, const auto* src, int per) {
          const int c = (per * tid) & (tile - 1);
          const int i0 = (per * tid) >> tshift;
          const bool in = d0 + c < di;
          const auto* from = src + (r0 + i0) * di + d0 + c;
          for (int i = i0; i < n; i += per, from += (long long)per * di) {
            if (in)
              __pipeline_memcpy_async(dst + i * tile + c, from, 16);
            else
              for (int u = 0; u < per; ++u) set_zero(dst + i * tile + c + u);
          }
        };
        rows16(pdt, dt, 4);
        rows16(px, x, 16 / (int)sizeof(IO));
        for (int e = 4 * tid; e < n * kMaxDs; e += 4 * tile) {
          const int i = e / kMaxDs, s = e % kMaxDs;
          if (s < ds) {
            __pipeline_memcpy_async(pb + e, bm + (r0 + i) * ds + s, 16);
            __pipeline_memcpy_async(pc + e, cm + (r0 + i) * ds + s, 16);
          } else {
            for (int u = 0; u < 4; ++u) pb[e + u] = pc[e + u] = 0.f;
          }
        }
        return;
      }
      for (int e = tid; e < n * tile; e += tile) {
        const int i = e >> tshift, c = e & (tile - 1);
        const long long g = (r0 + i) * di + d0 + c;
        if (d0 + c < di) {
          __pipeline_memcpy_async(pdt + e, dt + g, 4);
          if constexpr (sizeof(IO) == 4)
            __pipeline_memcpy_async(px + e, x + g, 4);
          else
            px[e] = x[g];
        } else {
          pdt[e] = 0.f;
          px[e] = IO();
        }
      }
      for (int e = tid; e < n * kMaxDs; e += tile) {
        const int i = e / kMaxDs, s = e % kMaxDs;
        if (s < ds) {
          __pipeline_memcpy_async(pb + e, bm + (r0 + i) * ds + s, 4);
          __pipeline_memcpy_async(pc + e, cm + (r0 + i) * ds + s, 4);
        } else {
          pb[e] = pc[e] = 0.f;
        }
      }
    };

    issue(0, W, 0);  // W <= C <= T
    __pipeline_commit();
    int w = 0;  // windows of the row so far: w & 1 is the slot
    for (int k = 0; k < nchunks; ++k) {
      const int tk = k * C;
      const int nk = min(C, T - tk);  // the chunk's steps
      if (kTraj)  // the state this chunk starts from
        mamba::store_part(
            h_traj + (((long long)row * nchunks + k) * di + d) * ds, 0, ds,
            live, vec, h);
      for (int j = 0; j < nk; j += W, ++w) {
        const int sl = w & 1;
        const int n = min(W, nk - j);
        // (W) window w in: the stamp after this barrier times the window
        // before it, its copies' wait and this barrier
        __pipeline_wait_prior(0);  // this thread's copies of window w landed
        __syncthreads();  // every thread's; window w - 1's slot is free
        if (j + W < nk)
          issue(tk + j + W, min(W, nk - j - W), sl ^ 1);
        else if (k + 1 < nchunks)
          issue(tk + C, min(W, T - tk - C), sl ^ 1);
        __pipeline_commit();
        // (S) the window's steps; the pointers into x, dt, the B and C rows
        // and y move on by a row a step
        const float* pdt = s_dt(sl) + tid;
        const IO* px = s_x(sl) + tid;
        const float* pb = s_b(sl);
        IO* py = y + ((long long)row * T + tk + j) * di + d;
        // a tile with no channel past d_inner stores y unconditionally
        auto steps = [&](auto all_live) {
#pragma unroll 2
          for (int i = 0; i < n; ++i) {
            const float dtv = *pdt;
            const float dtx = __fmul_rn(dtv, mamba::to_f32(*px));
            float p[kMaxDs / 4];
#pragma unroll
            for (int q = 0; q < kMaxDs / 4; ++q) {
              const float4 b4 = reinterpret_cast<const float4*>(pb)[q];
              const float4 c4 =
                  reinterpret_cast<const float4*>(pb + W * kMaxDs)[q];
              const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
              const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
              for (int u = 0; u < 4; ++u)
                h[4 * q + u] = mamba::update(
                    mamba::decay(dtv, arow[4 * q + u]), h[4 * q + u], dtx,
                    bq[u]);
              p[q] = mamba::quarter_y(h + 4 * q, cq);
            }
            const float yv = mamba::channel_y<1>(p);
            if (decltype(all_live)::value || live) mamba::store(py, yv);
            pdt += tile;
            px += tile;
            pb += kMaxDs;
            py += di;
          }
        };
        if (d0 + tile <= di)
          steps(std::true_type());
        else
          steps(std::false_type());
      }
    }
    // (E) the row's last window and its final state
    mamba::store_part(h_out + srow, 0, ds, live, vec, h);
    __syncthreads();  // the next row's first window refills slot 0
  }
}

// The one-phase path at T = 1: four lanes a channel, every load of a lane
// in flight before the first arithmetic, no shared memory, no barrier.
template <typename IO, bool kTraj>
__global__ void __launch_bounds__(kStepThreads)
    mamba_step_kernel(const IO* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, IO* __restrict__ y,
                      float* __restrict__ h_out, float* __restrict__ h_traj,
                      int di, int ds, int vec) {
  const int tid = threadIdx.x;
  const int s0 = (tid & (kStepLanes - 1)) * 4;  // the lane's quarter
  const int d = blockIdx.x * kStepChannels + tid / kStepLanes;
  const int row = blockIdx.y;
  const bool live = d < di;
  const long long g = (long long)row * di + d;  // (row, 0, d) of (B, 1, di)
  float av[4], hv[4], bv[4], cv[4];
  mamba::load_part(a + (long long)d * ds, s0, ds, live, vec, av);
  mamba::load_part(h0 + g * ds, s0, ds, live, vec, hv);
  mamba::load_part(bm + (long long)row * ds, s0, ds, true, vec, bv);
  mamba::load_part(cm + (long long)row * ds, s0, ds, true, vec, cv);
  const float xv = live ? mamba::to_f32(x[g]) : 0.f;
  const float dtv = live ? dt[g] : 0.f;
  if (kTraj) mamba::store_part(h_traj + g * ds, s0, ds, live, vec, hv);
  const float dtx = __fmul_rn(dtv, xv);
#pragma unroll
  for (int u = 0; u < 4; ++u)
    hv[u] = mamba::update(mamba::decay(dtv, av[u]), hv[u], dtx, bv[u]);
  float p[1] = {mamba::quarter_y(hv, cv)};
  const float yv = mamba::channel_y<kStepLanes>(p);
  if (live && s0 == 0) mamba::store(y + g, yv);
  mamba::store_part(h_out + g * ds, s0, ds, live, vec, hv);
}

// The general kernel's shared-memory attributes: room for smem bytes, and
// the largest shared-memory carveout, so that its blocks share an SM.
template <typename IO, bool kTraj>
cudaError_t configure(long long smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_kernel<IO, kTraj>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  return cudaFuncSetAttribute(mamba_scan_kernel<IO, kTraj>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename IO, bool kTraj>
int launch(const IO* x, const float* dt, const float* b, const float* c,
           const float* a, const float* h0, IO* y, float* h_out,
           float* h_traj, int B, int T, int di, int ds, int chunk,
           int block_b, int di_tile, int one_phase, long long smem,
           void* stream) {
  if (B < 1 || T < 1 || di < 1 || ds < 1 || ds > kMaxDs || chunk < 1 ||
      chunk > T || block_b < 1 || di_tile < 32 || di_tile > kMaxTile ||
      (di_tile & (di_tile - 1)) != 0 || (one_phase && T != 1))
    return (int)cudaErrorInvalidValue;
  // the wrapper's budget table must price exactly this launch
  if (smem != (one_phase ? 0 : 2 * slot_bytes(chunk, di_tile, sizeof(IO))))
    return (int)cudaErrorInvalidValue;
  // 16-byte copies, loads and stores where every row piece is aligned
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = di % 8 == 0 && ds % 4 == 0 && al16(x) && al16(dt) &&
                  al16(b) && al16(c) && al16(a) && al16(h0) && al16(h_out) &&
                  (h_traj == nullptr || al16(h_traj));
  if (one_phase) {
    const dim3 grid((di + kStepChannels - 1) / kStepChannels, B);
    mamba_step_kernel<IO, kTraj>
        <<<grid, kStepThreads, 0, (cudaStream_t)stream>>>(
            x, dt, b, c, a, h0, y, h_out, h_traj, di, ds, vec);
    return (int)cudaGetLastError();
  }
  const cudaError_t e = configure<IO, kTraj>(smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((di + di_tile - 1) / di_tile,
                  (B + block_b - 1) / block_b);
  mamba_scan_kernel<IO, kTraj>
      <<<grid, di_tile, (size_t)smem, (cudaStream_t)stream>>>(
          x, dt, b, c, a, h0, y, h_out, h_traj, B, T, di, ds, chunk,
          block_b, vec);
  return (int)cudaGetLastError();
}

template <typename IO, bool kTraj>
int blocks_per_sm(int one_phase, int di_tile, long long smem) {
  int n = 0;
  cudaError_t e;
  if (one_phase) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, mamba_step_kernel<IO, kTraj>, kStepThreads, (size_t)0);
  } else {
    e = configure<IO, kTraj>(smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, mamba_scan_kernel<IO, kTraj>, di_tile, (size_t)smem);
  }
  return e == cudaSuccess ? n : -(int)e;
}

}  // namespace

extern "C" {

// x, y (B, T, di); dt (B, T, di) f32; b, c (B, T, ds) f32; a (di, ds) f32;
// h0, h_out (B, di, ds) f32; all contiguous.  x and y f32 (mamba_scan_f32)
// or bf16 (mamba_scan_bf16).  one_phase (T = 1 only) takes the one-phase
// path; smem must equal the launch's shared memory,
// mamba_scan_smem_bytes(T, chunk, ds, di_tile, IO bytes) (0 on the
// one-phase path, the ring on the general path, also at T = 1).  Grid:
// ceil(di / di_tile) x ceil(B / block_b) blocks of di_tile threads (a power
// of two from 32 to 128), or at T = 1 ceil(di / 32) x B blocks of 128.
// The _traj entries (K7t) also write h_traj (B, ceil(T / chunk), di, ds)
// f32.
int mamba_scan_f32(const float* x, const float* dt, const float* b,
                   const float* c, const float* a, const float* h0, float* y,
                   float* h_out, int B, int T, int di, int ds, int chunk,
                   int block_b, int di_tile, int one_phase, long long smem,
                   void* stream) {
  return launch<float, false>(x, dt, b, c, a, h0, y, h_out, nullptr, B, T,
                              di, ds, chunk, block_b, di_tile, one_phase,
                              smem, stream);
}

int mamba_scan_bf16(const void* x, const float* dt, const float* b,
                    const float* c, const float* a, const float* h0, void* y,
                    float* h_out, int B, int T, int di, int ds, int chunk,
                    int block_b, int di_tile, int one_phase, long long smem,
                    void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16, false>((const bf16*)x, dt, b, c, a, h0, (bf16*)y,
                             h_out, nullptr, B, T, di, ds, chunk, block_b,
                             di_tile, one_phase, smem, stream);
}

int mamba_scan_traj_f32(const float* x, const float* dt, const float* b,
                        const float* c, const float* a, const float* h0,
                        float* y, float* h_out, float* h_traj, int B, int T,
                        int di, int ds, int chunk, int block_b, int di_tile,
                        int one_phase, long long smem, void* stream) {
  return launch<float, true>(x, dt, b, c, a, h0, y, h_out, h_traj, B, T, di,
                             ds, chunk, block_b, di_tile, one_phase, smem,
                             stream);
}

int mamba_scan_traj_bf16(const void* x, const float* dt, const float* b,
                         const float* c, const float* a, const float* h0,
                         void* y, float* h_out, float* h_traj, int B, int T,
                         int di, int ds, int chunk, int block_b, int di_tile,
                         int one_phase, long long smem, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16, true>((const bf16*)x, dt, b, c, a, h0, (bf16*)y, h_out,
                            h_traj, B, T, di, ds, chunk, block_b, di_tile,
                            one_phase, smem, stream);
}

// The shared memory a launch at (T, chunk <= T, d_state, di_tile, IO bytes)
// asks for on the path the tables take (the one-phase path at T = 1):
// what kernels/mamba_scan.py:working_set_bytes(mode="fwd") is held to.
long long mamba_scan_smem_bytes(int T, int chunk, int ds, int di_tile,
                                int io) {
  (void)ds;  // the B and C rows are staged padded to kMaxDs
  return smem_bytes(T, chunk, di_tile, io);
}

// Blocks an SM holds at once (the runtime's occupancy calculator): the
// general kernel's of di_tile channels at smem bytes, or the one-phase
// kernel's; a negative CUDA error code on failure.
int mamba_scan_blocks_per_sm(int io, int traj, int one_phase, int di_tile,
                             long long smem) {
  using bf16 = __nv_bfloat16;
  if (io == 2)
    return traj ? blocks_per_sm<bf16, true>(one_phase, di_tile, smem)
                : blocks_per_sm<bf16, false>(one_phase, di_tile, smem);
  return traj ? blocks_per_sm<float, true>(one_phase, di_tile, smem)
              : blocks_per_sm<float, false>(one_phase, di_tile, smem);
}

const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
