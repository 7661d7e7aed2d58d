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
// Design.  The JAX kernel keeps a tile's whole (block_b, d_inner, d_state)
// state in VMEM: 1 MiB a row at Jamba's width (d_inner 16384, d_state 16),
// four times a thread block's shared memory.  A channel's recurrence reads
// no other channel, so d_inner is tiled: a block of di_tile threads (whole
// warps, at most 128) runs di_tile channels of one batch row, one channel a
// thread, its d_state f32 states and its row of A in registers.  A block
// runs its block_b rows one after another, each exactly as alone.  Each
// chunk of C steps stages, in shared memory, the C rows of B and C that
// every channel of the row reads, and each thread's own C values of x and
// dt (the warp reads them coalesced: d is the fastest axis, and all C
// loads are in flight at once); y is stored coalesced step by step.  The
// step is mamba_math.cuh's, shared with the backward's recompute.  C sets
// the windows and K7t's cadence, and no arithmetic: y and the final state
// are bit-identical at every chunk, tile and row tiling, and at a T that
// C does not divide (the last chunk is shorter).
//
// What bounds it on the H100: at the training and serving shapes (B = 4,
// T = 512, d_inner 16384, d_state 16) one call moves ~412 MB with f32 IO
// (x, dt and y are 134 MB each; ~278 MB with bf16 x and y) and does
// ~3.8 G f32 operations, 537 M of them exponentials, so the bytes bound it
// at ~0.12 ms (f32) and the operations at ~0.06 ms, counting an expf as one
// operation.  An expf is some ten instructions, so the arithmetic is the
// likelier limit; and only B x d_inner = 65,536 threads exist, about 16
// warps an SM, each running its T steps in order.  A block runs all T
// steps of its rows, so the grid must fit the SMs at once: the budget
// table (kernels/mamba_scan.py:block_budget) keeps 16 warps an SM, four
// blocks of 128, which at B = 4 holds the grid's 512 blocks in one wave.
//
// K7t (kTraj = true) is the same kernel with one more output: before each
// chunk a thread writes its states, the state the chunk starts from, to
// h_traj[row][chunk][d] (f32, 16-byte stores: adjacent threads, adjacent
// 64-byte rows), the residual csrc/mamba_scan_bwd.cu recomputes each chunk
// from.  It writes nothing the scan reads, so its y and final state are
// bit for bit K7's; it adds B T / C d_inner d_state 4 bytes of stores,
// 537 MB at the shapes above and the training chunk C = 4.

#include "mamba_math.cuh"

namespace {

using mamba::kMaxDs;
using mamba::kMaxTile;

// Shared memory of one block, in floats: x and dt (C, tile); B and C rows
// (C, ds).  kernels/mamba_scan.py:working_set_bytes prices the same terms.
__host__ __device__ inline long long smem_floats(int C, int ds, int tile) {
  return 2LL * C * tile + 2LL * C * ds;
}

template <typename IO, bool kTraj>
__global__ void __launch_bounds__(kMaxTile)
    mamba_scan_kernel(const IO* __restrict__ x, const float* __restrict__ dt,
                      const float* __restrict__ bm,
                      const float* __restrict__ cm,
                      const float* __restrict__ a,
                      const float* __restrict__ h0, IO* __restrict__ y,
                      float* __restrict__ h_out, float* __restrict__ h_traj,
                      int B, int T, int di, int ds, int C, int block_b) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  float* sx = smem;            // x window (C, tile), f32
  float* sdt = sx + C * tile;  // dt window (C, tile)
  float* sb = sdt + C * tile;  // B rows (C, ds)
  float* sc = sb + C * ds;     // C rows (C, ds)
  const int dl = threadIdx.x;
  const int d = blockIdx.x * tile + dl;
  const bool live = d < di;  // threads past d_inner run zeros, store nothing
  const int nchunks = (T + C - 1) / C;

  float arow[kMaxDs];
  if (live)
    mamba::load_row(a + (long long)d * ds, arow, ds);
  else
    mamba::zero_row(arow);

  for (int rr = 0; rr < block_b; ++rr) {
    const int row = blockIdx.y * block_b + rr;
    if (row >= B) break;  // uniform across the block
    const long long srow = ((long long)row * di + d) * ds;
    float h[kMaxDs];
    if (live)
      mamba::load_row(h0 + srow, h, ds);
    else
      mamba::zero_row(h);

    for (int k = 0; k < nchunks; ++k) {
      const int t0 = k * C;
      const int n = min(C, T - t0);
      if (kTraj && live)  // the state this chunk starts from
        mamba::store_row(
            h_traj + (((long long)row * nchunks + k) * di + d) * ds, h, ds);
      const long long g0 = ((long long)row * T + t0) * di + d;
      for (int i = 0; i < n; ++i) {
        const long long g = g0 + (long long)i * di;
        sx[i * tile + dl] = live ? mamba::to_f32(x[g]) : 0.f;
        sdt[i * tile + dl] = live ? dt[g] : 0.f;
      }
      const long long r0 = ((long long)row * T + t0) * ds;
      for (int e = dl; e < n * ds; e += tile) {
        sb[e] = bm[r0 + e];
        sc[e] = cm[r0 + e];
      }
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        const float yv = mamba::step(h, arow, sx[i * tile + dl],
                                     sdt[i * tile + dl], sb + i * ds,
                                     sc + i * ds, ds);
        if (live) mamba::store(y + g0 + (long long)i * di, yv);
      }
      __syncthreads();  // the next chunk overwrites the windows
    }
    if (live) mamba::store_row(h_out + srow, h, ds);
  }
}

template <typename IO, bool kTraj>
int launch(const IO* x, const float* dt, const float* b, const float* c,
           const float* a, const float* h0, IO* y, float* h_out,
           float* h_traj, int B, int T, int di, int ds, int chunk,
           int block_b, int di_tile, long long smem, void* stream) {
  if (B < 1 || T < 1 || di < 1 || ds < 1 || ds > kMaxDs || chunk < 1 ||
      chunk > T || block_b < 1 || di_tile < 32 || di_tile > kMaxTile ||
      di_tile % 32 != 0)
    return (int)cudaErrorInvalidValue;
  // the wrapper's budget table must price exactly this launch
  if (smem != 4 * smem_floats(chunk, ds, di_tile))
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_kernel<IO, kTraj>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((di + di_tile - 1) / di_tile,
                  (B + block_b - 1) / block_b);
  mamba_scan_kernel<IO, kTraj>
      <<<grid, di_tile, (size_t)smem, (cudaStream_t)stream>>>(
          x, dt, b, c, a, h0, y, h_out, h_traj, B, T, di, ds, chunk,
          block_b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, y (B, T, di); dt (B, T, di) f32; b, c (B, T, ds) f32; a (di, ds) f32;
// h0, h_out (B, di, ds) f32; all contiguous.  x and y f32 (mamba_scan_f32)
// or bf16 (mamba_scan_bf16).  smem must equal the block's shared memory,
// 4 * smem_floats(chunk, ds, di_tile) bytes.  Grid: ceil(di / di_tile) x
// ceil(B / block_b) blocks of di_tile threads.  The _traj entries (K7t)
// also write h_traj (B, ceil(T / chunk), di, ds) f32.
int mamba_scan_f32(const float* x, const float* dt, const float* b,
                   const float* c, const float* a, const float* h0, float* y,
                   float* h_out, int B, int T, int di, int ds, int chunk,
                   int block_b, int di_tile, long long smem, void* stream) {
  return launch<float, false>(x, dt, b, c, a, h0, y, h_out, nullptr, B, T,
                              di, ds, chunk, block_b, di_tile, smem, stream);
}

int mamba_scan_bf16(const void* x, const float* dt, const float* b,
                    const float* c, const float* a, const float* h0, void* y,
                    float* h_out, int B, int T, int di, int ds, int chunk,
                    int block_b, int di_tile, long long smem, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16, false>((const bf16*)x, dt, b, c, a, h0, (bf16*)y,
                             h_out, nullptr, B, T, di, ds, chunk, block_b,
                             di_tile, smem, stream);
}

int mamba_scan_traj_f32(const float* x, const float* dt, const float* b,
                        const float* c, const float* a, const float* h0,
                        float* y, float* h_out, float* h_traj, int B, int T,
                        int di, int ds, int chunk, int block_b, int di_tile,
                        long long smem, void* stream) {
  return launch<float, true>(x, dt, b, c, a, h0, y, h_out, h_traj, B, T, di,
                             ds, chunk, block_b, di_tile, smem, stream);
}

int mamba_scan_traj_bf16(const void* x, const float* dt, const float* b,
                         const float* c, const float* a, const float* h0,
                         void* y, float* h_out, float* h_traj, int B, int T,
                         int di, int ds, int chunk, int block_b, int di_tile,
                         long long smem, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16, true>((const bf16*)x, dt, b, c, a, h0, (bf16*)y, h_out,
                            h_traj, B, T, di, ds, chunk, block_b, di_tile,
                            smem, stream);
}

const char* mamba_scan_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
