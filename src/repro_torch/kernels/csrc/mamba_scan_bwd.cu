// Mamba selective-scan backward (K7b), f32 and bf16 IO, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/mamba_scan.py:_bwd_kernel,
// launched by _bwd_call: the whole reverse-time sweep of the scan of
// csrc/mamba_scan.cu in one launch.  The Pallas body gets each chunk's
// backward from jax.vjp of _chunk_math; here it is derived by hand
// (kernels/mamba_scan.py's docstring has the formulas, mamba_scan_bwd_plain
// the same sums in plain PyTorch).  Per channel d and state s, with
// a_t = exp(dt_t A) and g the cotangent of h_t, each chunk walked in
// reverse from g = dh_fin at the last step:
//   g_t   = a_{t+1} g_{t+1} + dy_t C_t
//   dx_t  = dt_t sum_s g_t B_t,   ddt_t = sum_s g_t h_{t-1} a_t A
//                                         + x_t sum_s g_t B_t
//   dB_t  = sum_d g_t dt_t x_t,   dC_t  = sum_d dy_t h_t
//   dA    = sum_{b,t} g_t h_{t-1} a_t dt_t,   dh0 = a_0 g_0.
//
// Design.  As in the forward, a block of di_tile threads runs di_tile
// channels of its block_b batch rows, one after another, a channel a
// thread, with g, A and the dA sums in registers; chunks run in reverse.
// A chunk first stages its x, dt, dy windows and B, C rows, then recomputes
// its per-step states from the incoming state K7t stored in h_traj, with
// mamba_math.cuh's step, so they are bit for bit the forward's; they stay
// in shared memory, (C + 1) x d_state x di_tile floats, which is what keeps
// the training chunk small.  The reverse steps then need nothing but shared
// memory and registers; dx and ddt are stored coalesced.
// Reductions, with no float atomics, so two runs give the same bits:
//   * dB_t and dC_t sum over d_inner.  Each warp sums its 32 channels'
//     2 x 16 terms of a step in one transposing butterfly (31 shuffles:
//     lane l ends with term l), the block sums its warps in order, and
//     writes the chunk's (C, 32) partial; the last block of the row's
//     chunk to arrive (an integer ticket per (row, chunk), after a
//     __threadfence) adds the d-tiles' partials in tile order 0 .. n-1.
//   * dA sums over rows and steps: a block keeps its sums in registers
//     across its rows and chunks, writes them as its row tile's partial,
//     and the last of the d-tile's row tiles adds them in tile order.
// Steps past T are not run (the last chunk is shorter), so no padded step
// or row reaches dA, dB or dC.
//
// What bounds it on the H100: at the training shapes (B = 4, T = 512,
// d_inner 16384, d_state 16, C = 4, f32 IO) one call moves ~1.27 GB (x,
// dt, dy, dx, ddt at 134 MB each; h_traj 537 MB; the dB/dC partials
// 34 MB out and in) and the backward needs ~9.7 G f32 operations (the
// recompute ~5 a state-step, the reverse step ~13), so the bytes bound it
// at ~0.38 ms and the operations at ~0.14 ms, an expf counted as one.  Its
// real limit is narrower: only d_inner / di_tile x B = 512 blocks of four
// warps exist, four resident an SM for their 49.7 KB of shared memory,
// each running the recompute and the reverse step of all its T steps in
// order.

#include "mamba_math.cuh"

namespace {

using mamba::kMaxDs;
using mamba::kMaxTile;

// Shared memory of one block, in floats: the per-step states (C + 1, ds,
// tile); x, dt and dy (C, tile); B and C rows (C, ds); each warp's dB/dC
// sums of each step (tile / 32, C, 32) = (C, tile).
// kernels/mamba_scan.py:working_set_bytes(mode="bwd") prices the same terms.
__host__ __device__ inline long long smem_floats(int C, int ds, int tile) {
  return (long long)(C + 1) * ds * tile + 4LL * C * tile + 2LL * C * ds;
}

// One level of the transposing butterfly: a lane keeps the half of its
// 2 * kOff values that its lane bit kOff selects, moved to v[0 .. kOff),
// plus its partner's copy of that half.
template <int kOff>
__device__ __forceinline__ void transpose_level(float (&v)[32], int lane) {
  const bool upper = (lane & kOff) != 0;
#pragma unroll
  for (int i = 0; i < kOff; ++i) {
    const float send = upper ? v[i] : v[i + kOff];
    const float keep = upper ? v[i + kOff] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

// v[0..31] summed over the warp's lanes, transposed: lane l returns the sum
// of every lane's v[l] (five levels, 31 shuffles).
__device__ __forceinline__ float warp_transpose_sum(float (&v)[32],
                                                   int lane) {
  transpose_level<16>(v, lane);
  transpose_level<8>(v, lane);
  transpose_level<4>(v, lane);
  transpose_level<2>(v, lane);
  transpose_level<1>(v, lane);
  return v[0];
}

template <typename IO>
__global__ void __launch_bounds__(kMaxTile)
    mamba_scan_bwd_kernel(
        const IO* __restrict__ x, const float* __restrict__ dt,
        const float* __restrict__ bm, const float* __restrict__ cm,
        const float* __restrict__ a, const float* __restrict__ h_traj,
        const IO* __restrict__ dy, const float* __restrict__ dh_fin,
        IO* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ db,
        float* __restrict__ dc, float* __restrict__ da,
        float* __restrict__ dh0, float* __restrict__ parts,
        float* __restrict__ da_parts, int* __restrict__ tickets, int B,
        int T, int di, int ds, int C, int block_b) {
  extern __shared__ float smem[];
  const int tile = blockDim.x;
  const int nwarps = tile / 32;
  float* sh = smem;                      // states (C + 1, ds, tile)
  float* sx = sh + (C + 1) * ds * tile;  // x window (C, tile), f32
  float* sdt = sx + C * tile;            // dt window (C, tile)
  float* sdy = sdt + C * tile;           // dy window (C, tile), f32
  float* sb = sdy + C * tile;            // B rows (C, ds)
  float* sc = sb + C * ds;               // C rows (C, ds)
  float* swp = sc + C * ds;              // warp sums (nwarps, C, 32)
  int* last = reinterpret_cast<int*>(swp);  // swp[0], between uses
  const int dl = threadIdx.x;
  const int lane = dl & 31, warp = dl >> 5;
  const int d = blockIdx.x * tile + dl;
  const bool live = d < di;  // threads past d_inner run zeros, store nothing
  const int nchunks = (T + C - 1) / C;
  const int ndt = gridDim.x;

  float arow[kMaxDs], dA[kMaxDs];
  if (live)
    mamba::load_row(a + (long long)d * ds, arow, ds);
  else
    mamba::zero_row(arow);
  mamba::zero_row(dA);

  for (int rr = 0; rr < block_b; ++rr) {
    const int row = blockIdx.y * block_b + rr;
    if (row >= B) break;  // uniform across the block
    const long long srow = ((long long)row * di + d) * ds;
    float g[kMaxDs];
    if (live)
      mamba::load_row(dh_fin + srow, g, ds);
    else
      mamba::zero_row(g);

    for (int k = nchunks - 1; k >= 0; --k) {
      const int t0 = k * C;
      const int n = min(C, T - t0);
      const long long g0 = ((long long)row * T + t0) * di + d;
      for (int i = 0; i < n; ++i) {
        const long long gi = g0 + (long long)i * di;
        sx[i * tile + dl] = live ? mamba::to_f32(x[gi]) : 0.f;
        sdt[i * tile + dl] = live ? dt[gi] : 0.f;
        sdy[i * tile + dl] = live ? mamba::to_f32(dy[gi]) : 0.f;
      }
      const long long r0 = ((long long)row * T + t0) * ds;
      for (int e = dl; e < n * ds; e += tile) {
        sb[e] = bm[r0 + e];
        sc[e] = cm[r0 + e];
      }
      // the chunk's states: its incoming one, then the state after each
      // step, recomputed with the forward's step (thread-private columns)
      float h[kMaxDs];
      if (live)
        mamba::load_row(
            h_traj + (((long long)row * nchunks + k) * di + d) * ds, h, ds);
      else
        mamba::zero_row(h);
#pragma unroll
      for (int s = 0; s < kMaxDs; ++s)
        if (s < ds) sh[s * tile + dl] = h[s];
      __syncthreads();
      for (int i = 0; i < n; ++i) {
        mamba::step(h, arow, sx[i * tile + dl], sdt[i * tile + dl],
                    sb + i * ds, sc + i * ds, ds);
#pragma unroll
        for (int s = 0; s < kMaxDs; ++s)
          if (s < ds) sh[((i + 1) * ds + s) * tile + dl] = h[s];
      }

      for (int i = n - 1; i >= 0; --i) {
        const float xv = sx[i * tile + dl], dtv = sdt[i * tile + dl];
        const float dyv = sdy[i * tile + dl];
        const float* brow = sb + i * ds;
        const float* crow = sc + i * ds;
        const float dtx = __fmul_rn(dtv, xv);
        float gb = 0.f, gha = 0.f;
        float v[32];  // this channel's dB (0 .. 15) and dC (16 .. 31) terms
#pragma unroll
        for (int s = 0; s < 32; ++s) v[s] = 0.f;
#pragma unroll
        for (int s = 0; s < kMaxDs; ++s) {
          if (s < ds) {
            const float av = mamba::decay(dtv, arow[s]);
            const float hp = sh[(i * ds + s) * tile + dl];        // h_{t-1}
            const float ht = sh[((i + 1) * ds + s) * tile + dl];  // h_t
            g[s] = __fmaf_rn(dyv, crow[s], g[s]);
            gb = __fmaf_rn(g[s], brow[s], gb);
            const float ga = __fmul_rn(__fmul_rn(g[s], hp), av);
            gha = __fmaf_rn(ga, arow[s], gha);
            dA[s] = __fmaf_rn(ga, dtv, dA[s]);
            v[s] = __fmul_rn(g[s], dtx);
            v[16 + s] = __fmul_rn(dyv, ht);
            g[s] = __fmul_rn(av, g[s]);  // a_t g_t, for the step before
          }
        }
        if (live) {
          mamba::store(dx + g0 + (long long)i * di, __fmul_rn(dtv, gb));
          ddt[g0 + (long long)i * di] = __fmaf_rn(xv, gb, gha);
        }
        swp[(warp * C + i) * 32 + lane] = warp_transpose_sum(v, lane);
      }
      __syncthreads();

      // the block's dB/dC partial of each step, its warps summed in order
      const long long pk = (long long)row * nchunks + k;
      float* part = parts + (pk * ndt + blockIdx.x) * C * 32;
      for (int e = dl; e < n * 32; e += tile) {
        const int i = e >> 5, j = e & 31;
        float sum = 0.f;
        for (int w = 0; w < nwarps; ++w) sum += swp[(w * C + i) * 32 + j];
        part[e] = sum;
      }
      __threadfence();
      __syncthreads();
      if (dl == 0) last[0] = atomicAdd(tickets + pk, 1) == ndt - 1;
      __syncthreads();
      if (last[0]) {  // every d-tile's partial of this chunk is written
        __threadfence();
        const float* first = parts + pk * ndt * C * 32;
        for (int e = dl; e < n * ds; e += tile) {
          const int i = e / ds, s = e - i * ds;
          float sb_ = 0.f, sc_ = 0.f;
          for (int j = 0; j < ndt; ++j) {
            const float* p = first + ((long long)j * C + i) * 32;
            sb_ += __ldcg(p + s);
            sc_ += __ldcg(p + 16 + s);
          }
          db[r0 + e] = sb_;
          dc[r0 + e] = sc_;
        }
      }
      __syncthreads();  // the next chunk overwrites the windows and swp
    }
    if (live) mamba::store_row(dh0 + srow, g, ds);
  }

  // dA: this row tile's partial, summed over the row tiles by the last
  if (live)
    mamba::store_row(da_parts + ((long long)blockIdx.y * di + d) * ds, dA,
                     ds);
  __threadfence();
  __syncthreads();
  if (dl == 0)
    last[0] = atomicAdd(tickets + (long long)B * nchunks + blockIdx.x, 1) ==
              (int)gridDim.y - 1;
  __syncthreads();
  if (last[0] && live) {
    __threadfence();
    for (int s = 0; s < ds; ++s) {
      float sum = 0.f;
      for (int r = 0; r < (int)gridDim.y; ++r)
        sum += __ldcg(da_parts + ((long long)r * di + d) * ds + s);
      da[(long long)d * ds + s] = sum;
    }
  }
}

template <typename IO>
int launch(const IO* x, const float* dt, const float* b, const float* c,
           const float* a, const float* h_traj, const IO* dy,
           const float* dh_fin, IO* dx, float* ddt, float* db, float* dc,
           float* da, float* dh0, float* parts, float* da_parts,
           int* tickets, int B, int T, int di, int ds, int chunk,
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
        mamba_scan_bwd_kernel<IO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((di + di_tile - 1) / di_tile,
                  (B + block_b - 1) / block_b);
  mamba_scan_bwd_kernel<IO>
      <<<grid, di_tile, (size_t)smem, (cudaStream_t)stream>>>(
          x, dt, b, c, a, h_traj, dy, dh_fin, dx, ddt, db, dc, da, dh0,
          parts, da_parts, tickets, B, T, di, ds, chunk, block_b);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy, dx (B, T, di); dt, ddt (B, T, di) f32; b, c, db, dc (B, T, ds)
// f32; a, da (di, ds) f32; h_traj (B, ceil(T / chunk), di, ds) f32;
// dh_fin, dh0 (B, di, ds) f32; all contiguous.  x, dy and dx f32
// (mamba_scan_bwd_f32) or bf16 (mamba_scan_bwd_bf16).  Workspaces: parts
// B ceil(T / chunk) ceil(di / di_tile) chunk 32 floats; da_parts
// ceil(B / block_b) di ds floats; tickets B ceil(T / chunk) +
// ceil(di / di_tile) ints, zero.  smem must equal 4 * smem_floats(chunk,
// ds, di_tile) bytes.  Grid: ceil(di / di_tile) x ceil(B / block_b) blocks
// of di_tile threads.
int mamba_scan_bwd_f32(const float* x, const float* dt, const float* b,
                       const float* c, const float* a, const float* h_traj,
                       const float* dy, const float* dh_fin, float* dx,
                       float* ddt, float* db, float* dc, float* da,
                       float* dh0, float* parts, float* da_parts,
                       int* tickets, int B, int T, int di, int ds, int chunk,
                       int block_b, int di_tile, long long smem,
                       void* stream) {
  return launch<float>(x, dt, b, c, a, h_traj, dy, dh_fin, dx, ddt, db, dc,
                       da, dh0, parts, da_parts, tickets, B, T, di, ds,
                       chunk, block_b, di_tile, smem, stream);
}

int mamba_scan_bwd_bf16(const void* x, const float* dt, const float* b,
                        const float* c, const float* a, const float* h_traj,
                        const void* dy, const float* dh_fin, void* dx,
                        float* ddt, float* db, float* dc, float* da,
                        float* dh0, float* parts, float* da_parts,
                        int* tickets, int B, int T, int di, int ds, int chunk,
                        int block_b, int di_tile, long long smem,
                        void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16>((const bf16*)x, dt, b, c, a, h_traj, (const bf16*)dy,
                      dh_fin, (bf16*)dx, ddt, db, dc, da, dh0, parts,
                      da_parts, tickets, B, T, di, ds, chunk, block_b,
                      di_tile, smem, stream);
}

const char* mamba_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
