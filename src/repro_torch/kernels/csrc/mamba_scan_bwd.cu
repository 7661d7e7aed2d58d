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
// What bounds it on the H100: at the training shapes (B = 4, T = 512,
// d_inner 16384, d_state 16, chunk 32, f32 IO) one call moves ~0.8 GB
// (x, dt, dy, dx, ddt at 134 MB each; h_traj 134 MB; the dB/dC partials
// 67 MB out and in), ~0.25 ms at 3.35 TB/s, and issues some 35 to 45
// instructions a state-step (two recomputes of the state, an exponential
// each, the reverse step and its sums) over 537 M state-steps: ~0.6 to 0.8
// ms at 132 SMs x 128 lanes.  So it is bound by issue, and the design
// keeps every lane busy.
//
// Design.
//  * Four lanes a channel, four states a lane (lane quarter q holds states
//    4q .. 4q + 3), eight channels a warp, 64 channels (256 threads) in the
//    widest block: at Jamba's width 1,024 blocks, two resident an SM, 16
//    warps each of which runs a quarter of a channel's work.  A state's
//    recurrence reads no other state, so each lane recomputes its own
//    states with mamba_math.cuh's update(), bit for bit K7t's.  The sums
//    over a channel's states (sum_s g B for dx, sum_s g h a A for ddt) take
//    two xor shuffles; dA stays in the lane's registers.
//  * The chunk's states are not staged.  A chunk of C steps (the training
//    chunk K7t's h_traj is written at) is walked in sub-chunks of kSub = 8
//    steps.  A forward pass from the chunk's incoming state stores a
//    checkpoint at each sub-chunk's start in shared memory (a float4 a
//    lane); the reverse walk then takes the sub-chunks last to first,
//    recomputes each one's states and decays into registers from its
//    checkpoint (so each step's exponential is computed once in the
//    reverse pass) and walks its steps in reverse.  Shared memory grows
//    with the chunk by its windows and a checkpoint every 8 steps, not by
//    its states, so at Jamba's width the chunk is set by K7t's windows.
//  * Each chunk's window (x, dt, dy, the B and C rows and its incoming
//    state) streams into a two-slot ring with cp.async: the next chunk's
//    is in flight while this one computes.  A chunk takes one barrier for
//    its window and one a sub-chunk for the warps' sums.
//  * dB_t and dC_t sum over d_inner.  A lane's eight terms of a step (dB
//    and dC of its four states) are summed over the warp's eight channels
//    in three levels of a transposing butterfly (4 + 2 + 1 shuffles: each
//    lane ends with one of the warp's 32 sums), the block sums its warps
//    in order for each step of a sub-chunk (the sums in two slots by
//    sub-chunk parity, so one barrier a sub-chunk) and writes the (C, 32)
//    partial
//    of its d-tile.  Once a chunk (after a __threadfence) each block draws
//    an integer ticket of its group of kGroup d-tiles; the last of a group
//    adds the group's partials in tile order, draws the (row, chunk)'s
//    ticket, and the last group adds the group sums in group order: two
//    levels of 16 reads an output instead of one of 256.  dA sums over
//    rows and steps: each block
//    keeps its sums in registers, writes them as its row tile's partial,
//    and the last of the d-tile's row tiles adds them in tile order.  No
//    float atomics, so two runs give the same bits.
// Steps past T are not run (the last chunk and sub-chunk are shorter), and
// channels past d_inner run zeros and store nothing, so no padded step or
// channel reaches dA, dB or dC.

#include <cuda_pipeline.h>

#include "mamba_math.cuh"

namespace {

using mamba::kMaxDs;

constexpr int kLanes = 4;                  // lanes a channel
constexpr int kPerLane = kMaxDs / kLanes;  // states a lane
constexpr int kSub = 8;                    // steps a sub-chunk
constexpr int kMaxChannels = 64;           // channels of the widest block
constexpr int kMaxThreads = kMaxChannels * kLanes;

// A chunk window of the ring, in bytes: dt (C, tile) f32, x and dy
// (C, tile) in the IO type, the chunk's incoming state (tile, ds) f32 and
// the B and C rows (C, ds) f32, in that order (every part before the rows
// starts at a multiple of 16 bytes: tile is a multiple of 8), rounded up
// to 16 bytes.
__host__ __device__ inline long long slot_bytes(int C, int ds, int tile,
                                                int io) {
  const long long n = (long long)C * tile * (4 + 2 * io) +
                      (long long)tile * ds * 4 + 2LL * C * ds * 4;
  return (n + 15) / 16 * 16;
}

// Shared memory of one block: the checkpoints (ceil(C / kSub), threads)
// float4, each warp's dB/dC sums of a sub-chunk's steps (2, kSub, warps,
// 32) f32 in two slots by sub-chunk parity, and the two chunk windows.
// kernels/mamba_scan.py:working_set_bytes(mode="bwd") prices the same terms.
__host__ __device__ inline long long smem_bytes(int C, int ds, int tile,
                                                int io) {
  const long long threads = (long long)tile * kLanes;
  return (long long)((C + kSub - 1) / kSub) * threads * 16 +
         2LL * kSub * threads * 4 + 2 * slot_bytes(C, ds, tile, io);
}

template <typename T>
__device__ __forceinline__ void set_zero(T* p) {
  *p = T();
}

// d-tiles a group of the two-level dB/dC sum
constexpr int kGroup = 16;

// The 4 floats of a lane's states s0 .. s0 + 3 from a row of ds floats,
// zero past ds; one 16-byte load where the row allows (rows start at a
// multiple of 16 bytes when ds is a multiple of 4).
__device__ __forceinline__ void load4(const float* row, int s0, int ds,
                                      float (&v)[kPerLane]) {
  if ((ds & 3) == 0) {
    if (s0 < ds) {
      const float4 f = *reinterpret_cast<const float4*>(row + s0);
      v[0] = f.x;
      v[1] = f.y;
      v[2] = f.z;
      v[3] = f.w;
    } else {
#pragma unroll
      for (int j = 0; j < kPerLane; ++j) v[j] = 0.f;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      v[j] = s0 + j < ds ? row[s0 + j] : 0.f;
  }
}

// One level of the transposing butterfly over lane bit kOff: a lane keeps
// the half of its 2 * kHalf values that the bit selects, moved to
// v[0 .. kHalf), plus its partner's copy of that half.
template <int kOff, int kHalf>
__device__ __forceinline__ void transpose_level(float (&v)[2 * kPerLane],
                                                int lane) {
  const bool upper = (lane & kOff) != 0;
#pragma unroll
  for (int i = 0; i < kHalf; ++i) {
    const float send = upper ? v[i] : v[i + kHalf];
    const float keep = upper ? v[i + kHalf] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kOff);
  }
}

template <typename IO>
__global__ void __launch_bounds__(kMaxThreads, 2) mamba_scan_bwd_kernel(
    const IO* __restrict__ x, const float* __restrict__ dt,
    const float* __restrict__ bm, const float* __restrict__ cm,
    const float* __restrict__ a, const float* __restrict__ h_traj,
    const IO* __restrict__ dy, const float* __restrict__ dh_fin,
    IO* __restrict__ dx, float* __restrict__ ddt, float* __restrict__ db,
    float* __restrict__ dc, float* __restrict__ da,
    float* __restrict__ dh0, float* __restrict__ parts,
    float* __restrict__ da_parts, int* __restrict__ tickets, int B, int T,
    int di, int ds, int C, int block_b, int pairs, int vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int last_flag;
  const int threads = blockDim.x;
  const int tile = threads / kLanes;  // a power of two
  const int tshift = __ffs(tile) - 1;
  const int nwarps = threads / 32;
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int q = lane & (kLanes - 1);   // the lane's quarter of the states
  const int s0 = q * kPerLane;         // its first state
  const int ch = tid / kLanes;         // its channel in the block
  const int d0 = blockIdx.x * tile;
  const int d = d0 + ch;
  const bool live = d < di;  // lanes past d_inner run zeros, store nothing
  const int nchunks = (T + C - 1) / C;
  const int ndt = gridDim.x;
  const int ngroups = (ndt + kGroup - 1) / kGroup;
  const int grp = blockIdx.x / kGroup;
  const int in_group = min(kGroup, ndt - grp * kGroup);
  constexpr int kIO = (int)sizeof(IO);
  float4* ckpt = reinterpret_cast<float4*>(smem);   // (subs, threads)
  float* sums =
      reinterpret_cast<float*>(ckpt + (size_t)((C + kSub - 1) / kSub) *
                                          threads);  // (2, kSub, warps, 32)
  unsigned char* ring =
      reinterpret_cast<unsigned char*>(sums + (size_t)2 * kSub * threads);
  const long long slot = slot_bytes(C, ds, tile, kIO);
  // where a chunk window's parts start
  auto s_dt = [&](int sl) {
    return reinterpret_cast<float*>(ring + sl * slot);
  };
  auto s_x = [&](int sl) {
    return reinterpret_cast<IO*>(s_dt(sl) + C * tile);
  };
  auto s_dy = [&](int sl) { return s_x(sl) + C * tile; };
  auto s_h = [&](int sl) {
    return reinterpret_cast<float*>(s_dy(sl) + C * tile);
  };
  auto s_b = [&](int sl) { return s_h(sl) + tile * ds; };
  auto s_c = [&](int sl) { return s_b(sl) + C * ds; };

  float arow[kPerLane], dA[kPerLane];
#pragma unroll
  for (int j = 0; j < kPerLane; ++j) {
    arow[j] = live && s0 + j < ds ? a[(long long)d * ds + s0 + j] : 0.f;
    dA[j] = 0.f;
  }
  // this lane's 8 dB/dC sums of a step land in the sum buffer's slot: m < 4
  // is dB of state s0 + m, m >= 4 dC of state s0 + m - 4 (transpose_level)
  const int m_out = (lane >> 2 & 1) | (lane >> 3 & 1) << 1 |
                    (lane >> 4 & 1) << 2;
  const int out_slot = m_out < kPerLane ? s0 + m_out
                                        : kMaxDs + s0 + m_out - kPerLane;

  for (int rr = 0; rr < block_b; ++rr) {
    const int row = blockIdx.y * block_b + rr;
    if (row >= B) break;  // uniform across the block
    const long long srow = ((long long)row * di + d) * ds;

    // Start copying chunk k's window into ring slot k mod 2: 16 bytes a
    // copy where every row allows (vec), else cp.async of 4-byte words
    // where the element allows; zeros for channels past d_inner.
    auto issue = [&](int k) {
      const int sl = k & 1;
      const int t0 = k * C;
      const int n = min(C, T - t0);
      const long long hk = (((long long)row * nchunks + k) * di + d0) * ds;
      const long long r0 = ((long long)row * T + t0) * ds;
      if (vec) {
        // a row's channels in pieces of 16 bytes (4 floats, 16 / kIO
        // elements of x and dy); pieces past d_inner are zeros
        auto rows16 = [&](auto* dst, const auto* src, int per) {
          for (int e = tid * per; e < n * tile; e += threads * per) {
            const int i = e >> tshift, c = e & (tile - 1);
            if (d0 + c < di)
              __pipeline_memcpy_async(
                  dst + e, src + ((long long)row * T + t0 + i) * di + d0 + c,
                  16);
            else
              for (int u = 0; u < per; ++u) set_zero(dst + e + u);
          }
        };
        rows16(s_dt(sl), dt, 4);
        rows16(s_x(sl), x, 16 / kIO);
        rows16(s_dy(sl), dy, 16 / kIO);
        for (int e = 4 * tid; e < tile * ds; e += 4 * threads) {
          if (d0 + e / ds < di)
            __pipeline_memcpy_async(s_h(sl) + e, h_traj + hk + e, 16);
          else
            for (int u = 0; u < 4; ++u) s_h(sl)[e + u] = 0.f;
        }
        for (int e = 4 * tid; e < n * ds; e += 4 * threads) {
          __pipeline_memcpy_async(s_b(sl) + e, bm + r0 + e, 16);
          __pipeline_memcpy_async(s_c(sl) + e, cm + r0 + e, 16);
        }
        return;
      }
      float* pdt = s_dt(sl);
      for (int e = tid; e < n * tile; e += threads) {
        const int i = e >> tshift, c = e & (tile - 1);
        const long long gi = ((long long)row * T + t0 + i) * di + d0 + c;
        if (d0 + c < di)
          __pipeline_memcpy_async(pdt + e, dt + gi, 4);
        else
          pdt[e] = 0.f;
      }
      // x and dy: whole 4-byte words, two bf16 at a time where aligned
      const int per = pairs ? 4 / kIO : 1;
      for (int e = tid * per; e < n * tile; e += threads * per) {
        const int i = e >> tshift, c = e & (tile - 1);
        const long long gi = ((long long)row * T + t0 + i) * di + d0 + c;
        for (int v = 0; v < 2; ++v) {
          const IO* src = v ? dy : x;
          IO* dst = (v ? s_dy(sl) : s_x(sl)) + e;
          if (pairs && d0 + c < di) {
            __pipeline_memcpy_async(dst, src + gi, 4);
          } else {
            for (int u = 0; u < per; ++u)
              dst[u] = d0 + c + u < di ? src[gi + u] : IO();
          }
        }
      }
      // the chunk's incoming state, K7t's h_traj row of the tile's channels
      float* ph = s_h(sl);
      for (int e = tid; e < tile * ds; e += threads) {
        if (d0 + e / ds < di)
          __pipeline_memcpy_async(ph + e, h_traj + hk + e, 4);
        else
          ph[e] = 0.f;
      }
      for (int e = tid; e < n * ds; e += threads) {
        __pipeline_memcpy_async(s_b(sl) + e, bm + r0 + e, 4);
        __pipeline_memcpy_async(s_c(sl) + e, cm + r0 + e, 4);
      }
    };

    float g[kPerLane];
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      g[j] = live && s0 + j < ds ? dh_fin[srow + s0 + j] : 0.f;

    issue(nchunks - 1);
    __pipeline_commit();
    for (int k = nchunks - 1; k >= 0; --k) {
      const int sl = k & 1;
      if (k > 0) issue(k - 1);  // its slot was last read before chunk k
      __pipeline_commit();
      __pipeline_wait_prior(1);  // this thread's copies of chunk k landed
      __syncthreads();           // and every thread's
      const int n = min(C, T - k * C);
      const int subs = (n + kSub - 1) / kSub;
      const float* pdt = s_dt(sl);
      const IO* px = s_x(sl);
      const IO* pdy = s_dy(sl);
      const float* pb = s_b(sl);
      const float* pc = s_c(sl);

      // (F) the forward pass: checkpoint 0, the chunk's incoming state,
      // then the state at the start of each later sub-chunk
      float h[kPerLane];
      load4(s_h(sl) + ch * ds, s0, ds, h);
      ckpt[tid] = make_float4(h[0], h[1], h[2], h[3]);
      for (int j = 0; j + 1 < subs; ++j) {
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          const int t = j * kSub + i;
          const float dtv = pdt[t * tile + ch];
          const float dtx = __fmul_rn(dtv, mamba::to_f32(px[t * tile + ch]));
          float bv[kPerLane];
          load4(pb + t * ds, s0, ds, bv);
#pragma unroll
          for (int u = 0; u < kPerLane; ++u)
            h[u] = mamba::update(mamba::decay(dtv, arow[u]), h[u], dtx,
                                 bv[u]);
        }
        ckpt[(j + 1) * threads + tid] = make_float4(h[0], h[1], h[2], h[3]);
      }

      // (R) the reverse walk, sub-chunks last to first: each one's states
      // and decays into registers from its checkpoint, then its steps last
      // to first
      const long long pk = (long long)row * nchunks + k;
      for (int j = subs - 1; j >= 0; --j) {
        const int m = min(kSub, n - j * kSub);
        float* sw = sums + (size_t)(j & 1) * kSub * threads;
        float hs[kSub + 1][kPerLane], as[kSub][kPerLane];
        const float4 h0 = ckpt[j * threads + tid];
        hs[0][0] = h0.x;
        hs[0][1] = h0.y;
        hs[0][2] = h0.z;
        hs[0][3] = h0.w;
#pragma unroll
        for (int i = 0; i < kSub; ++i) {
          if (i < m) {
            const int t = j * kSub + i;
            const float dtv = pdt[t * tile + ch];
            const float dtx =
                __fmul_rn(dtv, mamba::to_f32(px[t * tile + ch]));
            float bv[kPerLane];
            load4(pb + t * ds, s0, ds, bv);
#pragma unroll
            for (int u = 0; u < kPerLane; ++u) {
              as[i][u] = mamba::decay(dtv, arow[u]);
              hs[i + 1][u] = mamba::update(as[i][u], hs[i][u], dtx, bv[u]);
            }
          }
        }
        const long long g0 = ((long long)row * T + k * C + j * kSub) * di + d;
#pragma unroll
        for (int i = kSub - 1; i >= 0; --i) {
          if (i < m) {
            const int t = j * kSub + i;
            const float dtv = pdt[t * tile + ch];
            const float xv = mamba::to_f32(px[t * tile + ch]);
            const float dyv = mamba::to_f32(pdy[t * tile + ch]);
            const float dtx = __fmul_rn(dtv, xv);
            float bv[kPerLane], cv[kPerLane], v[2 * kPerLane];
            load4(pb + t * ds, s0, ds, bv);
            load4(pc + t * ds, s0, ds, cv);
            float gb = 0.f, gha = 0.f;
#pragma unroll
            for (int u = 0; u < kPerLane; ++u) {
              g[u] = __fmaf_rn(dyv, cv[u], g[u]);
              gb = __fmaf_rn(g[u], bv[u], gb);
              const float ga = __fmul_rn(__fmul_rn(g[u], hs[i][u]), as[i][u]);
              gha = __fmaf_rn(ga, arow[u], gha);
              dA[u] = __fmaf_rn(ga, dtv, dA[u]);
              v[u] = __fmul_rn(g[u], dtx);
              v[kPerLane + u] = __fmul_rn(dyv, hs[i + 1][u]);
              g[u] = __fmul_rn(as[i][u], g[u]);  // a_t g_t, the step before
            }
            // the channel's sums over its four lanes
            gb += __shfl_xor_sync(0xffffffffu, gb, 1);
            gha += __shfl_xor_sync(0xffffffffu, gha, 1);
            gb += __shfl_xor_sync(0xffffffffu, gb, 2);
            gha += __shfl_xor_sync(0xffffffffu, gha, 2);
            const long long gi = g0 + (long long)i * di;
            if (live && q == 0) mamba::store(dx + gi, __fmul_rn(dtv, gb));
            if (live && q == 1) ddt[gi] = __fmaf_rn(xv, gb, gha);
            // dB and dC over the warp's eight channels
            transpose_level<16, 4>(v, lane);
            transpose_level<8, 2>(v, lane);
            transpose_level<4, 1>(v, lane);
            sw[(i * nwarps + warp) * 32 + out_slot] = v[0];
          }
        }
        __syncthreads();  // the warps' sums of the sub-chunk are written
        // the block's dB/dC partial of each step of the sub-chunk, its
        // warps summed in order
        float* part = parts + ((pk * ndt + blockIdx.x) * C + j * kSub) * 32;
        for (int e = tid; e < m * 32; e += threads) {
          const int i = e >> 5;
          float sum = 0.f;
          for (int w = 0; w < nwarps; ++w)
            sum += sw[(i * nwarps + w) * 32 + (e & 31)];
          part[e] = sum;
        }
      }

      // the chunk's partial is whole: sum the d-tiles.  Output e of the
      // chunk's sums is step e / 32, slot e % 32 (dB of state e % 32, or
      // dC of state e % 32 - 16), summed over `cnt` partials from `src`
      // (a stride of C * 32 floats) in order; into the group partial at
      // `dst`, or into db and dc
      const long long r0 = ((long long)row * T + k * C) * ds;
      auto sum_into = [&](const float* src, int cnt, float* dst) {
        for (int e = tid; e < n * 32; e += threads) {
          float sum = __ldcg(src + e);
          for (int u = 1; u < cnt; ++u)
            sum += __ldcg(src + (size_t)u * C * 32 + e);
          const int i = e >> 5, s = e & 31;
          if (dst != nullptr)
            dst[e] = sum;
          else if (s < ds)
            db[r0 + i * ds + s] = sum;
          else if (s >= kMaxDs && s - kMaxDs < ds)
            dc[r0 + i * ds + s - kMaxDs] = sum;
        }
      };
      int* tk = tickets + pk * (ngroups + 1);
      float* gparts = parts + (long long)B * nchunks * ndt * C * 32;
      __threadfence();
      __syncthreads();
      if (tid == 0) last_flag = atomicAdd(tk + grp, 1) == in_group - 1;
      __syncthreads();
      if (last_flag) {  // the group's tiles in tile order
        __threadfence();
        sum_into(parts + (pk * ndt + grp * kGroup) * C * 32, in_group,
                 ngroups > 1 ? gparts + (pk * ngroups + grp) * C * 32
                             : nullptr);
        if (ngroups > 1) {
          __threadfence();
          __syncthreads();
          if (tid == 0)
            last_flag = atomicAdd(tk + ngroups, 1) == ngroups - 1;
          __syncthreads();
          if (last_flag) {  // the groups in group order
            __threadfence();
            sum_into(gparts + pk * ngroups * C * 32, ngroups, nullptr);
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kPerLane; ++j)
      if (live && s0 + j < ds) dh0[srow + s0 + j] = g[j];
  }

  // dA: this row tile's partial, summed over the row tiles by the last
#pragma unroll
  for (int j = 0; j < kPerLane; ++j)
    if (live && s0 + j < ds)
      da_parts[((long long)blockIdx.y * di + d) * ds + s0 + j] = dA[j];
  __threadfence();
  __syncthreads();
  if (tid == 0)
    last_flag = atomicAdd(tickets + (long long)B * nchunks * (ngroups + 1) +
                              blockIdx.x,
                          1) == (int)gridDim.y - 1;
  __syncthreads();
  if (last_flag) {
    __threadfence();
#pragma unroll
    for (int j = 0; j < kPerLane; ++j) {
      if (live && s0 + j < ds) {
        float sum = 0.f;
        for (int r = 0; r < (int)gridDim.y; ++r)
          sum += __ldcg(da_parts + ((long long)r * di + d) * ds + s0 + j);
        da[(long long)d * ds + s0 + j] = sum;
      }
    }
  }
}

// The kernel's shared-memory attributes: room for smem bytes, and the
// largest shared-memory carveout, so that two blocks share an SM.
template <typename IO>
cudaError_t configure(long long smem) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        mamba_scan_bwd_kernel<IO>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  return cudaFuncSetAttribute(mamba_scan_bwd_kernel<IO>,
                              cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename IO>
int launch(const IO* x, const float* dt, const float* b, const float* c,
           const float* a, const float* h_traj, const IO* dy,
           const float* dh_fin, IO* dx, float* ddt, float* db, float* dc,
           float* da, float* dh0, float* parts, float* da_parts,
           int* tickets, int B, int T, int di, int ds, int chunk,
           int block_b, int di_tile, long long smem, void* stream) {
  if (B < 1 || T < 1 || di < 1 || ds < 1 || ds > kMaxDs || chunk < 1 ||
      chunk > T || block_b < 1 || di_tile < 8 || di_tile > kMaxChannels ||
      (di_tile & (di_tile - 1)) != 0)
    return (int)cudaErrorInvalidValue;
  // the wrapper's budget table must price exactly this launch
  if (smem != smem_bytes(chunk, ds, di_tile, (int)sizeof(IO)))
    return (int)cudaErrorInvalidValue;
  const cudaError_t e = configure<IO>(smem);
  if (e != cudaSuccess) return (int)e;
  // bf16 x and dy copy two at a time when every pair is 4-byte aligned;
  // every window copies 16 bytes at a time when every row piece is
  // 16-byte aligned
  const int pairs =
      sizeof(IO) == 4 ||
      (di % 2 == 0 && reinterpret_cast<uintptr_t>(x) % 4 == 0 &&
       reinterpret_cast<uintptr_t>(dy) % 4 == 0);
  auto al16 = [](const void* p) {
    return reinterpret_cast<uintptr_t>(p) % 16 == 0;
  };
  const int vec = di % 8 == 0 && ds % 4 == 0 && al16(x) && al16(dt) &&
                  al16(dy) && al16(b) && al16(c) && al16(h_traj);
  const dim3 grid((di + di_tile - 1) / di_tile,
                  (B + block_b - 1) / block_b);
  mamba_scan_bwd_kernel<IO>
      <<<grid, di_tile * kLanes, (size_t)smem, (cudaStream_t)stream>>>(
          x, dt, b, c, a, h_traj, dy, dh_fin, dx, ddt, db, dc, da, dh0,
          parts, da_parts, tickets, B, T, di, ds, chunk, block_b, pairs,
          vec);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, dy, dx (B, T, di); dt, ddt (B, T, di) f32; b, c, db, dc (B, T, ds)
// f32; a, da (di, ds) f32; h_traj (B, ceil(T / chunk), di, ds) f32;
// dh_fin, dh0 (B, di, ds) f32; all contiguous.  x, dy and dx f32
// (mamba_scan_bwd_f32) or bf16 (mamba_scan_bwd_bf16).  Workspaces, with
// n = ceil(di / di_tile) d-tiles in g = ceil(n / 16) groups: parts
// B ceil(T / chunk) (n + g) chunk 32 floats; da_parts ceil(B / block_b)
// di ds floats; tickets B ceil(T / chunk) (g + 1) + n ints, zero.
// di_tile is the channels of a block, a power of two from 8 to 64 (4
// threads each); smem must equal
// mamba_scan_bwd_smem_bytes(chunk, ds, di_tile, IO bytes).  Grid:
// ceil(di / di_tile) x ceil(B / block_b) blocks of 4 di_tile threads.
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

// The dynamic shared memory a launch at (chunk, d_state, di_tile, IO
// bytes) must ask for: what kernels/mamba_scan.py's table is held to.
long long mamba_scan_bwd_smem_bytes(int chunk, int ds, int di_tile, int io) {
  return smem_bytes(chunk, ds, di_tile, io);
}

// Blocks of di_tile channels an SM holds at once with smem bytes of shared
// memory (IO bytes io), as the runtime's occupancy calculator sees the
// kernel; a negative CUDA error code on failure.
int mamba_scan_bwd_blocks_per_sm(int io, int di_tile, long long smem) {
  int n = 0;
  cudaError_t e;
  if (io == 2) {
    e = configure<__nv_bfloat16>(smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, mamba_scan_bwd_kernel<__nv_bfloat16>, di_tile * kLanes,
          (size_t)smem);
  } else {
    e = configure<float>(smem);
    if (e == cudaSuccess)
      e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, mamba_scan_bwd_kernel<float>, di_tile * kLanes, (size_t)smem);
  }
  return e == cudaSuccess ? n : -(int)e;
}

const char* mamba_scan_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
