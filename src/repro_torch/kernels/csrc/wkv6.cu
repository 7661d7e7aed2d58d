// RWKV6 chunked scan (K6) and its trajectory-writing instance (K6t), f32
// and bf16 IO, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels kernels/wkv6.py:_kernel and
// _traj_kernel (body _fwd_body, chunk math _chunk_math), launched by
// _fwd_call: the RWKV6 recurrence
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t,
//   out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
// over whole sequences, one batch-head row at a time, in chunks of C steps.
// Per chunk, with L = cumsum(logw) and Lp_i = L_{i-1} (0 at the first step):
//   out = (r * e^{Lp}) S + A v,  A_ij = sum_c r_ic k_jc e^{Lp_ic - L_jc}
//         (j < i), A_ii = r_i . u . k_i
//   S'  = e^{Llast} * S + (k * e^{Llast - L})^T v
// Every exponent is a difference of cumsums with the later one subtracted,
// so it is <= 0 and exp never overflows, whatever the decay; A's entries
// away from the diagonal sub-blocks come from factors of such exponents
// (csrc/wkv6_math.cuh), so the masked (j >= i) scores are never computed.
//
// What bounds it on the H100: at the serving shapes (160 rows of 64 x 64
// heads, T = 512, C = 32) one call moves ~68 MB with bf16 IO (~105 MB f32)
// and does ~1.75 GFLOP of products plus the decays, so the bytes bound it
// at ~20 us and the f32 operations at ~26 us.  Its real limit is
// narrower: the chunks of a row run in order, so only 160 blocks exist, a
// little over one per SM, and each block's time is its own chunks' chain:
// per chunk ~330 K multiply-adds on one SM, fed from shared memory.
//
// Design: one thread block of 256 threads per batch-head row (a tile of
// bh_tile rows runs them one after another, each exactly as alone, so a
// row's results never depend on what shares its block).  The f32 (dk, dv)
// state stays in shared memory for the whole scan and is written once at
// the end (the paper's preallocated-state rule).  Per chunk, five phases
// between barriers:
//   (0) the chunk's windows into f32 tiles, read straight from global
//       memory, every load of a thread issued before it waits;
//   (1) L by warp scans;
//   (2) the factors r * alpha, k * beta, r * e^{Lp}, k * e^{Llast - L},
//       gamma and the bonus (wkv6_math.cuh: prep);
//   (3) A: its blocks below the diagonal sub-blocks as 2 x 2 register
//       tiles of factored products, the diagonal sub-blocks' decays each
//       taken once (scores, diag_pass);
//   (4) out = (r e^{Lp}) S + A v, 2 x 4 register tiles;
//   (5) S <- e^{Llast} S + (k e^{Llast - L})^T v, 4 x 4 register tiles.
// Steps past T are identity steps (r = k = v = 0, logw = 0).  All
// accumulation is f32.  At 64 x 64, C = 32 a block needs 89,368 bytes,
// two blocks an SM (kernels/wkv6.py: working_set_bytes prices each term).
//
// K6t (kTraj = true) is the same kernel with one more output: before each
// chunk it writes the block's state, the state the chunk starts from, to
// s_traj[row][chunk] (f32), the residual the backward (csrc/wkv6_bwd.cu)
// recomputes each chunk from.  It reads the state and writes nothing the
// chunk loop reads, so its out and final state are bit for bit K6's (the
// JAX contract of _kernel and _traj_kernel); it adds T / C * dk * dv * 4
// bytes a row of stores, 42 MB at the serving shapes.

#include "wkv6_math.cuh"

namespace {

using namespace wkv;

template <typename IO, bool kTraj>
__global__ void __launch_bounds__(kThreads, 2)
    wkv6_kernel(const IO* __restrict__ r, const IO* __restrict__ k,
                const IO* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ s0,
                IO* __restrict__ out, float* __restrict__ s_out,
                float* __restrict__ s_traj, int BH, int T, int dk, int dv,
                int C, int bh_tile) {
  extern __shared__ __align__(16) float f[];
  const Dims d = dims(C, dk, dv);
  const Layout lay = layout(false, d);
  float *R = f + lay.R, *K = f + lay.K, *L = f + lay.L, *Ra = f + lay.Ra,
        *Kb = f + lay.Kb, *RE = f + lay.RE, *KD = f + lay.KD, *V = f + lay.V,
        *A = f + lay.A, *S = f + lay.S, *G = f + lay.G, *su = f + lay.u,
        *b = f + lay.b;
  const int pk = d.pk, pv = d.pv, pc = d.pc;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int nchunks = (T + C - 1) / C;

  for (int rr = 0; rr < bh_tile; ++rr) {
    const int row = blockIdx.x * bh_tile + rr;
    if (row >= BH) break;  // uniform across the block
    const long long kbase = (long long)row * T * dk;
    const long long vbase = (long long)row * T * dv;
    const long long sbase = (long long)row * dk * dv;
    copy_rows(S, pv, s0 + sbase, dk, dk, dv, tid);
    __pipeline_commit();
    for (int e = tid; e < dk; e += kThreads) su[e] = u[(long long)row * dk + e];
    __pipeline_wait_prior(0);
    __syncthreads();

    for (int ch = 0; ch < nchunks; ++ch) {
      const int t0 = ch * C, n = min(C, T - t0);
      // (0) the chunk's windows as f32 tiles; K6t: the state it starts from
      copy_rows(L, pk, logw + kbase + (long long)t0 * dk, n, C, dk, tid);
      __pipeline_commit();
      {
        float* const rk[2] = {R, K};
        const IO* const rk_src[2] = {r + kbase + (long long)t0 * dk,
                                     k + kbase + (long long)t0 * dk};
        load_rows(rk, pk, rk_src, n, C, dk, tid);
        float* const vt[1] = {V};
        const IO* const v_src[1] = {v + vbase + (long long)t0 * dv};
        load_rows(vt, pv, v_src, n, C, dv, tid);
      }
      __pipeline_wait_prior(0);
      if (kTraj)
        store_rows(s_traj + ((long long)row * nchunks + ch) * dk * dv, S, pv,
                   dk, dv, warp, lane);
      __syncthreads();

      // (1) L down each column
      scan_cols(L, C, dk, pk, warp, lane);
      __syncthreads();

      // (2) the decay factors and the bonus
      prep(d, R, K, L, su, Ra, Kb, RE, KD, G, b, warp, lane);
      __syncthreads();

      // (3) the scores A
      scores(d, Ra, Kb, G, b, A, nullptr, nullptr, false, tid);
      diag_pass<false>(d, R, K, L, A, nullptr, nullptr, warp, lane);
      __syncthreads();

      // (4) out = (r e^{Lp}) S + A v, 2 x 4 tiles of (C, dv)
      for (int t = tid; t < tiles<2, 4>(C, dv); t += kThreads) {
        const Tile<2, 4> w(t, C, dv);
        int oa[2], ob[4], oA[2];
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          oa[x] = w.mc(x, C) * pk;
          oA[x] = w.mc(x, C) * pc;
        }
#pragma unroll
        for (int y = 0; y < 4; ++y) ob[y] = w.nc(y, dv);
        float acc[2][4];
        zero(acc);
        tile_mac(acc, RE, oa, 1, S, ob, pv, 0, dk);
        // A is zero above the diagonal: j runs to the tile's last row
        tile_mac(acc, A, oA, 1, V, ob, pv, 0, min(C, w.m[1] + 1));
#pragma unroll
        for (int x = 0; x < 2; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const int i = w.m[x], m = w.n[y];
            if (i < n && m < dv)
              store(out + vbase + (long long)(t0 + i) * dv + m, acc[x][y]);
          }
      }
      __syncthreads();  // every read of the old state is done

      // (5) S <- e^{Llast} S + (k e^{Llast - L})^T v, 4 x 4 tiles of (dk, dv)
      for (int t = tid; t < tiles<4, 4>(dk, dv); t += kThreads) {
        const Tile<4, 4> w(t, dk, dv);
        int oa[4], ob[4];
        float acc[4][4];
#pragma unroll
        for (int x = 0; x < 4; ++x) oa[x] = w.mc(x, dk);
#pragma unroll
        for (int y = 0; y < 4; ++y) ob[y] = w.nc(y, dv);
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const float decay = exp_le0(L[(C - 1) * pk + oa[x]]);
#pragma unroll
          for (int y = 0; y < 4; ++y) acc[x][y] = decay * S[oa[x] * pv + ob[y]];
        }
        tile_mac(acc, KD, oa, pk, V, ob, pv, 0, C);
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y)
            if (w.m[x] < dk && w.n[y] < dv)
              S[w.m[x] * pv + w.n[y]] = acc[x][y];
      }
      __syncthreads();  // the next chunk overwrites the tiles
    }
    store_rows(s_out + sbase, S, pv, dk, dv, warp, lane);
    __syncthreads();  // the next row overwrites the state
  }
}

template <typename IO, bool kTraj>
int launch(const IO* r, const IO* k, const IO* v, const float* logw,
           const float* u, const float* s0, IO* out, float* s_out,
           float* s_traj, int BH, int T, int dk, int dv, int chunk,
           int bh_tile, long long smem, void* stream) {
  if (BH < 1 || T < 0 || chunk < 1 || bh_tile < 1 || dk < 1 || dv < 1 ||
      dk > kThreads || dv > kThreads)
    return (int)cudaErrorInvalidValue;
  // the wrapper's budget table must price exactly this launch
  if (smem != layout(false, dims(chunk, dk, dv)).bytes)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_kernel<IO, kTraj>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (BH + bh_tile - 1) / bh_tile;
  wkv6_kernel<IO, kTraj>
      <<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
          r, k, v, logw, u, s0, out, s_out, s_traj, BH, T, dk, dv, chunk,
          bh_tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, logw (BH, T, dk); v, out (BH, T, dv); u (BH, dk); s0, s_out
// (BH, dk, dv); all contiguous.  logw, u and the states are f32; r, k, v
// and out f32 (wkv6_f32) or bf16 (wkv6_bf16).  smem must equal the
// block's shared memory in the layout of wkv6_math.cuh, as
// kernels/wkv6.py:working_set_bytes prices it.
// Grid: ceil(BH / bh_tile) blocks of 256 threads.  The _traj entries (K6t)
// also write s_traj (BH, ceil(T / chunk), dk, dv) f32.
int wkv6_f32(const float* r, const float* k, const float* v,
             const float* logw, const float* u, const float* s0, float* out,
             float* s_out, int BH, int T, int dk, int dv, int chunk,
             int bh_tile, long long smem, void* stream) {
  return launch<float, false>(r, k, v, logw, u, s0, out, s_out, nullptr, BH,
                              T, dk, dv, chunk, bh_tile, smem, stream);
}

int wkv6_bf16(const void* r, const void* k, const void* v, const float* logw,
              const float* u, const float* s0, void* out, float* s_out,
              int BH, int T, int dk, int dv, int chunk, int bh_tile,
              long long smem, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16, false>((const bf16*)r, (const bf16*)k, (const bf16*)v,
                             logw, u, s0, (bf16*)out, s_out, nullptr, BH, T,
                             dk, dv, chunk, bh_tile, smem, stream);
}

int wkv6_traj_f32(const float* r, const float* k, const float* v,
                  const float* logw, const float* u, const float* s0,
                  float* out, float* s_out, float* s_traj, int BH, int T,
                  int dk, int dv, int chunk, int bh_tile, long long smem,
                  void* stream) {
  return launch<float, true>(r, k, v, logw, u, s0, out, s_out, s_traj, BH,
                             T, dk, dv, chunk, bh_tile, smem, stream);
}

int wkv6_traj_bf16(const void* r, const void* k, const void* v,
                   const float* logw, const float* u, const float* s0,
                   void* out, float* s_out, float* s_traj, int BH, int T,
                   int dk, int dv, int chunk, int bh_tile, long long smem,
                   void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16, true>((const bf16*)r, (const bf16*)k, (const bf16*)v,
                            logw, u, s0, (bf16*)out, s_out, s_traj, BH, T,
                            dk, dv, chunk, bh_tile, smem, stream);
}

const char* wkv6_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
