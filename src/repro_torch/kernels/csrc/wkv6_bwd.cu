// RWKV6 chunked-scan backward (K6b), f32 and bf16 IO, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/wkv6.py:_bwd_kernel,
// launched by _bwd_call: the whole reverse-time sweep of the chunked scan
// of csrc/wkv6.cu in one launch.  The Pallas body gets each chunk's
// backward from jax.vjp of the chunk math; here it is derived by hand
// (kernels/wkv6.py's docstring has the formulas, wkv6_bwd_plain the same
// sums in plain PyTorch).  Per chunk, in reverse order, with
// L = cumsum(logw), the chunk's incoming state S (from s_traj, written by
// the trajectory instance of the forward) and the cotangents dO of its
// output and dS' of its outgoing state:
//   A_ij  = sum_c r_ic k_jc e^{L_{i-1,c} - L_jc} (j < i), A_ii = r_i.u.k_i
//   dA_ij = dO_i . v_j (j <= i)
//   dv_j  = sum_{i>=j} A_ij dO_i + sum_c k_jc e^{Llast_c - L_jc} dS'_c
//   dk_jc = sum_{i>j} dA_ij r_ic e^{L_{i-1,c} - L_jc}
//           + e^{Llast_c - L_jc} (v_j . dS'_c) + dA_jj u_c r_jc
//   dr_ic = e^{L_{i-1,c}} (S dO_i)_c
//           + sum_{j<i} dA_ij k_jc e^{L_{i-1,c} - L_jc} + dA_ii u_c k_ic
//   du_c += sum_i dA_ii r_ic k_ic
//   dlogw_m = sum_{i>=m} G_i, G_i = -k_i (dk_i - bonus) + r_{i+1} (dr_{i+1}
//           - bonus) [+ sum_n S'_cn dS'_cn on row C-1, S' the state the
//           chunk hands on: the next chunk's s_traj entry, or s_fin]
//   dS    = e^{Llast} * dS' + (r * e^{L_prev})^T dO, carried to the chunk
//           before; the first chunk's is ds0.
// L_prev of step i is L_{i-1} (0 for the first step).  Every exponent is a
// difference of two cumsums with the later one subtracted, or a factor of
// one (csrc/wkv6_math.cuh), clamped at 0, so exp never overflows,
// whatever the decay.  Steps past T are identity steps (r = k = v = dO =
// 0, logw = 0) and write nothing.
//
// What bounds it on the H100: at the training shapes (160 rows of 64 x 64
// heads, T = 512, C = 32, bf16 IO) one call moves ~165 MB (r, k, v, dO
// and dr, dk, dv in bf16, logw and dlogw in f32, s_traj's 42 MB of f32
// states) and needs ~4.0 G f32 operations, so the operations bound it at
// ~60 us and the bytes at ~49 us.  Its real limit is narrower: the chunks
// of a row run in order, so only 160 blocks exist, and each block's time
// is its own chunks' chain, ~700 K multiply-adds a chunk on one SM, fed
// from shared memory.
//
// Design: one thread block of 256 threads per batch-head row (a tile of
// bh_tile rows runs them one after another, each exactly as alone), chunks
// in reverse order.  The state cotangent dS is carried in shared memory
// for the whole sweep, seeded from ds_fin; du is carried in shared memory;
// every output of a row is written by its own block and each is summed by
// one thread in a fixed order, so there are no atomics and two runs are
// bit-identical.  Per chunk, nine phases between barriers:
//   (0) the chunk's windows and its incoming state into f32 tiles, read
//       straight from global memory, every load of a thread issued before
//       it waits; the previous chunk's dlogw out;
//   (1) L by warp scans;
//   (2) the factors r * alpha, k * beta, gamma, the bonus b and
//       db_i = dO_i . v_i;
//   (3) A below the diagonal sub-blocks and dA = dO v^T (kept transposed
//       above A's diagonal), 2 x 2 tiles;
//   (4) the diagonal sub-blocks: each decay once, for A, dr and dk;
//   (5) dr (half the block) and dk (the other half), 4 x 4 tiles: the
//       carry S dO and the state term v . dS', the factored intra-chunk
//       sums segment by segment with gamma folded into the operand, then
//       the bonus terms and G's two inputs;
//   (5b) r * e^{Lp} and k * e^{Llast - L}, into the tiles of r * alpha and
//       k * beta, which (5) was the last to read;
//   (6) dv on the whole block, then, after a barrier, the dS update in
//       place;
//   (7) dlogw's reverse cumsum by warp scans, du, and Llast's term of the
//       chunk before (sum_n S dS).
// At 64 x 64, C = 32 a block needs 115,224 bytes, two blocks an SM, so
// all 160 rows run at once.  Heads of 128 train at C = 16 (210,180
// bytes).  kernels/wkv6.py: working_set_bytes (mode="bwd") prices each
// term.

#include "wkv6_math.cuh"

namespace {

using namespace wkv;

// dv_j = sum_{i>=j} A_ij dO_i + sum_c (k e^{Llast - L})_jc dS'_c for the
// chunk's n live rows, TM x 4 tiles of (C, dv), one a thread at a time.
// A's upper triangle holds dA, so the tile's first rows take their
// i < j0 + TM - 1 terms masked.
template <typename IO>
__device__ __forceinline__ void dv_tiles(const Dims& d, const float* A,
                                         const float* DO, const float* KD,
                                         const float* dS, IO* gv, int n,
                                         int tid) {
  constexpr int TM = 2;
  const int C = d.C, dv = d.dv;
  for (int t = tid; t < tiles<TM, 4>(C, dv); t += kThreads) {
    const Tile<TM, 4> w(t, C, dv);
    int oA[TM], oK[TM], on[4];
#pragma unroll
    for (int x = 0; x < TM; ++x) {
      oA[x] = w.mc(x, C);
      oK[x] = w.mc(x, C) * d.pk;
    }
#pragma unroll
    for (int y = 0; y < 4; ++y) on[y] = w.nc(y, dv);
    float acc[TM][4];
    zero(acc);
    const int i1 = min(C, w.m[0] + TM - 1);
    for (int i = w.m[0]; i < i1; ++i)
#pragma unroll
      for (int x = 0; x < TM; ++x)
        if (i >= w.m[x])
#pragma unroll
          for (int y = 0; y < 4; ++y)
            acc[x][y] = fmaf(A[i * d.pc + oA[x]], DO[i * d.pv + on[y]],
                             acc[x][y]);
    tile_mac(acc, A, oA, d.pc, DO, on, d.pv, i1, C);
    tile_mac(acc, KD, oK, 1, dS, on, d.pv, 0, d.dk);
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < 4; ++y)
        if (w.m[x] < n && w.n[y] < dv)
          store(gv + (long long)w.m[x] * dv + w.n[y], acc[x][y]);
  }
}

// Tile t (4 x 4 of (dk, dv)) of dS <- e^{Llast} dS' + (r e^{Lp})^T dO, in
// place: each output it writes depends on its own entry of dS' alone.
__device__ __forceinline__ void ds_update(const Dims& d, const float* L,
                                          const float* RE, const float* DO,
                                          float* dS, int t) {
  const Tile<4, 4> w(t, d.dk, d.dv);
  int oc[4], on[4];
#pragma unroll
  for (int x = 0; x < 4; ++x) oc[x] = w.mc(x, d.dk);
#pragma unroll
  for (int y = 0; y < 4; ++y) on[y] = w.nc(y, d.dv);
  float acc[4][4];
#pragma unroll
  for (int x = 0; x < 4; ++x) {
    const float decay = exp_le0(L[(d.C - 1) * d.pk + oc[x]]);
#pragma unroll
    for (int y = 0; y < 4; ++y) acc[x][y] = decay * dS[oc[x] * d.pv + on[y]];
  }
  tile_mac(acc, RE, oc, d.pk, DO, on, d.pv, 0, d.C);
#pragma unroll
  for (int x = 0; x < 4; ++x)
#pragma unroll
    for (int y = 0; y < 4; ++y)
      if (w.m[x] < d.dk && w.n[y] < d.dv)
        dS[w.m[x] * d.pv + w.n[y]] = acc[x][y];
}

template <typename IO>
__global__ void __launch_bounds__(kThreads, 2)
    wkv6_bwd_kernel(const IO* __restrict__ r, const IO* __restrict__ k,
                    const IO* __restrict__ v, const float* __restrict__ logw,
                    const float* __restrict__ u,
                    const float* __restrict__ s_traj,
                    const float* __restrict__ s_fin,
                    const IO* __restrict__ dout,
                    const float* __restrict__ ds_fin, IO* __restrict__ gr,
                    IO* __restrict__ gk, IO* __restrict__ gv,
                    float* __restrict__ glogw, float* __restrict__ gu,
                    float* __restrict__ gs0, int BH, int T, int dk, int dv,
                    int C, int bh_tile) {
  extern __shared__ __align__(16) float f[];
  const Dims d = dims(C, dk, dv);
  const Layout lay = layout(true, d);
  float *R = f + lay.R, *K = f + lay.K, *L = f + lay.L, *Ra = f + lay.Ra,
        *Kb = f + lay.Kb, *RE = f + lay.RE, *KD = f + lay.KD,
        *GR = f + lay.GR, *GK = f + lay.GK, *V = f + lay.V, *DO = f + lay.DO,
        *A = f + lay.A, *S = f + lay.S, *dS = f + lay.dS, *G = f + lay.G,
        *su = f + lay.u, *lt = f + lay.lt, *du = f + lay.du, *b = f + lay.b,
        *db = f + lay.db;
  const int pk = d.pk, pv = d.pv, pc = d.pc, s = d.s, ns = d.ns;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int half = tid / (kThreads / 2), ht = tid % (kThreads / 2);
  const int nchunks = (T + C - 1) / C;

  for (int rr = 0; rr < bh_tile; ++rr) {
    const int row = blockIdx.x * bh_tile + rr;
    if (row >= BH) break;  // uniform across the block
    const long long kbase = (long long)row * T * dk;
    const long long vbase = (long long)row * T * dv;
    const long long sbase = (long long)row * dk * dv;
    const float* traj = s_traj + (long long)row * nchunks * dk * dv;

    // the last chunk's Llast term, from the state it hands on (s_fin)
    copy_rows(dS, pv, ds_fin + sbase, dk, dk, dv, tid);
    copy_rows(S, pv, s_fin + sbase, dk, dk, dv, tid);
    __pipeline_commit();
    __pipeline_wait_prior(0);
    for (int e = tid; e < dk; e += kThreads) {
      su[e] = u[(long long)row * dk + e];
      du[e] = 0.f;
    }
    __syncthreads();
    for (int c = warp; c < dk; c += kWarps) {
      float x = 0.f;
      for (int m = lane; m < dv; m += 32)
        x = fmaf(S[c * pv + m], dS[c * pv + m], x);
      x = warp_sum(x);
      if (lane == 0) lt[((nchunks - 1) & 1) * dk + c] = x;
    }
    __syncthreads();

    int prev_t0 = -1;  // the chunk whose dlogw is still in GK
    for (int ch = nchunks - 1; ch >= 0; --ch) {
      const int t0 = ch * C, n = min(C, T - t0);
      // (0) the chunk's windows and incoming state; the later chunk's dlogw
      copy_rows(L, pk, logw + kbase + (long long)t0 * dk, n, C, dk, tid);
      copy_rows(S, pv, traj + (long long)ch * dk * dv, dk, dk, dv, tid);
      __pipeline_commit();
      {
        float* const rk[2] = {R, K};
        const IO* const rk_src[2] = {r + kbase + (long long)t0 * dk,
                                     k + kbase + (long long)t0 * dk};
        load_rows(rk, pk, rk_src, n, C, dk, tid);
        float* const vd[2] = {V, DO};
        const IO* const vd_src[2] = {v + vbase + (long long)t0 * dv,
                                     dout + vbase + (long long)t0 * dv};
        load_rows(vd, pv, vd_src, n, C, dv, tid);
      }
      __pipeline_wait_prior(0);
      if (prev_t0 >= 0)
        store_rows(glogw + kbase + (long long)prev_t0 * dk, GK, pk,
                   min(C, T - prev_t0), dk, warp, lane);
      __syncthreads();

      // (1) L down each column
      scan_cols(L, C, dk, pk, warp, lane);
      __syncthreads();

      // (2) the decay factors, the bonus b and db_i = dO_i . v_i
      prep(d, R, K, L, su, Ra, Kb, nullptr, nullptr, G, b, warp, lane);
      for (int i = warp; i < C; i += kWarps) {
        float x = 0.f;
        for (int m = lane; m < dv; m += 32)
          x = fmaf(DO[i * pv + m], V[i * pv + m], x);
        x = warp_sum(x);
        if (lane == 0) db[i] = x;
      }
      __syncthreads();

      // (3) A below the diagonal sub-blocks, dA = dO v^T above it
      scores(d, Ra, Kb, G, b, A, DO, V, true, tid);
      __syncthreads();

      // (4) the diagonal sub-blocks: A, and dr's and dk's terms into GR, GK
      diag_pass<true>(d, R, K, L, A, GR, GK, warp, lane);
      __syncthreads();

      // (5) dr_ic (half 0) and dk_jc (half 1), 4 x 4 tiles of (C, dk)
      for (int t = ht; t < tiles<4, 4>(C, dk); t += kThreads / 2) {
        const Tile<4, 4> w(t, C, dk);
        const int I = w.m[0] / s;  // the tile's rows share a sub-chunk
        int orow[4], oc[4], odA[4], ocol[4];
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          orow[x] = w.mc(x, C) * pv;
          odA[x] = w.mc(x, C) * (half == 0 ? 1 : pc);  // dA_ij at A[j][i]
        }
#pragma unroll
        for (int y = 0; y < 4; ++y) {
          oc[y] = w.nc(y, dk) * pv;
          ocol[y] = w.nc(y, dk);
        }
        float dot[4][4], off[4][4], g[4];
        zero(dot);
        zero(off);
        if (half == 0) {
          // carry (S dO_i)_c; then sum_{J<I} gamma_IJ (dA_IJ (k beta)_J)
          tile_mac(dot, DO, orow, 1, S, oc, 1, 0, dv);
          for (int J = 0; J < I; ++J) {
#pragma unroll
            for (int y = 0; y < 4; ++y) g[y] = G[pair(I, J) * pk + ocol[y]];
            tile_mac_scaled(off, A, odA, pc, Kb, ocol, pk, g, J * s,
                            J * s + s);
          }
        } else {
          // state term v_j . dS'_c; then
          // sum_{I>J} gamma_IJ (dA_IJ^T (r alpha)_I)
          tile_mac(dot, V, orow, 1, dS, oc, 1, 0, dv);
          for (int J2 = I + 1; J2 < ns; ++J2) {
#pragma unroll
            for (int y = 0; y < 4; ++y) g[y] = G[pair(J2, I) * pk + ocol[y]];
            tile_mac_scaled(off, A, odA, 1, Ra, ocol, pk, g, J2 * s,
                            min(C, J2 * s + s));
          }
        }
#pragma unroll
        for (int x = 0; x < 4; ++x)
#pragma unroll
          for (int y = 0; y < 4; ++y) {
            const int i = w.m[x], c = w.n[y];
            if (i >= C || c >= dk) continue;
            const int e = i * pk + c;
            const float Li = L[e];
            const float Lp = i > 0 ? L[e - pk] : 0.f;
            float nb;
            if (half == 0) {
              const float alpha =
                  I > 0 ? exp_le0(Lp - L[(I * s - 1) * pk + c]) : 0.f;
              nb = fmaf(exp_le0(Lp), dot[x][y], fmaf(alpha, off[x][y], GR[e]));
              if (i < n)
                store(gr + kbase + (long long)(t0 + i) * dk + c,
                      fmaf(db[i] * su[c], K[e], nb));
              GR[e] = R[e] * nb;
            } else {
              const float beta =
                  I < ns - 1
                      ? exp_le0(L[(min(C, I * s + s) - 1) * pk + c] - Li)
                      : 0.f;
              nb = fmaf(exp_le0(L[(C - 1) * pk + c] - Li), dot[x][y],
                        fmaf(beta, off[x][y], GK[e]));
              if (i < n)
                store(gk + kbase + (long long)(t0 + i) * dk + c,
                      fmaf(db[i] * su[c], R[e], nb));
              GK[e] = -K[e] * nb;
            }
          }
      }
      __syncthreads();

      // (5b) r e^{Lp} and k e^{Llast - L}, into the tiles of r alpha, k beta
      decay_operands(d, R, K, L, RE, KD, warp, lane);
      __syncthreads();

      // (6) dv_jn in 2 x 4 tiles of (C, dv); then, once every read of dS'
      // is done, the dS update in place, 4 x 4 tiles of (dk, dv)
      dv_tiles(d, A, DO, KD, dS, gv + vbase + (long long)t0 * dv, n, tid);
      __syncthreads();
      for (int t = tid; t < tiles<4, 4>(dk, dv); t += kThreads)
        ds_update(d, L, RE, DO, dS, t);
      __syncthreads();

      // (7) dlogw_m = sum_{i>=m} G_i, G_i = GK_i + GR_{i+1} (+ Llast's term
      // on row C-1), into GK; du; Llast's term of the chunk before
      {
        const float* ltc = lt + (ch & 1) * dk;
        for (int c = warp; c < dk; c += kWarps) {
          float carry = 0.f, dsum = 0.f;
          for (int base = 0; base < C; base += 32) {
            const int i = C - 1 - base - lane;  // rows from the last up
            float g = 0.f;
            if (i >= 0) {
              g = GK[i * pk + c];
              if (i + 1 < C) g += GR[(i + 1) * pk + c];
              if (i == C - 1) g += ltc[c];
              dsum = fmaf(db[i] * R[i * pk + c], K[i * pk + c], dsum);
            }
#pragma unroll
            for (int o = 1; o < 32; o <<= 1) {
              const float y = __shfl_up_sync(kFull, g, o);
              if (lane >= o) g += y;
            }
            g += carry;
            carry = __shfl_sync(kFull, g, 31);
            if (i >= 0) GK[i * pk + c] = g;
          }
          dsum = warp_sum(dsum);
          if (lane == 0) du[c] += dsum;
        }
        if (ch > 0)
          for (int c = warp; c < dk; c += kWarps) {
            float x = 0.f;
            for (int m = lane; m < dv; m += 32)
              x = fmaf(S[c * pv + m], dS[c * pv + m], x);
            x = warp_sum(x);
            if (lane == 0) lt[((ch - 1) & 1) * dk + c] = x;
          }
      }
      __syncthreads();  // the next chunk overwrites the tiles
      prev_t0 = t0;
    }
    if (prev_t0 >= 0)
      store_rows(glogw + kbase + (long long)prev_t0 * dk, GK, pk,
                 min(C, T - prev_t0), dk, warp, lane);
    for (int e = tid; e < dk; e += kThreads)
      gu[(long long)row * dk + e] = du[e];
    store_rows(gs0 + sbase, dS, pv, dk, dv, warp, lane);
    __syncthreads();  // the next row overwrites the states
  }
}

template <typename IO>
int launch(const IO* r, const IO* k, const IO* v, const float* logw,
           const float* u, const float* s_traj, const float* s_fin,
           const IO* dout, const float* ds_fin, IO* gr, IO* gk, IO* gv,
           float* glogw, float* gu, float* gs0, int BH, int T, int dk, int dv,
           int chunk, int bh_tile, long long smem, void* stream) {
  if (BH < 1 || T < 1 || chunk < 1 || bh_tile < 1 || dk < 1 || dv < 1 ||
      dk > kThreads || dv > kThreads)
    return (int)cudaErrorInvalidValue;
  // the wrapper's budget table must price exactly this launch
  if (smem != layout(true, dims(chunk, dk, dv)).bytes)
    return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        wkv6_bwd_kernel<IO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int grid = (BH + bh_tile - 1) / bh_tile;
  wkv6_bwd_kernel<IO>
      <<<grid, kThreads, (size_t)smem, (cudaStream_t)stream>>>(
          r, k, v, logw, u, s_traj, s_fin, dout, ds_fin, gr, gk, gv, glogw,
          gu, gs0, BH, T, dk, dv, chunk, bh_tile);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// r, k, logw, dr, dk, dlogw (BH, T, dk); v, dout, dv (BH, T, dv); u, du
// (BH, dk); s_traj (BH, ceil(T / chunk), dk, dv), the chunk-incoming
// states of the trajectory forward at the same chunk; s_fin, ds_fin, ds0
// (BH, dk, dv); all contiguous.  logw, u, the states and their gradients
// are f32; r, k, v, dout, dr, dk, dv f32 (wkv6_bwd_f32) or bf16
// (wkv6_bwd_bf16).  smem must equal the block's shared memory in the
// layout of wkv6_math.cuh, as kernels/wkv6.py:working_set_bytes(
// mode="bwd") prices it.  Grid:
// ceil(BH / bh_tile) blocks of 256 threads.
int wkv6_bwd_f32(const float* r, const float* k, const float* v,
                 const float* logw, const float* u, const float* s_traj,
                 const float* s_fin, const float* dout, const float* ds_fin,
                 float* gr, float* gk, float* gv, float* glogw, float* gu,
                 float* gs0, int BH, int T, int dk, int dv, int chunk,
                 int bh_tile, long long smem, void* stream) {
  return launch<float>(r, k, v, logw, u, s_traj, s_fin, dout, ds_fin, gr, gk,
                       gv, glogw, gu, gs0, BH, T, dk, dv, chunk, bh_tile,
                       smem, stream);
}

int wkv6_bwd_bf16(const void* r, const void* k, const void* v,
                  const float* logw, const float* u, const float* s_traj,
                  const float* s_fin, const void* dout, const float* ds_fin,
                  void* gr, void* gk, void* gv, float* glogw, float* gu,
                  float* gs0, int BH, int T, int dk, int dv, int chunk,
                  int bh_tile, long long smem, void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16>((const bf16*)r, (const bf16*)k, (const bf16*)v, logw,
                      u, s_traj, s_fin, (const bf16*)dout, ds_fin, (bf16*)gr,
                      (bf16*)gk, (bf16*)gv, glogw, gu, gs0, BH, T, dk, dv,
                      chunk, bh_tile, smem, stream);
}

const char* wkv6_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
