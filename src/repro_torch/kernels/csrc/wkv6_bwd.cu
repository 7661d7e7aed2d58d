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
// L_prev of step i is taken as L_{i-1} (0 for the first step), the
// exclusive cumsum: then every exponent is a difference of two cumsums
// with the later one subtracted, which is <= 0 exactly in f32 (adding a
// non-positive number never raises a float), so exp never overflows,
// whatever the decay.  Steps past T are identity steps (r = k = v = dO =
// 0, logw = 0) and write nothing.
//
// What bounds it on the H100: at the training shapes (160 rows of 64 x 64
// heads, T = 512, C = 32, bf16 IO) one call moves ~165 MB (r, k, v, dO
// and dr, dk, dv in bf16, logw and dlogw in f32, s_traj's 42 MB of f32
// states) and does ~5.1 G f32 operations (a multiply-add counted as two,
// an exponential as one), so the bytes bound it at ~49 us and the
// operations at ~76 us.  As in the forward, its real limit is narrower:
// the chunks of a row run in order, so only 160 blocks exist, and each
// block's time is set by its shared-memory traffic and its own chunks'
// arithmetic.
//
// Design: one thread block of 256 threads per batch-head row (a tile of
// bh_tile rows runs them one after another, each exactly as alone), chunks
// in reverse order.  The state cotangent dS is carried in shared memory
// for the whole sweep, seeded from ds_fin; du is carried in a register of
// the thread that owns its column; every output of a row is written by
// its own block, so there are no atomics and two runs are bit-identical.
// Each chunk takes seven phases separated by __syncthreads: (0) the
// outgoing state's term of Llast; (1) the windows, as f32, and S; (2) the
// column cumsums with e^{L_prev} and e^{Llast - L}, and the bonus A_ii and
// dA_ii; (3) A and dA below the diagonal; (4) dv and dk, and G = -k dk;
// (5) dr, and G += r dr on the row above; (6) du, the reverse cumsum of G
// into dlogw, and the dS update.  Every product is a loop in this file,
// one output element a thread at a time, reading the shared tiles along
// conflict-free rows (each (C, d) and (dk, dv) tile is padded by one
// word).  The block needs 108,288 bytes at 64 x 64, C = 32 (two fit on
// an SM).
// Register tiles, cp.async windows and wgmma are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared memory of one block, in floats: r, k, L, e^{L_prev}, e^{Llast - L}
// and the dlogw partials G as (C, dk + 1); v and dO as (C, dv + 1); A and
// dA (C, C); S and dS (dk, dv + 1); u (dk).  kernels/wkv6.py:
// working_set_bytes(mode="bwd") prices the same terms.
__host__ __device__ inline long long smem_floats(int C, int dk, int dv) {
  return 6LL * C * (dk + 1) + 2LL * C * (dv + 1) + 2LL * C * C +
         2LL * dk * (dv + 1) + dk;
}

template <typename IO>
__global__ void __launch_bounds__(kThreads)
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
  extern __shared__ float smem[];
  const int pk = dk + 1, pv = dv + 1;
  float* sr = smem;           // r
  float* sk = sr + C * pk;    // k
  float* sL = sk + C * pk;    // logw, then L
  float* sE = sL + C * pk;    // e^{L_prev}
  float* sD = sE + C * pk;    // e^{Llast - L}
  float* sG = sD + C * pk;    // dlogw partials
  float* sv = sG + C * pk;    // v
  float* sdo = sv + C * pv;   // dO
  float* sA = sdo + C * pv;   // A (bonus on the diagonal), lower triangle
  float* sdA = sA + C * C;    // dA, lower triangle with the diagonal
  float* sS = sdA + C * C;    // the chunk's incoming state; before (1),
                              // the state it hands on
  float* sdS = sS + dk * pv;  // the carried state cotangent
  float* su = sdS + dk * pv;  // u
  const int tid = threadIdx.x;
  const int nchunks = (T + C - 1) / C;

  for (int rr = 0; rr < bh_tile; ++rr) {
    const int row = blockIdx.x * bh_tile + rr;
    if (row >= BH) break;  // uniform across the block
    const long long kbase = (long long)row * T * dk;
    const long long vbase = (long long)row * T * dv;
    const long long sbase = (long long)row * dk * dv;
    for (int e = tid; e < dk * dv; e += kThreads) {
      const int c = e / dv, n = e - c * dv;
      sdS[c * pv + n] = ds_fin[sbase + e];
      sS[c * pv + n] = s_fin[sbase + e];
    }
    for (int e = tid; e < dk; e += kThreads)
      su[e] = u[(long long)row * dk + e];
    float du = 0.f;  // column tid's du, for tid < dk
    __syncthreads();

    for (int ch = nchunks - 1; ch >= 0; --ch) {
      const int t0 = ch * C;
      // (0) Llast's own term: sum_n S'_cn dS'_cn, S' the state the chunk
      // hands on (still in sS), kept by column c's thread
      float lterm = 0.f;
      if (tid < dk)
        for (int n = 0; n < dv; ++n)
          lterm = fmaf(sS[tid * pv + n], sdS[tid * pv + n], lterm);
      __syncthreads();

      // (1) the chunk's windows, f32, and its incoming state; steps past
      // T are identity steps
      for (int e = tid; e < C * dk; e += kThreads) {
        const int i = e / dk, c = e - i * dk;
        const bool in = t0 + i < T;
        const long long g = kbase + (long long)(t0 + i) * dk + c;
        sr[i * pk + c] = in ? to_f32(r[g]) : 0.f;
        sk[i * pk + c] = in ? to_f32(k[g]) : 0.f;
        sL[i * pk + c] = in ? logw[g] : 0.f;
      }
      for (int e = tid; e < C * dv; e += kThreads) {
        const int i = e / dv, n = e - i * dv;
        const bool in = t0 + i < T;
        const long long g = vbase + (long long)(t0 + i) * dv + n;
        sv[i * pv + n] = in ? to_f32(v[g]) : 0.f;
        sdo[i * pv + n] = in ? to_f32(dout[g]) : 0.f;
      }
      {
        const float* src = s_traj + ((long long)row * nchunks + ch) * dk * dv;
        for (int e = tid; e < dk * dv; e += kThreads) {
          const int c = e / dv, n = e - c * dv;
          sS[c * pv + n] = src[e];
        }
      }
      __syncthreads();

      // (2) down each column: e^{L_prev}, L, then e^{Llast - L}; per step
      // the bonus A_ii = r_i . u . k_i and dA_ii = dO_i . v_i
      for (int e = tid; e < dk + C; e += kThreads) {
        if (e < dk) {
          float acc = 0.f;
          for (int i = 0; i < C; ++i) {
            sE[i * pk + e] = __expf(acc);
            acc += sL[i * pk + e];
            sL[i * pk + e] = acc;
          }
          for (int i = 0; i < C; ++i)
            sD[i * pk + e] = __expf(acc - sL[i * pk + e]);
        } else {
          const int i = e - dk;
          float b = 0.f, db = 0.f;
          for (int c = 0; c < dk; ++c)
            b = fmaf(sr[i * pk + c] * su[c], sk[i * pk + c], b);
          for (int n = 0; n < dv; ++n)
            db = fmaf(sdo[i * pv + n], sv[i * pv + n], db);
          sA[i * C + i] = b;
          sdA[i * C + i] = db;
        }
      }
      __syncthreads();

      // (3) below the diagonal: A_ij and dA_ij = dO_i . v_j, j < i
      for (int e = tid; e < C * C; e += kThreads) {
        const int i = e / C, j = e - i * C;
        if (j < i) {
          const float* ri = sr + i * pk;
          const float* lpi = sL + (i - 1) * pk;
          const float* kj = sk + j * pk;
          const float* lj = sL + j * pk;
          float a = 0.f;
          for (int c = 0; c < dk; ++c)
            a = fmaf(ri[c] * kj[c], __expf(lpi[c] - lj[c]), a);
          const float* doi = sdo + i * pv;
          const float* vj = sv + j * pv;
          float da = 0.f;
          for (int n = 0; n < dv; ++n) da = fmaf(doi[n], vj[n], da);
          sA[e] = a;
          sdA[e] = da;
        }
      }
      __syncthreads();

      // (4) dv_jn, and dk_jc with G_j = -k_j (dk_j - bonus)
      for (int e = tid; e < C * dv; e += kThreads) {
        const int j = e / dv, n = e - j * dv;
        float acc = 0.f;
        for (int i = j; i < C; ++i)
          acc = fmaf(sA[i * C + j], sdo[i * pv + n], acc);
        for (int c = 0; c < dk; ++c)
          acc = fmaf(sk[j * pk + c] * sD[j * pk + c], sdS[c * pv + n], acc);
        if (t0 + j < T) store(gv + vbase + (long long)(t0 + j) * dv + n, acc);
      }
      for (int e = tid; e < C * dk; e += kThreads) {
        const int j = e / dk, c = e - j * dk;
        const float lj = sL[j * pk + c];
        float acc = 0.f;
        for (int i = j + 1; i < C; ++i)
          acc = fmaf(sdA[i * C + j] * sr[i * pk + c],
                     __expf(sL[(i - 1) * pk + c] - lj), acc);
        float st = 0.f;
        for (int n = 0; n < dv; ++n)
          st = fmaf(sv[j * pv + n], sdS[c * pv + n], st);
        acc = fmaf(sD[j * pk + c], st, acc);
        sG[j * pk + c] = -sk[j * pk + c] * acc;
        if (t0 + j < T)
          store(gk + kbase + (long long)(t0 + j) * dk + c,
                fmaf(sdA[j * C + j] * su[c], sr[j * pk + c], acc));
      }
      __syncthreads();

      // (5) dr_ic, and G_{i-1} += r_i (dr_i - bonus)
      for (int e = tid; e < C * dk; e += kThreads) {
        const int i = e / dk, c = e - i * dk;
        float carry = 0.f;
        for (int n = 0; n < dv; ++n)
          carry = fmaf(sS[c * pv + n], sdo[i * pv + n], carry);
        float acc = sE[i * pk + c] * carry;
        if (i > 0) {
          const float lpi = sL[(i - 1) * pk + c];
          for (int j = 0; j < i; ++j)
            acc = fmaf(sdA[i * C + j] * sk[j * pk + c],
                       __expf(lpi - sL[j * pk + c]), acc);
          sG[(i - 1) * pk + c] += sr[i * pk + c] * acc;
        }
        if (t0 + i < T)
          store(gr + kbase + (long long)(t0 + i) * dk + c,
                fmaf(sdA[i * C + i] * su[c], sk[i * pk + c], acc));
      }
      __syncthreads();

      // (6) du; dlogw_m = sum_{i>=m} G_i with Llast's term on row C-1
      if (tid < dk) {
        const int c = tid;
        for (int i = 0; i < C; ++i)
          du = fmaf(sdA[i * C + i] * sr[i * pk + c], sk[i * pk + c], du);
        float acc = lterm;
        for (int m = C - 1; m >= 0; --m) {
          acc += sG[m * pk + c];
          if (t0 + m < T) glogw[kbase + (long long)(t0 + m) * dk + c] = acc;
        }
      }
      // dS <- e^{Llast} dS + (r e^{L_prev})^T dO: each thread its entries
      for (int e = tid; e < dk * dv; e += kThreads) {
        const int c = e / dv, n = e - c * dv;
        float acc = __expf(sL[(C - 1) * pk + c]) * sdS[c * pv + n];
        for (int i = 0; i < C; ++i)
          acc = fmaf(sr[i * pk + c] * sE[i * pk + c], sdo[i * pv + n], acc);
        sdS[c * pv + n] = acc;
      }
      __syncthreads();  // the next chunk reads sS, sdS, overwrites the rest
    }
    if (tid < dk) gu[(long long)row * dk + tid] = du;
    for (int e = tid; e < dk * dv; e += kThreads) {
      const int c = e / dv, n = e - c * dv;
      gs0[sbase + e] = sdS[c * pv + n];
    }
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
  if (smem != 4 * smem_floats(chunk, dk, dv))
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
// (wkv6_bwd_bf16).  smem must equal the block's shared memory,
// 4 * smem_floats(chunk, dk, dv) bytes.  Grid: ceil(BH / bh_tile) blocks
// of 256 threads.
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
