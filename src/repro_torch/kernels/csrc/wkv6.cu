// RWKV6 chunked scan (K6) and its trajectory-writing instance (K6t), f32
// and bf16 IO, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernels kernels/wkv6.py:_kernel and
// _traj_kernel (body _fwd_body, chunk math _chunk_math), launched by
// _fwd_call: the RWKV6 recurrence
//   S_t = diag(exp(logw_t)) S_{t-1} + k_t^T v_t,
//   out_t = r_t (S_{t-1} + diag(u) k_t^T v_t)
// over whole sequences, one batch-head row at a time, in chunks of C steps.
// Per chunk, with L = cumsum(logw) and L_prev = L - logw:
//   out = (r * e^{L_prev}) S + sum_{j<i} (sum_c r_ic k_jc e^{L_prev,ic - L_jc}) v_j
//         + (r . u . k) v
//   S'  = e^{L_last} * S + (k * e^{L_last - L})^T v
// Every exponent is a difference of cumsums with the later one subtracted,
// so it is <= 0 and exp never overflows, whatever the decay: the masked
// (j >= i) scores are never computed, so no exponent is masked after exp.
//
// What bounds it on the H100: at the serving shapes (160 rows of 64 x 64
// heads, T = 512, C = 32) one call moves ~68 MB with bf16 IO (~105 MB f32)
// and does ~1.75 GFLOP of multiply-adds plus ~81 M exponentials, so the
// bytes bound it at ~20 us and the f32 operations at ~26 us.  Its real
// limit is narrower: the chunks of a row run in order, so only 160 blocks
// exist, a little over one per SM, and each block's time is set by its
// shared-memory traffic and the exponentials of its own chunks.
//
// Design: one thread block of 256 threads per batch-head row (a tile of
// bh_tile rows runs them one after another, each exactly as alone, so a
// row's results never depend on what shares its block).  A chunk's r, k,
// logw and v are loaded as f32 into shared memory (bf16 converted on the
// way; steps past T are identity steps: r = k = v = 0, logw = 0), together
// with the (C, C) scores, so a block needs ~61 KB at 64 x 64, C = 32 and
// three fit on an SM.  The f32 (dk, dv) state stays in shared memory for
// the whole scan and is written once at the end: it never round-trips to
// device memory mid-scan (the paper's preallocated-state rule).  Every
// product is a loop in this file: the scores entry by entry, summing over
// c in a register; the carry, scores-times-v and state-update products
// register-blocked, 8 output rows a thread, reading the shared tiles along
// conflict-free rows (the (C, dk) tiles are padded by one word).  All
// accumulation is f32.  Two-slot cp.async windows and wgmma for the
// C x dk x dv products are later work.
//
// K6t (kTraj = true) is the same kernel with one more output: before each
// chunk it writes the block's shared-memory state, the state the chunk
// starts from, to s_traj[row][chunk] (f32), the residual the backward
// (csrc/wkv6_bwd.cu) recomputes each chunk from.  It reads the state and
// writes nothing the chunk loop reads, so its out and final state are bit
// for bit K6's (the JAX contract of _kernel and _traj_kernel); it adds
// T / C * dk * dv * 4 bytes a row of stores, 42 MB at the serving shapes.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kQ = 8;  // output rows held in registers per thread

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Shared memory of one block, in floats: r, k, L, L_prev as (C, dk + 1);
// v (C, dv); scores (C, C); state (dk, dv); u (dk); bonus (C).
// kernels/wkv6.py:working_set_bytes prices the same terms.
__host__ __device__ inline long long smem_floats(int C, int dk, int dv) {
  return 4LL * C * (dk + 1) + (long long)C * dv + (long long)C * C +
         (long long)dk * dv + dk + C;
}

template <typename IO, bool kTraj>
__global__ void __launch_bounds__(kThreads)
    wkv6_kernel(const IO* __restrict__ r, const IO* __restrict__ k,
                const IO* __restrict__ v, const float* __restrict__ logw,
                const float* __restrict__ u, const float* __restrict__ s0,
                IO* __restrict__ out, float* __restrict__ s_out,
                float* __restrict__ s_traj, int BH, int T, int dk, int dv,
                int C, int bh_tile) {
  extern __shared__ float smem[];
  const int pk = dk + 1;
  float* sr = smem;            // r, then r * e^{L_prev}
  float* sk = sr + C * pk;     // k, then k * e^{L_last - L}
  float* sL = sk + C * pk;     // logw, then L
  float* sLp = sL + C * pk;    // L_prev
  float* sv = sLp + C * pk;    // v
  float* sA = sv + C * dv;     // scores, zero on and above the diagonal
  float* sS = sA + C * C;      // the carried state
  float* su = sS + dk * dv;    // u
  float* sb = su + dk;         // bonus r . u . k per step
  const int tid = threadIdx.x;
  const int nchunks = (T + C - 1) / C;
  const int rows = kThreads / dv;  // rows of one column a pass covers

  for (int rr = 0; rr < bh_tile; ++rr) {
    const int row = blockIdx.x * bh_tile + rr;
    if (row >= BH) break;  // uniform across the block
    const long long kbase = (long long)row * T * dk;
    const long long vbase = (long long)row * T * dv;
    const long long sbase = (long long)row * dk * dv;
    for (int e = tid; e < dk * dv; e += kThreads) sS[e] = s0[sbase + e];
    for (int e = tid; e < dk; e += kThreads) su[e] = u[(long long)row * dk + e];

    for (int ch = 0; ch < nchunks; ++ch) {
      const int t0 = ch * C;
      if (kTraj) {  // the state this chunk starts from
        float* dst = s_traj + ((long long)row * nchunks + ch) * dk * dv;
        for (int e = tid; e < dk * dv; e += kThreads) dst[e] = sS[e];
      }
      // (1) the chunk's windows, f32; steps past T are identity steps
      for (int e = tid; e < C * dk; e += kThreads) {
        const int i = e / dk, c = e - i * dk;
        const bool in = t0 + i < T;
        const long long g = kbase + (long long)(t0 + i) * dk + c;
        sr[i * pk + c] = in ? to_f32(r[g]) : 0.f;
        sk[i * pk + c] = in ? to_f32(k[g]) : 0.f;
        sL[i * pk + c] = in ? logw[g] : 0.f;
      }
      for (int e = tid; e < C * dv; e += kThreads) {
        const int i = e / dv;
        sv[e] = t0 + i < T
                    ? to_f32(v[vbase + (long long)t0 * dv + e])
                    : 0.f;
      }
      __syncthreads();

      // (2) L and L_prev down each column; the bonus of each step
      for (int e = tid; e < dk + C; e += kThreads) {
        if (e < dk) {
          float acc = 0.f;
          for (int i = 0; i < C; ++i) {
            const float w = sL[i * pk + e];
            acc += w;
            sL[i * pk + e] = acc;
            sLp[i * pk + e] = acc - w;
          }
        } else {
          const int i = e - dk;
          float acc = 0.f;
          for (int c = 0; c < dk; ++c)
            acc = fmaf(sr[i * pk + c] * su[c], sk[i * pk + c], acc);
          sb[i] = acc;
        }
      }
      __syncthreads();

      // (3) scores A[i][j] = sum_c r_ic k_jc e^{L_prev,ic - L_jc}, j < i
      for (int e = tid; e < C * C; e += kThreads) {
        const int i = e / C, j = e - i * C;
        float acc = 0.f;
        if (j < i) {
          const float* ri = sr + i * pk;
          const float* lpi = sLp + i * pk;
          const float* kj = sk + j * pk;
          const float* lj = sL + j * pk;
          for (int c = 0; c < dk; ++c)
            acc = fmaf(ri[c] * kj[c], __expf(lpi[c] - lj[c]), acc);
        }
        sA[e] = acc;
      }
      __syncthreads();

      // (4) r <- r * e^{L_prev}, k <- k * e^{L_last - L}
      const float* lLast = sL + (C - 1) * pk;
      for (int e = tid; e < C * dk; e += kThreads) {
        const int i = e / dk, c = e - i * dk;
        sr[i * pk + c] *= __expf(sLp[i * pk + c]);
        sk[i * pk + c] *= __expf(lLast[c] - sL[i * pk + c]);
      }
      __syncthreads();

      // (5) out = r' S + A v + bonus v, kQ rows of one column a thread
      {
        const int n = tid % dv;
        const int i0 = tid / dv;
        if (i0 < rows) {
          for (int ib = i0; ib < C; ib += rows * kQ) {
            float acc[kQ];
#pragma unroll
            for (int q = 0; q < kQ; ++q) acc[q] = 0.f;
            for (int c = 0; c < dk; ++c) {
              const float s = sS[c * dv + n];
#pragma unroll
              for (int q = 0; q < kQ; ++q) {
                const int i = ib + q * rows;
                if (i < C) acc[q] = fmaf(sr[i * pk + c], s, acc[q]);
              }
            }
            const int imax = min(C - 1, ib + (kQ - 1) * rows);
            for (int j = 0; j < imax; ++j) {  // A is zero for j >= i
              const float vj = sv[j * dv + n];
#pragma unroll
              for (int q = 0; q < kQ; ++q) {
                const int i = ib + q * rows;
                if (i < C) acc[q] = fmaf(sA[i * C + j], vj, acc[q]);
              }
            }
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
              const int i = ib + q * rows;
              if (i < C && t0 + i < T)
                store(out + vbase + (long long)(t0 + i) * dv + n,
                      fmaf(sb[i], sv[i * dv + n], acc[q]));
            }
          }
        }
      }
      __syncthreads();  // every read of the old state is done

      // (6) S <- e^{L_last} * S + k'^T v, kQ state rows of one column a
      // thread, each updating only the entries it owns
      {
        const int n = tid % dv;
        const int c0 = tid / dv;
        if (c0 < rows) {
          for (int cb = c0; cb < dk; cb += rows * kQ) {
            float acc[kQ];
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
              const int c = cb + q * rows;
              acc[q] = c < dk ? __expf(lLast[c]) * sS[c * dv + n] : 0.f;
            }
            for (int j = 0; j < C; ++j) {
              const float vj = sv[j * dv + n];
#pragma unroll
              for (int q = 0; q < kQ; ++q) {
                const int c = cb + q * rows;
                if (c < dk) acc[q] = fmaf(sk[j * pk + c], vj, acc[q]);
              }
            }
#pragma unroll
            for (int q = 0; q < kQ; ++q) {
              const int c = cb + q * rows;
              if (c < dk) sS[c * dv + n] = acc[q];
            }
          }
        }
      }
      __syncthreads();  // the next chunk overwrites the windows
    }
    for (int e = tid; e < dk * dv; e += kThreads) s_out[sbase + e] = sS[e];
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
  if (smem != 4 * smem_floats(chunk, dk, dv))
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
// block's shared memory, 4 * smem_floats(chunk, dk, dv) bytes.  Grid:
// ceil(BH / bh_tile) blocks of 256 threads.  The _traj entries (K6t) also
// write s_traj (BH, ceil(T / chunk), dk, dv) f32.
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
