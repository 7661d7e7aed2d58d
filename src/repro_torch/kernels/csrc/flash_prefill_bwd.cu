// The attention backward (K8b) for Hopper (sm_90a): dq, dk and dv of K8's
// causal (windowed) GQA attention, f32 or bf16 in and out, f32 math.
//
// K8b replaces no TPU kernel.  The JAX package trains its attention layers
// through the jnp flash_attention (models/attention.py), which XLA
// differentiates; its Pallas kernel K8 has no VJP.  The port's attention on
// the card launches K8 or raises, so training needs a backward of its own.
// Differentiating the plain blocked attention would put torch ops on the
// main path and keep a (B, Hkv, g, S, S) f32 score block for every layer.
// K8b instead recomputes the probabilities tile by tile from the row
// log-sum-exp that the training forward K8t writes (flash_prefill.cu), as
// K6t/K6b and K7t/K7b do for the recurrences:
//   p  = exp(scale q.k - lse), masked by K8's causal and window rule
//   D  = rowsum(dO o)
//   dv = p^T dO,  ds = p (dO v^T - D),  dq = scale ds k,  dk = scale ds^T q
// with dk and dv summed over the query heads of each kv head (GQA).
//
// What bounds it on the H100.  At Qwen2-0.5B's training shape (B = 4,
// S = 512, 14 query heads over 2 kv heads of 64, bf16) it reads q, k, v,
// o, dO and lse and writes dq, dk and dv once: ~17 MB, 5.1 us at 3.35 TB/s.
// Its five causal products (q k^T, dO v^T, p^T dO, ds k, ds^T q) are
// 5 B Hq dh S (S + 1) = 4.7 G operations, 4.8 us on the bf16 tensor cores
// at 989 TFLOP/s.  So the bound is ~5 us a layer, bytes and operations
// about even; a kernel near it would run the products as wgmma on TMA-fed
// tiles, as K8's tensor-core instance does.
//
// This first version is a SIMT kernel that is right: f32 fmaf on the CUDA
// cores (67 TFLOP/s), so it sits far above that bound.  Its design keeps
// what a faster one needs: no atomics (each gradient is written once by one
// block, so two runs give the same bits), every product from tiles staged
// once in shared memory in the IO type (bf16 widened where each value is
// used, not next to its load), fully masked tiles skipped as K8 skips them,
// and no (S, S) block in device memory.  Two kernels, launched in order on
// the caller's stream by one entry point:
//   - dQ: a block owns `rows` query rows of one (batch row, query head).
//     It computes D for them (and writes it, f32 (B, Hq, S)), then loops
//     over the live kv tiles of `tile` keys, accumulating dq in registers.
//   - dK/dV: a block owns `rows` key rows of one (batch row, kv head).  It
//     loops over the g query heads of the group and, for each, over the
//     live q tiles (causal: those at or after its keys; window: up to
//     key + window), reading lse and D, and sums dk and dv for the whole
//     group in registers.
// Both share one body.  Four threads (a quad) own a row: thread t of the
// quad computes the two dot products (q.k and dO.v) of the streamed rows
// n = 4 j + t, and owns the output columns of the 4-wide chunks 4 a + t;
// the quad exchanges p and ds by shuffles, so each thread then sums over
// every streamed row in order.  Blocks run heaviest first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxRows = 64;   // rows a block owns: 4 threads each
constexpr int kMaxTile = 64;   // rows of a streamed tile
constexpr int kPadBytes = 16;  // after each staged row: rows 4 banks apart

// Shared memory of one block, in bytes: the owned rows of two tensors and a
// streamed tile of two tensors, each row dh values in the IO type plus
// kPadBytes, and for the dK/dV kernel the streamed query rows' lse and D
// (f32).  kernels/flash_prefill.py:bwd_working_set_bytes prices the same.
__host__ __device__ inline long long bwd_smem_bytes(bool dq, int rows,
                                                    int tile, int dh,
                                                    int io) {
  return (long long)(2 * rows + 2 * tile) * (dh * io + kPadBytes) +
         (dq ? 0 : 2LL * 4 * tile);
}

__device__ __forceinline__ bool key_ok(int qp, int kp, int S, int window) {
  return qp < S && kp <= qp && (window <= 0 || qp - kp < window);
}

// Four consecutive values of a row, widened to f32
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(raw.x << 16),
                     __uint_as_float(raw.x & 0xffff0000u),
                     __uint_as_float(raw.y << 16),
                     __uint_as_float(raw.y & 0xffff0000u));
}

__device__ __forceinline__ void store4(float* p, float4 x) {
  *reinterpret_cast<float4*>(p) = x;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 x) {
  p[0] = __float2bfloat16_rn(x.x);
  p[1] = __float2bfloat16_rn(x.y);
  p[2] = __float2bfloat16_rn(x.z);
  p[3] = __float2bfloat16_rn(x.w);
}

__device__ __forceinline__ float dot4(float4 a, float4 b, float acc) {
  acc = fmaf(a.x, b.x, acc);
  acc = fmaf(a.y, b.y, acc);
  acc = fmaf(a.z, b.z, acc);
  return fmaf(a.w, b.w, acc);
}

__device__ __forceinline__ void axpy4(float s, float4 x, float* acc) {
  acc[0] = fmaf(s, x.x, acc[0]);
  acc[1] = fmaf(s, x.y, acc[1]);
  acc[2] = fmaf(s, x.z, acc[2]);
  acc[3] = fmaf(s, x.w, acc[3]);
}

// Positions [p0, p0 + n) of head h of a (B, S, H, DH) tensor into n staged
// rows of `ld` bytes, 16 bytes a copy, as stored; positions at or past S
// are zero.
template <typename IO, int DH>
__device__ __forceinline__ void stage(const IO* __restrict__ src,
                                      uint8_t* dst, int ld, int b, int p0,
                                      int n, int S, int H, int h) {
  constexpr int kChunks = DH * (int)sizeof(IO) / 16;
  for (int e = threadIdx.x; e < n * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = e % kChunks;
    const int p = p0 + r;
    uint4 x = {0u, 0u, 0u, 0u};
    if (p < S)
      x = reinterpret_cast<const uint4*>(
          src + (((long long)b * S + p) * H + h) * DH)[c];
    reinterpret_cast<uint4*>(dst + r * ld)[c] = x;
  }
}

// One block of either kernel.  kDq: the block owns query rows (q and dO
// staged as the owned pair, k and v streamed); else key rows (k and v
// owned, q and dO streamed with their lse and D).
template <typename IO, int DH, bool kDq>
__global__ void __launch_bounds__(4 * kMaxRows)
    flash_prefill_bwd_kernel(const IO* __restrict__ q,
                             const IO* __restrict__ k,
                             const IO* __restrict__ v,
                             const IO* __restrict__ o,
                             const IO* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ dsum, IO* __restrict__ dq,
                             IO* __restrict__ dk, IO* __restrict__ dv, int S,
                             int Hq, int Hkv, int rows, int tile, int window,
                             float scale) {
  constexpr int kCols = DH / 16;  // 4-wide column chunks a thread owns
  constexpr int kLd = DH * (int)sizeof(IO) + kPadBytes;
  extern __shared__ float4 smem4[];
  uint8_t* own_a = reinterpret_cast<uint8_t*>(smem4);  // q (dQ) or k
  uint8_t* own_b = own_a + rows * kLd;                 // dO (dQ) or v
  uint8_t* str_a = own_b + rows * kLd;                 // k (dQ) or q
  uint8_t* str_b = str_a + tile * kLd;                 // v (dQ) or dO
  float* s_lse = reinterpret_cast<float*>(str_b + tile * kLd);  // dK/dV
  float* s_d = s_lse + tile;

  const int t = threadIdx.x & 3;       // the thread's place in its quad
  const int r = threadIdx.x >> 2;      // the quad's owned row
  const int h = blockIdx.x, b = blockIdx.y;
  const int n_own = (S + rows - 1) / rows;
  // heaviest first: the last q tile sees the most keys, the first k tile
  // the most queries
  const int own_tile = kDq ? n_own - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int p0 = own_tile * rows;      // the first owned position
  const int pos = p0 + r;              // this quad's position
  const int nj = tile / 4;             // streamed rows a thread scores
  const int g = Hq / Hkv;
  const int lane = threadIdx.x % 32;
  const int quad0 = lane & ~3;

  float acc_a[4 * kCols];  // dq (dQ) or dk
  float acc_b[4 * kCols];  // dv (dK/dV only)
#pragma unroll
  for (int i = 0; i < 4 * kCols; ++i) acc_a[i] = acc_b[i] = 0.f;

  // the owned rows: q and dO of query head h, or k and v of kv head h
  if constexpr (kDq) {
    stage<IO, DH>(q, own_a, kLd, b, p0, rows, S, Hq, h);
    stage<IO, DH>(dout, own_b, kLd, b, p0, rows, S, Hq, h);
  } else {
    stage<IO, DH>(k, own_a, kLd, b, p0, rows, S, Hkv, h);
    stage<IO, DH>(v, own_b, kLd, b, p0, rows, S, Hkv, h);
  }
  __syncthreads();
  const IO* ra = reinterpret_cast<const IO*>(own_a + r * kLd);
  const IO* rb = reinterpret_cast<const IO*>(own_b + r * kLd);

  // dQ: the row's lse, and D = rowsum(dO o) over the quad's columns
  float row_lse = 0.f, row_d = 0.f;
  if constexpr (kDq) {
    if (pos < S) {
      const IO* orow = o + (((long long)b * S + pos) * Hq + h) * DH;
#pragma unroll
      for (int a = 0; a < kCols; ++a) {
        const int c = 4 * (4 * a + t);
        row_d = dot4(load4(rb + c), load4(orow + c), row_d);
      }
      row_lse = lse[((long long)b * Hq + h) * S + pos];
    }
    row_d += __shfl_xor_sync(0xffffffffu, row_d, 1);
    row_d += __shfl_xor_sync(0xffffffffu, row_d, 2);
    if (t == 0 && pos < S) dsum[((long long)b * Hq + h) * S + pos] = row_d;
  }

  // the streamed tiles: kv tiles from the window's first to the causal
  // limit (dQ); per query head of the group, q tiles from the first at or
  // after the owned keys to the window's end (dK/dV)
  int first, last, heads;
  if (kDq) {
    first = (window > 0 && p0 - window + 1 > 0) ? (p0 - window + 1) / tile
                                                : 0;
    last = min((S - 1) / tile, (p0 + rows - 1) / tile);
    heads = 1;
  } else {
    first = p0 / tile;
    last = (S - 1) / tile;
    if (window > 0) last = min(last, (p0 + rows - 2 + window) / tile);
    heads = g;
  }

  for (int hh = 0; hh < heads; ++hh) {
    const int hq = kDq ? h : h * g + hh;  // the query head streamed
    for (int st = first; st <= last; ++st) {
      const int s0 = st * tile;
      __syncthreads();  // every thread is done with the previous tile
      if constexpr (kDq) {
        const int hk = h / g;
        stage<IO, DH>(k, str_a, kLd, b, s0, tile, S, Hkv, hk);
        stage<IO, DH>(v, str_b, kLd, b, s0, tile, S, Hkv, hk);
      } else {
        stage<IO, DH>(q, str_a, kLd, b, s0, tile, S, Hq, hq);
        stage<IO, DH>(dout, str_b, kLd, b, s0, tile, S, Hq, hq);
        for (int e = threadIdx.x; e < tile; e += blockDim.x) {
          const int p = s0 + e;
          const long long i = ((long long)b * Hq + hq) * S + p;
          s_lse[e] = p < S ? lse[i] : 0.f;
          s_d[e] = p < S ? dsum[i] : 0.f;
        }
      }
      __syncthreads();

      // s = q . k and dp = dO . v for the streamed rows 4 jj + t
      float sp[kMaxTile / 4], dp[kMaxTile / 4];
#pragma unroll
      for (int jj = 0; jj < kMaxTile / 4; ++jj) sp[jj] = dp[jj] = 0.f;
#pragma unroll 2
      for (int c = 0; c < DH; c += 4) {
        const float4 xa = load4(ra + c), xb = load4(rb + c);
#pragma unroll
        for (int jj = 0; jj < kMaxTile / 4; ++jj) {
          if (jj < nj) {
            const int n = 4 * jj + t;
            sp[jj] = dot4(xa, load4(reinterpret_cast<const IO*>(
                                    str_a + n * kLd) + c), sp[jj]);
            dp[jj] = dot4(xb, load4(reinterpret_cast<const IO*>(
                                    str_b + n * kLd) + c), dp[jj]);
          }
        }
      }
      // p from lse, masked; ds = p (dp - D).  sp becomes p, dp becomes ds
#pragma unroll
      for (int jj = 0; jj < kMaxTile / 4; ++jj) {
        if (jj < nj) {
          const int n = 4 * jj + t;
          const int qp = kDq ? pos : s0 + n, kp = kDq ? s0 + n : pos;
          const float l_ = kDq ? row_lse : s_lse[n];
          const float d_ = kDq ? row_d : s_d[n];
          const float p =
              key_ok(qp, kp, S, window) ? expf(sp[jj] * scale - l_) : 0.f;
          sp[jj] = p;
          dp[jj] = p * (dp[jj] - d_);
        }
      }
      // sum over the tile's rows in order: row 4 jj + u's p and ds come
      // from thread u of the quad
#pragma unroll
      for (int jj = 0; jj < kMaxTile / 4; ++jj) {
        if (jj < nj) {
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float p = __shfl_sync(0xffffffffu, sp[jj], quad0 + u);
            const float ds = __shfl_sync(0xffffffffu, dp[jj], quad0 + u);
            const int n = 4 * jj + u;
            const IO* xa = reinterpret_cast<const IO*>(str_a + n * kLd);
            const IO* xb = reinterpret_cast<const IO*>(str_b + n * kLd);
#pragma unroll
            for (int a = 0; a < kCols; ++a) {
              const int c = 4 * (4 * a + t);
              axpy4(ds, load4(xa + c), acc_a + 4 * a);  // ds k or ds q
              if constexpr (!kDq)
                axpy4(p, load4(xb + c), acc_b + 4 * a);  // p dO
            }
          }
        }
      }
    }
  }

  if (pos < S) {
    if constexpr (kDq) {
      IO* row = dq + (((long long)b * S + pos) * Hq + h) * DH;
#pragma unroll
      for (int a = 0; a < kCols; ++a)
        store4(row + 4 * (4 * a + t),
               make_float4(acc_a[4 * a] * scale, acc_a[4 * a + 1] * scale,
                           acc_a[4 * a + 2] * scale,
                           acc_a[4 * a + 3] * scale));
    } else {
      const long long i = (((long long)b * S + pos) * Hkv + h) * DH;
#pragma unroll
      for (int a = 0; a < kCols; ++a) {
        const int c = 4 * (4 * a + t);
        store4(dk + i + c,
               make_float4(acc_a[4 * a] * scale, acc_a[4 * a + 1] * scale,
                           acc_a[4 * a + 2] * scale,
                           acc_a[4 * a + 3] * scale));
        store4(dv + i + c, make_float4(acc_b[4 * a], acc_b[4 * a + 1],
                                       acc_b[4 * a + 2], acc_b[4 * a + 3]));
      }
    }
  }
}

template <typename IO, int DH, bool kDq>
int launch_one(const IO* q, const IO* k, const IO* v, const IO* o,
               const IO* dout, const float* lse, float* dsum, IO* dq, IO* dk,
               IO* dv, int B, int S, int Hq, int Hkv, int rows, int tile,
               int window, float scale, long long smem,
               cudaStream_t stream) {
  // the wrapper's budget table must price exactly this launch
  if (smem != bwd_smem_bytes(kDq, rows, tile, DH, (int)sizeof(IO)))
    return (int)cudaErrorInvalidValue;
  // raise the block's shared-memory limit once per instance
  static std::atomic<long long> granted{48 * 1024};
  if (smem > granted.load()) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_bwd_kernel<IO, DH, kDq>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted.store(smem);
  }
  const dim3 grid(kDq ? Hq : Hkv, B, (S + rows - 1) / rows);
  flash_prefill_bwd_kernel<IO, DH, kDq>
      <<<grid, 4 * rows, (size_t)smem, stream>>>(
          q, k, v, o, dout, lse, dsum, dq, dk, dv, S, Hq, Hkv, rows, tile,
          window, scale);
  return (int)cudaGetLastError();
}

// The dQ kernel (which writes D), then the dK/dV kernel (which reads it)
template <typename IO, int DH>
int launch_dh(const IO* q, const IO* k, const IO* v, const IO* o,
              const IO* dout, const float* lse, float* dsum, IO* dq, IO* dk,
              IO* dv, int B, int S, int Hq, int Hkv, int dq_rows,
              int dkv_rows, int tile, int window, float scale,
              long long smem_dq, long long smem_dkv, cudaStream_t stream) {
  int err = launch_one<IO, DH, true>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                     B, S, Hq, Hkv, dq_rows, tile, window,
                                     scale, smem_dq, stream);
  if (err) return err;
  return launch_one<IO, DH, false>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                   B, S, Hq, Hkv, dkv_rows, tile, window,
                                   scale, smem_dkv, stream);
}

template <typename IO>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dout, const float* lse, float* dsum, void* dq,
           void* dk, void* dv, int B, int S, int Hq, int Hkv, int dh,
           int dq_rows, int dkv_rows, int tile, int window, float scale,
           long long smem_dq, long long smem_dkv, void* stream_) {
  auto rows_ok = [](int n) { return n >= 8 && n <= kMaxRows && n % 8 == 0; };
  if (B < 1 || S < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 ||
      !rows_ok(dq_rows) || !rows_ok(dkv_rows) || tile < 4 ||
      tile > kMaxTile || tile % 4 != 0 || window < 0 || Hq > 65535 ||
      B > 65535 || (S + 7) / 8 > 65535)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_;
  const IO *q_ = (const IO*)q, *k_ = (const IO*)k, *v_ = (const IO*)v,
           *o_ = (const IO*)o, *do_ = (const IO*)dout;
  IO *dq_ = (IO*)dq, *dk_ = (IO*)dk, *dv_ = (IO*)dv;
#define K8B_CASE(D)                                                         \
  case D:                                                                   \
    return launch_dh<IO, D>(q_, k_, v_, o_, do_, lse, dsum, dq_, dk_, dv_,  \
                            B, S, Hq, Hkv, dq_rows, dkv_rows, tile, window, \
                            scale, smem_dq, smem_dkv, stream);
  switch (dh) {
    K8B_CASE(16)
    K8B_CASE(32)
    K8B_CASE(64)
    K8B_CASE(128)
    K8B_CASE(160)
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef K8B_CASE
}

}  // namespace

extern "C" {

// q, o, dout, dq (B, S, Hq, dh); k, v, dk, dv (B, S, Hkv, dh), all
// contiguous and 16-byte aligned, in f32 (flash_prefill_bwd_f32) or bf16
// (flash_prefill_bwd_bf16); lse (B, Hq, S) f32 from K8t; dsum (B, Hq, S)
// f32 scratch for D.  dh is 16, 32, 64, 128 or 160; dq_rows and dkv_rows a
// multiple of 8 up to 64 (4 threads a row); tile a multiple of 4 up to 64;
// window 0 for full causal attention.  smem_dq and smem_dkv must equal
// bwd_smem_bytes of their kernel.  Grids: Hq x B x ceil(S / dq_rows) and
// Hkv x B x ceil(S / dkv_rows).
int flash_prefill_bwd_f32(const void* q, const void* k, const void* v,
                          const void* o, const void* dout, const float* lse,
                          float* dsum, void* dq, void* dk, void* dv, int B,
                          int S, int Hq, int Hkv, int dh, int dq_rows,
                          int dkv_rows, int tile, int window, float scale,
                          long long smem_dq, long long smem_dkv,
                          void* stream) {
  return launch<float>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S, Hq,
                       Hkv, dh, dq_rows, dkv_rows, tile, window, scale,
                       smem_dq, smem_dkv, stream);
}

int flash_prefill_bwd_bf16(const void* q, const void* k, const void* v,
                           const void* o, const void* dout, const float* lse,
                           float* dsum, void* dq, void* dk, void* dv, int B,
                           int S, int Hq, int Hkv, int dh, int dq_rows,
                           int dkv_rows, int tile, int window, float scale,
                           long long smem_dq, long long smem_dkv,
                           void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, dout, lse, dsum, dq, dk, dv, B, S,
                               Hq, Hkv, dh, dq_rows, dkv_rows, tile, window,
                               scale, smem_dq, smem_dkv, stream);
}

// The shared memory a launch of either kernel must be given (dq != 0: the
// dQ kernel), for the tests that hold the budget table to it.
long long flash_prefill_bwd_smem_bytes(int dq, int rows, int tile, int dh,
                                       int io) {
  return bwd_smem_bytes(dq != 0, rows, tile, dh, io);
}

const char* flash_prefill_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
