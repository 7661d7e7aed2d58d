// Blocked causal prefill attention (K8), f32 and bf16 IO, for Hopper
// (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/flash_prefill.py:_kernel,
// launched by flash_prefill's pallas_call: causal attention of q
// (B, S, Hq, dh) over k, v (B, S, Hkv, dh), query head h reading kv head
// h / (Hq / Hkv), optionally within the last `window` positions; scores
// (q . k) * scale in f32 masked to -1e30, an online softmax over kv tiles
// with m, l and acc in f32 and p masked to 0 after the exp, the output
// acc / max(l, 1e-30) in q's dtype.
//
// Design.  The TPU walks the kv tiles as its innermost, sequential grid
// axis, carrying m, l and acc in VMEM scratch.  Here a thread block owns one
// (batch row, query head, q tile of qb rows) and loops over the kv tiles
// itself, from the window's first tile to the causal limit: tiles wholly in
// the future or before the window hold no valid key and are not visited (the
// Pallas kernel's pl.when skip).  Two threads share a query row: thread
// `half` holds the scores of keys 2 jj + half of the tile (jj < kb / 2) and
// the output columns of the 4-wide chunks 2 a + half, so m, l and acc stay
// in registers, and the pair exchanges its row maximum, its row sum and its
// probabilities with one shuffle each.  The q tile and the current k and v
// tiles are staged in shared memory in f32 (converted once on load), rows
// padded by kPad floats so that the 16-byte loads of a warp fall on distinct
// banks; rows at or past S are zero and masked.  Nothing is read past S: any
// S is taken, ragged tails included.
//
// What bounds it on the H100.  At Qwen2-0.5B's served prefill (B = 4,
// S = 500, 14 query heads over 2 kv heads, dh 64, bf16) the causal half of
// the two products is 4 B Hq dh S (S + 1) / 2 = 1.8 G operations, 1.8 us at
// the 989 TFLOP/s of the bf16 tensor cores, against 8.2 MB of q, k, v and o
// (2.4 us at 3.35 TB/s).  This kernel does that arithmetic on the CUDA cores
// in f32, 67 TFLOP/s at most: 27 us, and each multiply-add reads its k or v
// operand from shared memory (one 16-byte load per four).  A tensor-core
// version (wgmma on bf16 tiles, TMA loads) is the way to the bound and later
// work; this one is the simple kernel that is right first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kMaxQBlock = 64;  // rows of a q tile: 2 kMaxQBlock threads
constexpr int kMaxKBlock = 64;  // rows of a k or v tile
constexpr int kPad = 4;         // floats after each staged row
constexpr float kNegInf = -1e30f;

// Shared memory of one block, in floats: the q tile (qb, dh + kPad) and the
// k and v tiles (kb, dh + kPad).  kernels/flash_prefill.py:working_set_bytes
// prices the same terms.
__host__ __device__ inline long long smem_floats(int qb, int kb, int dh) {
  return (long long)(qb + 2 * kb) * (dh + kPad);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]), b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162* p2 = reinterpret_cast<__nv_bfloat162*>(p);
  p2[0] = __floats2bfloat162_rn(v.x, v.y);
  p2[1] = __floats2bfloat162_rn(v.z, v.w);
}

// Positions [p0, p0 + rows) of head h of a (B, S, H, DH) tensor into a
// (rows, DH + kPad) f32 tile; positions at or past S are zero.
template <typename IO, int DH>
__device__ __forceinline__ void load_tile(const IO* __restrict__ src,
                                          float* dst, int b, int p0,
                                          int rows, int S, int H, int h) {
  constexpr int kChunks = DH / 4;
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e % kChunks) * 4;
    const int p = p0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < S) x = load4(src + (((long long)b * S + p) * H + h) * DH + c);
    *reinterpret_cast<float4*>(dst + r * (DH + kPad) + c) = x;
  }
}

template <typename IO, int DH>
__global__ void __launch_bounds__(2 * kMaxQBlock)
    flash_prefill_kernel(const IO* __restrict__ q, const IO* __restrict__ k,
                         const IO* __restrict__ v, IO* __restrict__ o, int S,
                         int Hq, int Hkv, int qb, int kb, int window,
                         float scale) {
  constexpr int kLd = DH + kPad;
  constexpr int kOut = DH / 8;  // 4-wide output chunks a thread owns
  extern __shared__ float4 smem4[];
  float* sq = reinterpret_cast<float*>(smem4);
  float* sk = sq + qb * kLd;
  float* sv = sk + kb * kLd;
  const int half = threadIdx.x & 1;
  const int row = threadIdx.x >> 1;
  const int q0 = blockIdx.x * qb;
  const int hq = blockIdx.y, b = blockIdx.z;
  const int hk = hq / (Hq / Hkv);
  const int qp = q0 + row;  // this thread pair's query position
  const int nj = kb / 2;    // scores a thread holds per tile

  load_tile<IO, DH>(q, sq, b, q0, qb, S, Hq, hq);

  // the live kv tiles: from the window's first to the causal limit
  int kt_first = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_first = (q0 - window + 1) / kb;
  const int kt_last = min((S - 1) / kb, (q0 + qb - 1) / kb);

  float m = kNegInf, l = 0.f;
  float acc[4 * kOut];
#pragma unroll
  for (int i = 0; i < 4 * kOut; ++i) acc[i] = 0.f;
  const float* qrow = sq + row * kLd;

  for (int kt = kt_first; kt <= kt_last; ++kt) {
    const int k0 = kt * kb;
    __syncthreads();  // every thread is done with the previous tiles
    load_tile<IO, DH>(k, sk, b, k0, kb, S, Hkv, hk);
    load_tile<IO, DH>(v, sv, b, k0, kb, S, Hkv, hk);
    __syncthreads();

    // s = q . k for keys 2 jj + half
    float s[kMaxKBlock / 2];
#pragma unroll
    for (int jj = 0; jj < kMaxKBlock / 2; ++jj) s[jj] = 0.f;
#pragma unroll 2
    for (int c = 0; c < DH; c += 4) {
      const float4 a = *reinterpret_cast<const float4*>(qrow + c);
#pragma unroll
      for (int jj = 0; jj < kMaxKBlock / 2; ++jj) {
        if (jj < nj) {
          const float4 x =
              *reinterpret_cast<const float4*>(sk + (2 * jj + half) * kLd + c);
          s[jj] = fmaf(a.x, x.x, s[jj]);
          s[jj] = fmaf(a.y, x.y, s[jj]);
          s[jj] = fmaf(a.z, x.z, s[jj]);
          s[jj] = fmaf(a.w, x.w, s[jj]);
        }
      }
    }

    // scale and mask; the row's maximum over both threads of the pair
    unsigned live = 0u;
    float mx = kNegInf;
#pragma unroll
    for (int jj = 0; jj < kMaxKBlock / 2; ++jj) {
      if (jj < nj) {
        const int kp = k0 + 2 * jj + half;
        const bool ok =
            kp <= qp && kp < S && (window <= 0 || qp - kp < window);
        if (ok) live |= 1u << jj;
        s[jj] = ok ? s[jj] * scale : kNegInf;
        mx = fmaxf(mx, s[jj]);
      }
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float ps = 0.f;
#pragma unroll
    for (int jj = 0; jj < kMaxKBlock / 2; ++jj) {
      if (jj < nj) {
        s[jj] = (live >> jj & 1u) ? expf(s[jj] - m_new) : 0.f;
        ps += s[jj];
      }
    }
    ps += __shfl_xor_sync(0xffffffffu, ps, 1);
    l = l * alpha + ps;
    m = m_new;

    // acc = acc * alpha + p v over the tile's keys, in key order
#pragma unroll
    for (int i = 0; i < 4 * kOut; ++i) acc[i] *= alpha;
#pragma unroll
    for (int jj = 0; jj < kMaxKBlock / 2; ++jj) {
      if (jj < nj) {
        const float mine = s[jj];
        const float other = __shfl_xor_sync(0xffffffffu, mine, 1);
        const float p0 = half ? other : mine;  // key 2 jj
        const float p1 = half ? mine : other;  // key 2 jj + 1
        const float* v0 = sv + (2 * jj) * kLd + 4 * half;
        const float* v1 = v0 + kLd;
#pragma unroll
        for (int a = 0; a < kOut; ++a) {
          const float4 x0 = *reinterpret_cast<const float4*>(v0 + 8 * a);
          const float4 x1 = *reinterpret_cast<const float4*>(v1 + 8 * a);
          acc[4 * a + 0] = fmaf(p1, x1.x, fmaf(p0, x0.x, acc[4 * a + 0]));
          acc[4 * a + 1] = fmaf(p1, x1.y, fmaf(p0, x0.y, acc[4 * a + 1]));
          acc[4 * a + 2] = fmaf(p1, x1.z, fmaf(p0, x0.z, acc[4 * a + 2]));
          acc[4 * a + 3] = fmaf(p1, x1.w, fmaf(p0, x0.w, acc[4 * a + 3]));
        }
      }
    }
  }

  if (qp < S) {
    const float lc = fmaxf(l, 1e-30f);
    IO* orow = o + (((long long)b * S + qp) * Hq + hq) * DH + 4 * half;
#pragma unroll
    for (int a = 0; a < kOut; ++a)
      store4(orow + 8 * a,
             make_float4(acc[4 * a] / lc, acc[4 * a + 1] / lc,
                         acc[4 * a + 2] / lc, acc[4 * a + 3] / lc));
  }
}

template <typename IO, int DH>
int launch_dh(const IO* q, const IO* k, const IO* v, IO* o, int B, int S,
              int Hq, int Hkv, int qb, int kb, int window, float scale,
              long long smem, cudaStream_t stream) {
  // raise the block's shared-memory limit once per instance
  static std::atomic<long long> granted{48 * 1024};
  if (smem > granted.load()) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<IO, DH>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted.store(smem);
  }
  const dim3 grid((S + qb - 1) / qb, Hq, B);
  flash_prefill_kernel<IO, DH><<<grid, 2 * qb, (size_t)smem, stream>>>(
      q, k, v, o, S, Hq, Hkv, qb, kb, window, scale);
  return (int)cudaGetLastError();
}

template <typename IO>
int launch(const IO* q, const IO* k, const IO* v, IO* o, int B, int S,
           int Hq, int Hkv, int dh, int qb, int kb, int window, float scale,
           long long smem, void* stream_) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || qb < 16 ||
      qb > kMaxQBlock || qb % 16 != 0 || kb < 2 || kb > kMaxKBlock ||
      kb % 2 != 0 || window < 0 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // the wrapper's budget table must price exactly this launch
  if (smem != 4 * smem_floats(qb, kb, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_;
  switch (dh) {
    case 16:
      return launch_dh<IO, 16>(q, k, v, o, B, S, Hq, Hkv, qb, kb, window,
                               scale, smem, stream);
    case 32:
      return launch_dh<IO, 32>(q, k, v, o, B, S, Hq, Hkv, qb, kb, window,
                               scale, smem, stream);
    case 64:
      return launch_dh<IO, 64>(q, k, v, o, B, S, Hq, Hkv, qb, kb, window,
                               scale, smem, stream);
    case 128:
      return launch_dh<IO, 128>(q, k, v, o, B, S, Hq, Hkv, qb, kb, window,
                                scale, smem, stream);
    case 160:
      return launch_dh<IO, 160>(q, k, v, o, B, S, Hq, Hkv, qb, kb, window,
                                scale, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// q, o (B, S, Hq, dh); k, v (B, S, Hkv, dh); all contiguous and 16-byte
// aligned, f32 (flash_prefill_f32) or bf16 (flash_prefill_bf16).  dh is 16,
// 32, 64, 128 or 160; qb a multiple of 16 up to 64, kb even up to 64; window
// 0 for full causal attention.  smem must equal 4 * smem_floats(qb, kb, dh)
// bytes.  Grid: ceil(S / qb) x Hq x B blocks of 2 qb threads.
int flash_prefill_f32(const float* q, const float* k, const float* v,
                      float* o, int B, int S, int Hq, int Hkv, int dh, int qb,
                      int kb, int window, float scale, long long smem,
                      void* stream) {
  return launch<float>(q, k, v, o, B, S, Hq, Hkv, dh, qb, kb, window, scale,
                       smem, stream);
}

int flash_prefill_bf16(const void* q, const void* k, const void* v, void* o,
                       int B, int S, int Hq, int Hkv, int dh, int qb, int kb,
                       int window, float scale, long long smem,
                       void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16>((const bf16*)q, (const bf16*)k, (const bf16*)v,
                      (bf16*)o, B, S, Hq, Hkv, dh, qb, kb, window, scale,
                      smem, stream);
}

const char* flash_prefill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
