// Single-token decode attention (K9), f32 and bf16 IO, for Hopper (sm_90a).
//
// Replaces the JAX package's Pallas kernel kernels/decode_attn.py:_kernel,
// launched by decode_attn's pallas_call: one new token's query q (B, Hq, dk)
// attends over a (B, S, Hkv, dk) cache, query head h reading kv head
// h / (Hq / Hkv), row b over its first lengths[b] positions; scores
// (k . q) * scale in f32, an online softmax over blocks of block_s
// positions with m, l and acc in f32, the output acc / l in q's dtype.  A row
// of length 0 gives 0, as the Pallas kernel's does (its p is 1 on invalid
// positions whose v it has zeroed, so acc is 0); here no block is visited
// and the output is 0 where l is 0.
//
// Design.  The Pallas grid reads a kv head's cache once per query head.
// Here a thread block owns one (batch row, kv head) and its whole group of
// query heads, so each cache row is read from device memory once.  Blocks of
// block_s positions, only those below the row's length (the blocks past it
// would add nothing), are staged in shared memory in f32, rows padded by
// kPad floats so that the 16-byte loads of a warp fall on distinct banks.
// The group's scores of a block are written to shared memory (a thread a
// (head, position) pair), each warp then updates m and l of its heads, and
// each thread carries acc for kMaxPairs (head, dim) pairs in registers.  The
// length is read on the device: a decode step never waits on the host.
//
// What bounds it on the H100: the cache.  At Yi-9B's served decode (B = 4,
// 32 query heads over 4 kv heads, dk 128, bf16, ~500 positions) a layer's
// call reads 2 x 4 x 500 x 4 x 128 x 2 = 4.1 MB, 1.2 us at 3.35 TB/s; its
// 33.6 M operations are nothing.  The grid is only B x Hkv blocks (16 for
// Yi, 8 for Qwen2), each streaming its rows in order, so the time is the
// latency of ~8 block steps and the launch: splitting the positions over
// blocks (flash-decoding) is later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxPairs = 16;  // (head, dim) pairs a thread accumulates
constexpr int kPad = 4;        // floats after each staged cache row
constexpr float kNegInf = -1e30f;

// Shared memory of one block, in floats: the k and v blocks (bs, dk + kPad),
// the group's queries (g, dk), their scores (g, bs), and m, l and the
// rescale alpha of each head.  kernels/decode_attn.py:working_set_bytes
// prices the same terms.
__host__ __device__ inline long long smem_floats(int g, int bs, int dk) {
  return 2LL * bs * (dk + kPad) + (long long)g * dk + (long long)g * bs +
         3LL * g;
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  const float2 a = __bfloat1622float2(p2[0]), b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

template <typename IO>
__global__ void __launch_bounds__(kThreads)
    decode_attn_kernel(const IO* __restrict__ q, const IO* __restrict__ kc,
                       const IO* __restrict__ vc,
                       const int* __restrict__ lengths, IO* __restrict__ o,
                       int S, int Hq, int Hkv, int dk, int bs, float scale) {
  const int hk = blockIdx.x, b = blockIdx.y;
  const int g = Hq / Hkv;
  const int ld = dk + kPad;
  const int chunks = dk / 4;
  extern __shared__ float4 smem4[];
  float* sk = reinterpret_cast<float*>(smem4);
  float* sv = sk + bs * ld;
  float* sq = sv + bs * ld;
  float* ss = sq + g * dk;
  float* sm = ss + g * bs;
  float* sl = sm + g;
  float* sa = sl + g;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int len = min(max(lengths[b], 0), S);

  for (int e = tid; e < g * chunks; e += kThreads) {
    const int hh = e / chunks, c = (e % chunks) * 4;
    *reinterpret_cast<float4*>(sq + hh * dk + c) =
        load4(q + ((long long)b * Hq + hk * g + hh) * dk + c);
  }
  for (int hh = tid; hh < g; hh += kThreads) {
    sm[hh] = kNegInf;
    sl[hh] = 0.f;
  }
  const int npairs = g * dk;
  float acc[kMaxPairs];
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) acc[i] = 0.f;

  for (int s0 = 0; s0 < len; s0 += bs) {
    const int n = min(bs, len - s0);
    __syncthreads();  // every thread is done with the previous block
    for (int e = tid; e < n * chunks; e += kThreads) {
      const int r = e / chunks, c = (e % chunks) * 4;
      const long long src = (((long long)b * S + s0 + r) * Hkv + hk) * dk + c;
      *reinterpret_cast<float4*>(sk + r * ld + c) = load4(kc + src);
      *reinterpret_cast<float4*>(sv + r * ld + c) = load4(vc + src);
    }
    __syncthreads();
    // scores (k . q) * scale of every (head, position) pair of the block
    for (int e = tid; e < g * n; e += kThreads) {
      const int hh = e / n, j = e % n;
      const float* qr = sq + hh * dk;
      const float* kr = sk + j * ld;
      float dot = 0.f;
      for (int c = 0; c < dk; c += 4) {
        const float4 x = *reinterpret_cast<const float4*>(kr + c);
        const float4 y = *reinterpret_cast<const float4*>(qr + c);
        dot = fmaf(x.x, y.x, dot);
        dot = fmaf(x.y, y.y, dot);
        dot = fmaf(x.z, y.z, dot);
        dot = fmaf(x.w, y.w, dot);
      }
      ss[hh * bs + j] = dot * scale;
    }
    __syncthreads();
    // the online softmax of each head over the block: a warp a head
    for (int hh = warp; hh < g; hh += kThreads / 32) {
      float* sr = ss + hh * bs;
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j]);
      const float m_new = fmaxf(sm[hh], warp_max(mx));
      float ps = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sr[j] - m_new);
        sr[j] = p;
        ps += p;
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float alpha = expf(sm[hh] - m_new);
        sa[hh] = alpha;
        sl[hh] = sl[hh] * alpha + ps;
        sm[hh] = m_new;
      }
    }
    __syncthreads();
    // acc = acc * alpha + p v for each (head, dim) pair this thread owns
#pragma unroll
    for (int i = 0; i < kMaxPairs; ++i) {
      const int e = tid + i * kThreads;
      if (e < npairs) {
        const int hh = e / dk, d = e % dk;
        const float* pr = ss + hh * bs;
        float a = acc[i] * sa[hh];
        for (int j = 0; j < n; ++j) a = fmaf(pr[j], sv[j * ld + d], a);
        acc[i] = a;
      }
    }
  }
  __syncthreads();  // l of every head is final
#pragma unroll
  for (int i = 0; i < kMaxPairs; ++i) {
    const int e = tid + i * kThreads;
    if (e < npairs) {
      const int hh = e / dk, d = e % dk;
      const float l = sl[hh];
      store(o + ((long long)b * Hq + hk * g + hh) * dk + d,
            l > 0.f ? acc[i] / l : 0.f);
    }
  }
}

template <typename IO>
int launch(const IO* q, const IO* kc, const IO* vc, const int* lengths,
           IO* o, int B, int S, int Hq, int Hkv, int dk, int bs, float scale,
           long long smem, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || dk < 4 ||
      dk % 4 != 0 || bs < 1 || (long long)(Hq / Hkv) * dk >
                                   (long long)kMaxPairs * kThreads ||
      Hkv > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // the wrapper's budget table must price exactly this launch
  if (smem != 4 * smem_floats(Hq / Hkv, bs, dk))
    return (int)cudaErrorInvalidValue;
  // raise the block's shared-memory limit once per instance
  static std::atomic<long long> granted{48 * 1024};
  if (smem > granted.load()) {
    const cudaError_t e = cudaFuncSetAttribute(
        decode_attn_kernel<IO>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted.store(smem);
  }
  const dim3 grid(Hkv, B);
  decode_attn_kernel<IO><<<grid, kThreads, (size_t)smem,
                           (cudaStream_t)stream>>>(q, kc, vc, lengths, o, S,
                                                   Hq, Hkv, dk, bs, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o (B, Hq, dk); k_cache, v_cache (B, S, Hkv, dk); all contiguous and
// 16-byte aligned, f32 (decode_attn_f32) or bf16 (decode_attn_bf16);
// lengths (B,) int32 on the device.  dk a multiple of 4 with
// (Hq / Hkv) * dk <= 2048.  smem must equal 4 * smem_floats(Hq / Hkv, bs,
// dk) bytes.  Grid: Hkv x B blocks of 128 threads.
int decode_attn_f32(const float* q, const float* kc, const float* vc,
                    const int* lengths, float* o, int B, int S, int Hq,
                    int Hkv, int dk, int bs, float scale, long long smem,
                    void* stream) {
  return launch<float>(q, kc, vc, lengths, o, B, S, Hq, Hkv, dk, bs, scale,
                       smem, stream);
}

int decode_attn_bf16(const void* q, const void* kc, const void* vc,
                     const int* lengths, void* o, int B, int S, int Hq,
                     int Hkv, int dk, int bs, float scale, long long smem,
                     void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16>((const bf16*)q, (const bf16*)kc, (const bf16*)vc,
                      lengths, (bf16*)o, B, S, Hq, Hkv, dk, bs, scale, smem,
                      stream);
}

const char* decode_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
