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
// What bounds it on the H100: the cache.  At Yi-9B's served decode (B = 4,
// 32 query heads over 4 kv heads, dk 128, bf16, 508 positions) a layer's
// call reads 2 x 4 x 508 x 4 x 128 x 2 = 4.2 MB, 1.3 us at 3.35 TB/s; its
// 33 M operations are little.  B x Hkv is only 8 (Qwen2) or 16 (Yi), so
// one block a (row, kv head) walking its positions in order leaves most of
// the 132 SMs idle and the time is that walk's latency.
//
// Design: a split over cache positions (flash-decoding) in ONE launch.
// - The grid is splits x Hkv x B.  A block owns one (row, kv head, span of
//   `span` positions) and the whole group of query heads, so each cache row
//   is read from device memory once.  The split comes from the host's
//   budget table (kernels/decode_attn.py:choose_blocks), from the cache
//   capacity S alone: the lengths stay on the device, and a decode step
//   never waits on the host.  A span past its row's length loads nothing.
// - A block is 256 threads.  Its query chunks are loaded before the row's
//   length (which the cache's loads wait on).  Within its span it walks
//   blocks of block_s positions: k and v come into shared memory by
//   16-byte cp.async, all in flight together, kept in the IO type, the
//   next block's copy issued while this one computes (two stages).
//   Scores: LG lanes a position (a 16-byte chunk of dk each, the group's
//   queries for it in registers, 8 heads a pass), summed by xor shuffles
//   that scatter the heads over the lanes as they sum.  Then a warp a head
//   updates m and l, and each thread carries acc for its (head, 16-byte
//   chunk of dk) pairs.  Three barriers a block of positions.
// - Each block writes its partial (acc, m, l), f32, to a workspace row of
//   dk + 4 floats a head, then arrives at its (row, kv head)'s counter (a
//   __threadfence, a barrier, then one thread's atomicAdd).  The last to
//   arrive merges the partials from L2, a thread a (head, 16-byte chunk)
//   pair: the head's largest m, then l and acc weighted by exp(m - max)
//   summed in split order; it writes the output and resets the counter
//   to 0.  A fixed merge order and no value summed by an atomic: two runs
//   agree bit for bit.  The counters live in a buffer that the wrapper
//   zeroes once per device and size, so a CUDA graph can capture the
//   launch.  An empty span leaves (acc = 0, m = -1e30, l = 0) and still
//   arrives.
// - Where the time goes (python -m repro_torch.obs.stamps --kernel
//   decode_attn, PERF.md): each of a block's phases costs about a
//   microsecond of latency whatever its work, and the last block's merge
//   adds its own round trips to L2; a block an SM (the table's split)
//   measured faster than two, and a merge staged through shared memory
//   slower than this one.

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kHeads = 8;        // query heads a score pass keeps in registers
constexpr int kAccFloats = 8;    // acc floats a thread keeps: group x dk <=
                                 // kAccFloats x kThreads
constexpr float kNegInf = -1e30f;

// Elements of the IO type in one 16-byte chunk.
template <typename IO>
struct Chunk;
template <>
struct Chunk<float> {
  static constexpr int E = 4;
  __device__ static void load(const float* p, float (&v)[4]) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x;
    v[1] = t.y;
    v[2] = t.z;
    v[3] = t.w;
  }
};
template <>
struct Chunk<__nv_bfloat16> {
  static constexpr int E = 8;
  __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
    const uint4 t = *reinterpret_cast<const uint4*>(p);
    const uint32_t w[4] = {t.x, t.y, t.z, t.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a bf16 is the high half of an f32
      v[2 * i] = __uint_as_float(w[i] << 16);
      v[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

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

// Shared memory of one block in bytes: two stages of the k and v blocks
// (block_s, dk) in the IO type, the group's queries (g, dk), their scores
// (g, block_s), and m, l and the rescale alpha of each head, these f32.
// kernels/decode_attn.py:working_set_bytes prices the same terms.
__host__ __device__ inline long long smem_bytes(int g, int bs, int dk,
                                                int io) {
  return 4LL * bs * dk * io + 4LL * g * dk + 4LL * g * bs + 12LL * g;
}

template <typename IO>
__global__ void __launch_bounds__(kThreads, 1)
    decode_attn_kernel(const IO* __restrict__ q, const IO* __restrict__ kc,
                       const IO* __restrict__ vc,
                       const int* __restrict__ lengths, IO* __restrict__ o,
                       float* __restrict__ ws, int* __restrict__ counters,
                       int S, int Hq, int Hkv, int dk, int bs, int span,
                       float scale) {
  constexpr int E = Chunk<IO>::E;
  constexpr int kPairs = kAccFloats / E;  // (head, chunk) pairs a thread
  const int split = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int splits = gridDim.x;
  const int g = Hq / Hkv;
  const int nch = dk / E;  // chunks a row
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  extern __shared__ float4 smem4[];
  IO* kv = reinterpret_cast<IO*>(smem4);  // stage s: k at 2s, v at 2s + 1
  float* sq = reinterpret_cast<float*>(kv + 4LL * bs * dk);
  float* ss = sq + g * dk;
  float* sm = ss + g * bs;
  float* sl = sm + g;
  float* sa = sl + g;
  __shared__ int s_last;

  // the (head, chunk) pairs whose acc this thread keeps, and their query
  // chunks, loaded before the length that the cache's loads wait on
  int ph[kPairs], pc[kPairs];
  float acc[kPairs][E], qv[kPairs][E];
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    const int e = tid + i * kThreads;
    ph[i] = e < g * nch ? e / nch : -1;
    pc[i] = e - (e / nch) * nch;
#pragma unroll
    for (int x = 0; x < E; ++x) acc[i][x] = 0.f;
    if (ph[i] >= 0)
      Chunk<IO>::load(q + ((long long)b * Hq + hk * g + ph[i]) * dk +
                          pc[i] * E, qv[i]);
  }

  const int len = min(max(lengths[b], 0), S);
  const int p_begin = split * span;
  const int p_end = min(len, p_begin + span);
  const int nblk = p_end > p_begin ? (p_end - p_begin + bs - 1) / bs : 0;
  const long long pair = (long long)b * Hkv + hk;
  const long long pos_stride = (long long)Hkv * dk;
  const IO* kb = kc + ((long long)b * S * Hkv + hk) * dk;
  const IO* vb = vc + ((long long)b * S * Hkv + hk) * dk;

  // copy mapping: rows r0, r0 + rstep, ... and chunks c0, c0 + cstep, ...
  const bool whole = nch <= kThreads;
  const int rstep = whole ? kThreads / nch : 1;
  const int r0 = whole ? tid / nch : 0;
  const int c0 = whole ? tid - r0 * nch : tid;
  const int cstep = whole ? nch : kThreads;
  const bool copier = r0 < rstep;


  // score lanes: LG lanes a position (a power of two, at most 32)
  int log_lg = 0;
  while ((1 << log_lg) < nch && log_lg < 5) ++log_lg;
  const int lg = 1 << log_lg;
  const int lig = lane & (lg - 1), pig = lane >> log_lg;
  const int pw = 32 >> log_lg;  // positions a warp takes at once
  // after the reduce-scatter: the heads a lane holds, and which lanes
  // write them (those of the group that agree on the halving bits)
  const int halvings = min(log_lg, 3);
  const int nvals = kHeads >> halvings;
  int hbase = 0;
  for (int k = 0; k < halvings; ++k)
    if (lig & (lg >> (k + 1))) hbase += (kHeads / 2) >> k;
  const bool writer = (lig & ((lg >> halvings) - 1)) == 0;

  auto stage = [&](int blk) {
    const int p0 = p_begin + blk * bs;
    const int n = min(bs, p_end - p0);
    IO* dk_ = kv + (long long)(2 * (blk & 1)) * bs * dk;
    IO* dv_ = dk_ + (long long)bs * dk;
    for (int r = copier ? r0 : n; r < n; r += rstep)
      for (int c = c0; c < nch; c += cstep) {
        const long long src = (long long)(p0 + r) * pos_stride + c * E;
        __pipeline_memcpy_async(dk_ + r * dk + c * E, kb + src, 16);
        __pipeline_memcpy_async(dv_ + r * dk + c * E, vb + src, 16);
      }
    __pipeline_commit();
  };

  if (nblk > 0) stage(0);
  // the group's queries in f32; m and l of each head
#pragma unroll
  for (int i = 0; i < kPairs; ++i)
    if (ph[i] >= 0)
#pragma unroll
      for (int x = 0; x < E; ++x) sq[ph[i] * dk + pc[i] * E + x] = qv[i][x];
  for (int h = tid; h < g; h += kThreads) {
    sm[h] = kNegInf;
    sl[h] = 0.f;
  }
  for (int blk = 0; blk < nblk; ++blk) {
    const int n = min(bs, p_end - (p_begin + blk * bs));
    const IO* sk = kv + (long long)(2 * (blk & 1)) * bs * dk;
    const IO* sv = sk + (long long)bs * dk;
    __pipeline_wait_prior(0);
    __syncthreads();  // this block has landed; the previous PV is done
    if (blk + 1 < nblk) stage(blk + 1);

    // (a) scores: lanes of a position split dk, shuffles sum them
    for (int hp = 0; hp < g; hp += kHeads) {
      for (int ci = 0; ci * lg < nch; ++ci) {
        const int c = lig + ci * lg;
        float qr[kHeads][E];
#pragma unroll
        for (int hh = 0; hh < kHeads; ++hh) {
          const bool live = c < nch && hp + hh < g;
          const float* src = sq + (hp + hh) * dk + c * E;
#pragma unroll
          for (int x = 0; x < E; x += 4) {
            float4 t = make_float4(0.f, 0.f, 0.f, 0.f);
            if (live) t = *reinterpret_cast<const float4*>(src + x);
            qr[hh][x] = t.x;
            qr[hh][x + 1] = t.y;
            qr[hh][x + 2] = t.z;
            qr[hh][x + 3] = t.w;
          }
        }
        for (int jb = warp * pw; jb < n; jb += kWarps * pw) {
          const int j = jb + pig;
          float kr[E];
          if (c < nch && j < n) {
            Chunk<IO>::load(sk + j * dk + c * E, kr);
          } else {
#pragma unroll
            for (int x = 0; x < E; ++x) kr[x] = 0.f;
          }
          float part[kHeads];
#pragma unroll
          for (int hh = 0; hh < kHeads; ++hh) {
            float a = 0.f;
#pragma unroll
            for (int x = 0; x < E; ++x) a = fmaf(kr[x], qr[hh][x], a);
            part[hh] = a;
          }
          // sum over the lg lanes, halving the values a lane holds at
          // each of the first three exchanges (a reduce-scatter): lane
          // lig ends with heads hbase .. hbase + (8 >> halvings) - 1
#pragma unroll
          for (int k = 0; k < 3; ++k) {
            const int off = lg >> (k + 1);
            if (off > 0) {
              const int half = (kHeads / 2) >> k;
              const bool up = (lig & off) != 0;
#pragma unroll
              for (int i = 0; i < half; ++i) {
                const float send = up ? part[i] : part[i + half];
                const float keep = up ? part[i + half] : part[i];
                part[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
              }
            }
          }
          for (int off = lg >> 4; off > 0; off >>= 1)
            part[0] += __shfl_xor_sync(0xffffffffu, part[0], off);
          if (writer && j < n)
#pragma unroll
            for (int i = 0; i < kHeads; ++i)
              if (i < nvals && hp + hbase + i < g) {
                float* dst = ss + (hp + hbase + i) * bs + j;
                *dst = ci ? *dst + part[i] : part[i];
              }
        }
      }
    }
    __syncthreads();
    // (b) the online softmax of each head over the block: a warp a head
    for (int h = warp; h < g; h += kWarps) {
      float* sr = ss + h * bs;
      const float m_old = sm[h];
      float mx = kNegInf;
      for (int j = lane; j < n; j += 32) mx = fmaxf(mx, sr[j] * scale);
      const float m_new = fmaxf(m_old, warp_max(mx));
      float ps = 0.f;
      for (int j = lane; j < n; j += 32) {
        const float p = expf(sr[j] * scale - m_new);
        sr[j] = p;
        ps += p;
      }
      ps = warp_sum(ps);
      if (lane == 0) {
        const float alpha = expf(m_old - m_new);
        sa[h] = alpha;
        sl[h] = sl[h] * alpha + ps;
        sm[h] = m_new;
      }
    }
    __syncthreads();
    // (c) acc = acc * alpha + p v for each (head, chunk) pair
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (ph[i] < 0) continue;
      const float alpha = sa[ph[i]];
#pragma unroll
      for (int x = 0; x < E; ++x) acc[i][x] *= alpha;
      const float* pr = ss + ph[i] * bs;
      const IO* vr = sv + pc[i] * E;
#pragma unroll 4
      for (int j = 0; j < n; ++j) {
        float v[E];
        Chunk<IO>::load(vr + j * dk, v);
        const float p = pr[j];
#pragma unroll
        for (int x = 0; x < E; ++x) acc[i][x] = fmaf(p, v[x], acc[i][x]);
      }
    }
  }

  // (d) this split's partial, then the last block of the (row, kv head)
  // merges every split's in split order
  const int row = dk + 4;                  // acc, m, l, 2 floats of padding
  float* part = ws + (pair * splits + split) * g * row;
#pragma unroll
  for (int i = 0; i < kPairs; ++i) {
    if (ph[i] < 0) continue;
    float* dst = part + ph[i] * row + pc[i] * E;
#pragma unroll
    for (int x = 0; x < E; x += 4)
      *reinterpret_cast<float4*>(dst + x) =
          make_float4(acc[i][x], acc[i][x + 1], acc[i][x + 2], acc[i][x + 3]);
  }
  for (int h = tid; h < g; h += kThreads) {
    part[h * row + dk] = sm[h];
    part[h * row + dk + 1] = sl[h];
  }
  __threadfence();  // this thread's partial is visible before the arrival
  __syncthreads();
  if (tid == 0) {
    s_last = atomicAdd(counters + pair, 1) == splits - 1;
    if (s_last) __threadfence();
  }
  __syncthreads();
  if (s_last) {
    // each thread merges its (head, chunk) pairs from L2 (other SMs wrote
    // them, so not through L1): the head's largest m over the splits, then
    // l and acc weighted by exp(m - max), summed in split order
    const long long sstep = (long long)g * row;
#pragma unroll
    for (int i = 0; i < kPairs; ++i) {
      if (ph[i] < 0) continue;
      const float* hr = ws + (pair * splits * g + ph[i]) * row;
      float M = kNegInf;
#pragma unroll 8
      for (int sp = 0; sp < splits; ++sp)
        M = fmaxf(M, __ldcg(hr + sp * sstep + dk));
      float L = 0.f, O[E];
#pragma unroll
      for (int x = 0; x < E; ++x) O[x] = 0.f;
#pragma unroll 8
      for (int sp = 0; sp < splits; ++sp) {
        const float* r = hr + sp * sstep;
        const float wgt = expf(__ldcg(r + dk) - M);
        L = fmaf(__ldcg(r + dk + 1), wgt, L);
#pragma unroll
        for (int x = 0; x < E; x += 4) {
          const float4 a =
              __ldcg(reinterpret_cast<const float4*>(r + pc[i] * E + x));
          O[x] = fmaf(a.x, wgt, O[x]);
          O[x + 1] = fmaf(a.y, wgt, O[x + 1]);
          O[x + 2] = fmaf(a.z, wgt, O[x + 2]);
          O[x + 3] = fmaf(a.w, wgt, O[x + 3]);
        }
      }
      IO* dst = o + ((long long)b * Hq + hk * g + ph[i]) * dk + pc[i] * E;
#pragma unroll
      for (int x = 0; x < E; ++x) store(dst + x, L > 0.f ? O[x] / L : 0.f);
    }
    if (tid == 0) counters[pair] = 0;
  }
}

template <typename IO>
int launch(const IO* q, const IO* kc, const IO* vc, const int* lengths,
           IO* o, float* ws, int* counters, int B, int S, int Hq, int Hkv,
           int dk, int bs, int splits, int span, float scale, long long smem,
           void* stream) {
  constexpr int E = Chunk<IO>::E;
  if (B < 1 || S < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || dk < E ||
      dk % E != 0 || (long long)(Hq / Hkv) * dk >
                         (long long)kAccFloats * kThreads ||
      bs < 1 || span < bs || span % bs != 0 || splits < 1 ||
      (long long)span * (splits - 1) >= S || (long long)span * splits < S ||
      Hkv > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // the wrapper's budget table must price exactly this launch
  if (smem != smem_bytes(Hq / Hkv, bs, dk, (int)sizeof(IO)))
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
  const dim3 grid(splits, Hkv, B);
  decode_attn_kernel<IO><<<grid, kThreads, (size_t)smem,
                           (cudaStream_t)stream>>>(
      q, kc, vc, lengths, o, ws, counters, S, Hq, Hkv, dk, bs, span, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q, o (B, Hq, dk); k_cache, v_cache (B, S, Hkv, dk); all contiguous and
// 16-byte aligned, f32 (decode_attn_f32) or bf16 (decode_attn_bf16);
// lengths (B,) int32 on the device.  dk a multiple of 16 bytes with
// (Hq / Hkv) * dk <= 2048.  ws: B x Hkv x splits x (Hq / Hkv) x (dk + 4)
// floats; counters: B x Hkv ints, 0 before the launch and after it.  Splits
// of span positions (a multiple of bs) cover S; smem must equal
// smem_bytes(Hq / Hkv, bs, dk, sizeof(IO)).  Grid: splits x Hkv x B blocks
// of 128 threads.
int decode_attn_f32(const float* q, const float* kc, const float* vc,
                    const int* lengths, float* o, float* ws, int* counters,
                    int B, int S, int Hq, int Hkv, int dk, int bs, int splits,
                    int span, float scale, long long smem, void* stream) {
  return launch<float>(q, kc, vc, lengths, o, ws, counters, B, S, Hq, Hkv,
                       dk, bs, splits, span, scale, smem, stream);
}

int decode_attn_bf16(const void* q, const void* kc, const void* vc,
                     const int* lengths, void* o, float* ws, int* counters,
                     int B, int S, int Hq, int Hkv, int dk, int bs,
                     int splits, int span, float scale, long long smem,
                     void* stream) {
  using bf16 = __nv_bfloat16;
  return launch<bf16>((const bf16*)q, (const bf16*)kc, (const bf16*)vc,
                      lengths, (bf16*)o, ws, counters, B, S, Hq, Hkv, dk, bs,
                      splits, span, scale, smem, stream);
}

const char* decode_attn_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
