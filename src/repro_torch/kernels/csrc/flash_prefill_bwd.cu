// The attention backward (K8b) for Hopper (sm_90a): dq, dk and dv of K8's
// causal (windowed) GQA attention, a tensor-core instance for bf16 IO and a
// SIMT instance for f32 IO, both summing in f32.
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
// S = 512, 14 query heads over 2 kv heads of 64, bf16) the function reads
// q, k, v, o, dO and lse and writes dq, dk and dv once: ~17 MB, 5.0 us at
// 3.35 TB/s.  Its five causal products (q k^T, dO v^T, p^T dO, ds k,
// ds^T q) are 5 B Hq dh S (S + 1) = 4.7 G operations, 4.8 us on the bf16
// tensor cores at 989 TFLOP/s.  Bytes and operations are about even: the
// products have to run on the tensor cores, and what a design adds to
// either counts against a ~5 us budget.
//
// The design, both instances: two kernels and, for GQA, a reduction,
// launched in order on the caller's stream by one entry point, with no
// atomics, so that every run gives the same bits.
//   - dQ: a block owns the query rows of a q tile of one (batch row, query
//     head).  It computes D for them (and writes it, f32 (B, Hq, S)), then
//     loops over the live kv tiles (from the window's first to the causal
//     limit), dq in registers.  Blocks run heaviest first.
//   - dK/dV: a block owns keys of one (batch row, QUERY head): the GQA
//     group is split over blocks, Hq x B x key tiles of them (g times the
//     blocks of a loop over the group), each looping over the live q tiles
//     (from its keys on; with a window, up to its last key + window),
//     reading their lse and D.  With g = 1 it writes dk and dv; with g > 1
//     its f32 partials, (B, S, Hq, dh) each, go to scratch.  The first key
//     tiles see the most queries and run first.
//   - the reduction (g > 1): each kv head's dk and dv are the sum of its g
//     query heads' partials in head order 0 ... g - 1, in f32, times the
//     scale for dk, written once in the IO type.
// The cost of the split: the two kernels compute q.k and dO.v once each,
// seven products, 6.6 G operations at that shape (6.7 us at the bf16
// peak), and the partials are 14.7 MB written and read again (~4.4 us
// each way at 3.35 TB/s; they fit the 50 MB L2).  In exchange the dK/dV
// grid has g times the blocks, and no block waits on another.
//
// The tensor-core instance (bf16; flash_prefill_bwd_tc).  Tiles of 64
// rows, one warpgroup's wgmma M; a producer warp and consumer warpgroups,
// as K8's tensor-core instance (hopper.cuh):
//   - The producer loads the block's owned tiles once and its streamed
//     tiles through a ring of kTcStages stages by TMA, bf16 as stored, in
//     the 128-byte swizzle, dh padded to a multiple of 64 by TMA's zero
//     fill (16, 32 -> 64; 160 -> 192), rows at or past S zero.  In dK/dV
//     its 32 lanes also stage each streamed q tile's lse (times log2 e)
//     and D, f32, beside the tile.
//   - The score products run as wgmma m64n64k16 with both operands
//     K-major in shared memory: S = Q K^T and dP = dO V^T in dQ; in dK/dV
//     the transposed S^T = K Q^T and dP^T = V dO^T, so that the keys are
//     the rows a warpgroup owns.  p = exp2(c s - lse log2 e) in f32, one
//     FFMA and one ex2, masked only on tiles that cross the diagonal, the
//     window's start or S; ds = p (dp - D) in f32.
//   - p (for dv) and ds are rounded to bf16 in registers, where the score
//     accumulator's layout is the A fragment's, and the products that take
//     them (dS K; P^T dO and dS^T Q) run as wgmma with A from registers and
//     the other tile N-major (the transpose bit), as K8's P V does.  The
//     plain version with round_p=True rounds at the same points.
//   - Registers shape the dK/dV block of 64 keys: at a padded width of 64
//     one warpgroup sums dk and dv (dk, dv, s and dp 32 registers each)
//     and two blocks share an SM; at 128 (64 + 64 + 32 + 32) it runs alone
//     on its SM, where five warps get up to 255 registers.  Timed at
//     OLMoE's heads on the H100 it beat two warpgroups of 64 keys sharing
//     the streamed tiles (nine or twelve warps: 168 registers a thread and
//     ~900 bytes spilled, also with setmaxnreg handing a producer
//     warpgroup's registers over) and the split below.  At 192 (dh 160)
//     dk and dv do not fit one warpgroup: two share the keys, one summing
//     dv and the other dk, each computing K Q^T (an eighth product, at that
//     width only).
//
// The SIMT instance (f32; flash_prefill_bwd_f32).  f32 on the tensor cores
// would be TF32, outside the f32 gates, so f32 runs on the CUDA cores (67
// TFLOP/s of fmaf): a block owns `rows` rows, the owned and streamed tiles
// staged in shared memory, rows padded by kPadBytes so that the 16-byte
// loads of a warp fall on distinct banks.  Four threads (a quad) own a
// row: thread t of the quad computes the two dot products (q.k and dO.v)
// of the streamed rows n = 4 j + t, and owns the output columns of the
// 4-wide chunks 4 a + t; the quad exchanges p and ds by shuffles, so each
// thread then sums over every streamed row in order.  It shares the group
// split and the reduction with the tensor-core instance.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

// The tensor-core instance needs tensor maps and wgmma: it is compiled by
// nvcc only.  The g++ mock of the CUDA runtime (tests/cuda_mock) builds the
// SIMT instance and the reduction alone.
#ifdef __CUDACC__
#include <cuda.h>

#include "hopper.cuh"
#endif

namespace {

__device__ __forceinline__ bool key_ok(int qp, int kp, int S, int window) {
  return qp < S && kp <= qp && (window <= 0 || qp - kp < window);
}

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
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

__device__ __forceinline__ void add4(float4& acc, float4 x) {
  acc.x += x.x;
  acc.y += x.y;
  acc.z += x.z;
  acc.w += x.w;
}

// Raise a kernel's shared-memory limit once per instance
template <typename K>
int grant_smem(K kernel, long long smem, std::atomic<long long>& granted) {
  if (smem > granted.load()) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted.store(smem);
  }
  return 0;
}

// ===========================================================================
// The reduction (g > 1)
// ===========================================================================
constexpr int kSumThreads = 256;

// part: f32 (2, B, S, Hq, dh), dk's partials (unscaled), then dv's.  A
// thread owns 4 columns of one (batch row, position, kv head): it sums the
// partials of the kv head's g query heads in head order and writes scale
// times the sum (dk) and the sum (dv) in the IO type.
template <typename IO>
__global__ void __launch_bounds__(kSumThreads)
    flash_prefill_bwd_sum(const float* __restrict__ part,
                          IO* __restrict__ dk, IO* __restrict__ dv,
                          long long chunks, long long half, int g, int dh,
                          float scale) {
  const long long e = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (e >= chunks) return;
  const long long row = e / (dh / 4);  // (b S + position) Hkv + kv head
  const int c = (int)(e % (dh / 4)) * 4;
  const float* pk = part + row * g * dh + c;  // its query heads' rows
  float4 sk = load4(pk), sv = load4(pk + half);
  for (int i = 1; i < g; ++i) {
    add4(sk, load4(pk + i * dh));
    add4(sv, load4(pk + half + i * dh));
  }
  store4(dk + row * dh + c,
         make_float4(sk.x * scale, sk.y * scale, sk.z * scale, sk.w * scale));
  store4(dv + row * dh + c, sv);
}

template <typename IO>
int launch_group_sum(const float* part, IO* dk, IO* dv, int B, int S, int Hq,
                     int Hkv, int dh, float scale, cudaStream_t stream) {
  const long long chunks = (long long)B * S * Hkv * dh / 4;
  const long long half = (long long)B * S * Hq * dh;
  const long long blocks = (chunks + kSumThreads - 1) / kSumThreads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_prefill_bwd_sum<IO><<<(unsigned)blocks, kSumThreads, 0, stream>>>(
      part, dk, dv, chunks, half, Hq / Hkv, dh, scale);
  return (int)cudaGetLastError();
}

// ===========================================================================
// The tensor-core instance: its shared-memory price (also read by the
// tests under the mock) ...
// ===========================================================================
constexpr int kTcRows = 64;         // rows of a tile: one warpgroup's M
constexpr int kTcStages = 2;        // streamed tiles in the ring
constexpr int kAtomCols = 64;       // bf16 columns of a 128-byte swizzle row
constexpr int kSwizzleAlign = 1024;

__host__ __device__ constexpr int padded(int dh) {
  return (dh + kAtomCols - 1) / kAtomCols * kAtomCols;
}

// The dK/dV block owns 64 keys.  At padded width 192 its dk and dv do not
// fit one warpgroup's registers: two consumer warpgroups share the keys,
// one summing dv, the other dk (kSplit); else one warpgroup sums both.
__host__ __device__ constexpr bool tc_dkv_split(int dhp) { return dhp > 128; }

// Dynamic shared memory of one block, in bytes: the slack to align the
// tiles to the swizzle's 1024 bytes; the two owned tiles (q and dO for dQ,
// k and v for dK/dV); kTcStages stages of two streamed tiles (k and v for
// dQ; q and dO for dK/dV, with their rows' lse and D in f32), all (64,
// dhp) bf16; the barriers (the owned tiles'; a full and an empty one per
// stage).  kernels/flash_prefill.py:bwd_working_set_bytes prices the same.
__host__ __device__ constexpr long long tc_smem_bytes(bool dq, int dhp) {
  return kSwizzleAlign + 2LL * 2 * kTcRows * dhp +
         kTcStages * (2LL * 2 * kTcRows * dhp + (dq ? 0 : 2 * 4 * kTcRows)) +
         8 * (1 + 2 * kTcStages);
}

// Blocks the register file must leave room for: two where two blocks'
// shared memory fits an SM (228 KB, 1 KB of it reserved per block), which
// caps a thread at 168 registers (K8's rule: of ten warps one of the SM's
// four register files holds three); one otherwise.  The dK/dV kernel
// takes two at padded width 64 only: at 128 its 64 + 64 accumulators and
// two 32-register scores need ~230 registers, and one block an SM gets up
// to 255 (five warps).  At 192 its nine warps put three on a register
// file, 168 registers a thread.
__host__ __device__ constexpr int tc_dq_min_blocks(int dhp) {
  return 2 * (tc_smem_bytes(true, dhp) + 1024) <= 233472 ? 2 : 1;
}
__host__ __device__ constexpr int tc_dkv_min_blocks(int dhp) {
  return dhp == 64 ? 2 : 1;
}
__host__ __device__ constexpr int tc_dkv_threads(int dhp) {
  return (tc_dkv_split(dhp) ? 256 : 128) + 32;
}

#ifdef __CUDACC__
// ===========================================================================
// ... and its kernels
// ===========================================================================
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBlockBytes = kTcRows * 128;  // a 64-column block of a tile

// 16 columns (step kk) of a K-major (64, dhp) tile at `addr`: within a
// 128-byte swizzle row by 32-byte offsets of the start address, across
// column blocks by whole blocks of 64 rows
__device__ __forceinline__ uint64_t k_major(uint32_t addr, int kk) {
  return hopper::sw128_desc(addr + (kk / 4) * kTcRows * 128 + (kk % 4) * 32,
                            16, 1024);
}

// 16 rows (step t) of an N-major (64, dhp) tile: its 8-row groups 1024
// bytes apart (sbo), its column blocks 64 rows of 128 bytes apart (lbo)
__device__ __forceinline__ uint64_t n_major(uint32_t addr, int t) {
  return hopper::sw128_desc(addr + t * 16 * 128, kTcRows * 128, 1024);
}

// s (64, 64) = A B^T over the padded width: two K-major (64, DHP) tiles
template <int DHP>
__device__ __forceinline__ void score_product(float (&s)[32], uint32_t a,
                                              uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DHP / 16; ++kk)
    hopper::wgmma_ss_n64(s, k_major(a, kk), k_major(b, kk), kk > 0);
}

// acc (64, DHP) += A (64, 64) B: A in registers, four steps of 16 columns;
// B an N-major (64, DHP) tile
template <int DHP>
__device__ __forceinline__ void grad_product(float (&acc)[DHP / 2],
                                             const uint32_t (&a)[4][4],
                                             uint32_t b) {
#pragma unroll
  for (int t = 0; t < 4; ++t) hopper::wgmma_rs<DHP>(acc, a[t], n_major(b, t));
}

// Eight bf16 of a row of each of two tensors: their products summed into
// acc in order
__device__ __forceinline__ float dot8(const __nv_bfloat16* a,
                                      const __nv_bfloat16* b, float acc) {
  const uint4 x = *reinterpret_cast<const uint4*>(a);
  const uint4 y = *reinterpret_cast<const uint4*>(b);
  const uint32_t xs[4] = {x.x, x.y, x.z, x.w}, ys[4] = {y.x, y.y, y.z, y.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    acc = fmaf(__uint_as_float(xs[i] << 16), __uint_as_float(ys[i] << 16),
               acc);
    acc = fmaf(__uint_as_float(xs[i] & 0xffff0000u),
               __uint_as_float(ys[i] & 0xffff0000u), acc);
  }
  return acc;
}

// dQ's p and ds on the score fragments: rows r (l0, d0) and r + 8 (l1,
// d1) are queries qp0, qp1, the columns keys from kp0 (the thread's first
// column of the tile).  ds = p (dp - D) rounded to bf16 pairs in the A
// fragment's order: the 16 keys of step t are blocks 2 t and 2 t + 1.
template <bool kMask>
__device__ __forceinline__ void ds_rows(const float (&s)[32],
                                        const float (&dp)[32],
                                        uint32_t (&da)[4][4], float c,
                                        float l0, float l1, float d0,
                                        float d1, int qp0, int qp1, int kp0,
                                        int S, int window) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const bool hi = e >= 2;
      float p = hopper::exp2_approx(fmaf(s[4 * j + e], c, hi ? -l1 : -l0));
      if (kMask && !key_ok(hi ? qp1 : qp0, kp0 + 8 * j + (e & 1), S, window))
        p = 0.f;
      ds[e] = p * (dp[4 * j + e] - (hi ? d1 : d0));
    }
    da[j / 2][2 * (j % 2)] = hopper::pack_bf16(ds[0], ds[1]);
    da[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(ds[2], ds[3]);
  }
}

// dK/dV's p^T (kV) and ds^T (kK) on the transposed score fragments: rows
// r and r + 8 are keys kp0, kp1, the columns the streamed tile's queries,
// whose lse (times log2 e) and D are l[col], d[col]; qc0 is the query of
// the thread's first column.  Both rounded to bf16 pairs as ds_rows does.
template <bool kV, bool kK, bool kMask>
__device__ __forceinline__ void pds_cols(const float (&s)[32],
                                         const float (&dp)[32],
                                         uint32_t (&pa)[4][4],
                                         uint32_t (&da)[4][4], float c,
                                         const float* l, const float* d,
                                         int cq, int qc0, int kp0, int kp1,
                                         int S, int window) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    float p[4], ds[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 8 * j + cq + (e & 1);
      p[e] = hopper::exp2_approx(fmaf(s[4 * j + e], c, -l[col]));
      if (kMask &&
          !key_ok(qc0 + 8 * j + (e & 1), e >= 2 ? kp1 : kp0, S, window))
        p[e] = 0.f;
      if constexpr (kK) ds[e] = p[e] * (dp[4 * j + e] - d[col]);
    }
    if constexpr (kV) {
      pa[j / 2][2 * (j % 2)] = hopper::pack_bf16(p[0], p[1]);
      pa[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(p[2], p[3]);
    }
    if constexpr (kK) {
      da[j / 2][2 * (j % 2)] = hopper::pack_bf16(ds[0], ds[1]);
      da[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(ds[2], ds[3]);
    }
  }
}

// Rows kp0 and kp1 of a dK/dV accumulator, those before S: with g = 1 the
// kv head's rows in bf16, times `mul`; else the query head's f32 partial
// rows.  No padding column is written.
template <int DHP>
__device__ __forceinline__ void write_rows(const float (&acc)[DHP / 2],
                                           float mul, __nv_bfloat16* out,
                                           float* part, int b, int kp0,
                                           int kp1, int S, int Hq, int Hkv,
                                           int hq, int hk, int dh, int cq) {
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) {
    const int c = 8 * j + cq;
    if (c >= dh) continue;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int kp = h ? kp1 : kp0;
      if (kp >= S) continue;
      const float x = acc[4 * j + 2 * h], y = acc[4 * j + 2 * h + 1];
      if (part != nullptr)
        *reinterpret_cast<float2*>(
            part + (((long long)b * S + kp) * Hq + hq) * dh + c) =
            make_float2(x, y);
      else
        *reinterpret_cast<__nv_bfloat162*>(
            out + (((long long)b * S + kp) * Hkv + hk) * dh + c) =
            __floats2bfloat162_rn(x * mul, y * mul);
    }
  }
}

// --- dQ --------------------------------------------------------------------
// A block: one consumer warpgroup and one producer warp over 64 query rows
// of (batch row blockIdx.y, query head blockIdx.x), q tiles from the last
template <int DHP>
__global__ void __launch_bounds__(160, tc_dq_min_blocks(DHP))
    flash_prefill_bwd_dq_tc(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tdo,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            const __nv_bfloat16* __restrict__ o,
                            const __nv_bfloat16* __restrict__ dout,
                            const float* __restrict__ lse,
                            float* __restrict__ dsum,
                            __nv_bfloat16* __restrict__ dq, int S, int Hq,
                            int Hkv, int dh, int window, float scale) {
  constexpr int kChunks = DHP / kAtomCols;
  constexpr int kTile = 2 * kTcRows * DHP;  // one (64, DHP) bf16 tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = hopper::align_1024(smem_raw);
  uint8_t* sdo = sq + kTile;
  uint8_t* sk = sdo + kTile;
  uint8_t* sv = sk + kTcStages * kTile;
  uint64_t* own = reinterpret_cast<uint64_t*>(sv + kTcStages * kTile);
  uint64_t* full = own + 1;
  uint64_t* empty = full + kTcStages;

  const int hq = blockIdx.x, b = blockIdx.y;
  const int q0 = ((S + kTcRows - 1) / kTcRows - 1 - (int)blockIdx.z) * kTcRows;
  const int hk = hq / (Hq / Hkv);
  // the live kv tiles: from the window's first to the causal limit
  int kt_first = 0;
  if (window > 0 && q0 - window + 1 > 0)
    kt_first = (q0 - window + 1) / kTcRows;
  const int kt_last = min((S - 1) / kTcRows, (q0 + kTcRows - 1) / kTcRows);
  const int n_tiles = kt_last - kt_first + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(own, 1);
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 128);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // the producer warp: one thread issues TMA
    if (threadIdx.x == 128) {
      hopper::mbar_expect_tx(own, 2 * kTile);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        hopper::tma_load_4d(sq + c * kBlockBytes, &tq, own, c * kAtomCols, hq,
                            q0, b);
        hopper::tma_load_4d(sdo + c * kBlockBytes, &tdo, own, c * kAtomCols,
                            hq, q0, b);
      }
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kTcStages;
        if (i >= kTcStages)
          hopper::mbar_wait(&empty[s], ((i / kTcStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * kTile);
        const int k0 = (kt_first + i) * kTcRows;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          hopper::tma_load_4d(sk + s * kTile + c * kBlockBytes, &tk, &full[s],
                              c * kAtomCols, hk, k0, b);
          hopper::tma_load_4d(sv + s * kTile + c * kBlockBytes, &tv, &full[s],
                              c * kAtomCols, hk, k0, b);
        }
      }
    }
    return;
  }

  // the consumer warpgroup: rows r and r + 8 of the tile, and in each
  // 8-column block of an accumulator the columns cq and cq + 1
  const int lane = threadIdx.x % 32;
  const int r = (threadIdx.x / 32) * 16 + lane / 4;
  const int qp0 = q0 + r, qp1 = qp0 + 8;
  const int cq = 2 * (lane % 4);
  const long long i0 = (((long long)b * S + qp0) * Hq + hq) * dh;
  const long long i1 = i0 + 8LL * Hq * dh;

  // D of rows r and r + 8 from dO and o as stored: each thread of the
  // quad takes every fourth 8-column chunk, the quad sums them
  float d0 = 0.f, d1 = 0.f;
  for (int c = 8 * (lane % 4); c < dh; c += 32) {
    if (qp0 < S) d0 = dot8(dout + i0 + c, o + i0 + c, d0);
    if (qp1 < S) d1 = dot8(dout + i1 + c, o + i1 + c, d1);
  }
  d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
  d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
  d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
  const long long rows = ((long long)b * Hq + hq) * S;
  if ((lane & 3) == 0) {
    if (qp0 < S) dsum[rows + qp0] = d0;
    if (qp1 < S) dsum[rows + qp1] = d1;
  }
  const float l0 = qp0 < S ? lse[rows + qp0] * kLog2e : 0.f;
  const float l1 = qp1 < S ? lse[rows + qp1] * kLog2e : 0.f;
  const float c = scale * kLog2e;

  float acc[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
  const uint32_t q_addr = hopper::smem_addr(sq);
  const uint32_t do_addr = hopper::smem_addr(sdo);

  hopper::mbar_wait(own, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kTcStages;
    const int k0 = (kt_first + i) * kTcRows;
    hopper::mbar_wait(&full[s], (i / kTcStages) & 1);
    const uint32_t k_addr = hopper::smem_addr(sk + s * kTile);
    const uint32_t v_addr = hopper::smem_addr(sv + s * kTile);

    // S = Q K^T and dP = dO V^T
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    hopper::wgmma_fence();
    score_product<DHP>(sc, q_addr, k_addr);
    score_product<DHP>(dp, do_addr, v_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);
    hopper::fence_regs(dp);

    // ds; the mask only where the tile crosses the diagonal, S or the
    // window's start
    uint32_t da[4][4];
    const bool edge = k0 + kTcRows - 1 > q0 || k0 + kTcRows > S ||
                      (window > 0 && q0 + kTcRows - 1 - k0 >= window);
    if (edge)
      ds_rows<true>(sc, dp, da, c, l0, l1, d0, d1, qp0, qp1, k0 + cq, S,
                    window);
    else
      ds_rows<false>(sc, dp, da, c, l0, l1, d0, d1, qp0, qp1, k0 + cq, S,
                     window);

    // dQ += dS K, K's rows N-major
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
    grad_product<DHP>(acc, da, k_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);  // k and v of this stage are read
  }

#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) {
    const int col = 8 * j + cq;
    if (col < dh) {
      if (qp0 < S)
        *reinterpret_cast<__nv_bfloat162*>(dq + i0 + col) =
            __floats2bfloat162_rn(acc[4 * j] * scale, acc[4 * j + 1] * scale);
      if (qp1 < S)
        *reinterpret_cast<__nv_bfloat162*>(dq + i1 + col) =
            __floats2bfloat162_rn(acc[4 * j + 2] * scale,
                                  acc[4 * j + 3] * scale);
    }
  }
}

// --- dK/dV -----------------------------------------------------------------
struct DkvStage {
  uint8_t* sq;        // the ring's q tiles
  uint8_t* sdo;       // its dO tiles
  const float* sl;    // each stage's 64 lse x log2 e
  const float* sd;    // and D
  uint64_t* own;
  uint64_t* full;
  uint64_t* empty;
};

// One consumer warpgroup of a dK/dV block: keys [kw0, kw0 + 64) in the
// owned k and v tiles at k_addr, v_addr; dV (kV) and/or dK (kK) over the
// block's live q tiles.
template <int DHP, bool kV, bool kK>
__device__ __forceinline__ void dkv_consumer(
    const DkvStage& st, uint32_t k_addr, uint32_t v_addr, int kw0, int qt0,
    int n_tiles, int b, int hq, int hk, int S, int Hq, int Hkv, int dh,
    int window, float scale, __nv_bfloat16* dk, __nv_bfloat16* dv,
    float* part) {
  constexpr int kTile = 2 * kTcRows * DHP;
  const int tw = threadIdx.x % 128;
  const int lane = tw % 32;
  const int r = (tw / 32) * 16 + lane / 4;
  const int kp0 = kw0 + r, kp1 = kp0 + 8;
  const int cq = 2 * (lane % 4);
  const float c = scale * kLog2e;
  float acc_v[DHP / 2], acc_k[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc_v[i] = acc_k[i] = 0.f;

  hopper::mbar_wait(st.own, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kTcStages;
    const int q0 = (qt0 + i) * kTcRows;
    hopper::mbar_wait(&st.full[s], (i / kTcStages) & 1);
    const uint32_t q_addr = hopper::smem_addr(st.sq + s * kTile);
    const uint32_t do_addr = hopper::smem_addr(st.sdo + s * kTile);
    // S^T = K Q^T and dP^T = V dO^T
    float sc[32], dp[32];
#pragma unroll
    for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.f;
    hopper::wgmma_fence();
    score_product<DHP>(sc, k_addr, q_addr);
    if constexpr (kK) score_product<DHP>(dp, v_addr, do_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);
    if constexpr (kK) hopper::fence_regs(dp);

    uint32_t pa[4][4], da[4][4];
    const float* l = st.sl + s * kTcRows;
    const float* d = st.sd + s * kTcRows;
    const bool edge = q0 < kw0 + kTcRows - 1 || q0 + kTcRows > S ||
                      kw0 + kTcRows > S ||
                      (window > 0 && q0 + kTcRows - 1 - kw0 >= window);
    if (edge)
      pds_cols<kV, kK, true>(sc, dp, pa, da, c, l, d, cq, q0 + cq, kp0, kp1,
                             S, window);
    else
      pds_cols<kV, kK, false>(sc, dp, pa, da, c, l, d, cq, q0 + cq, kp0,
                              kp1, S, window);

    // dV += P^T dO and dK += dS^T Q, dO's and Q's rows N-major
    if constexpr (kV) hopper::fence_regs(acc_v);
    if constexpr (kK) hopper::fence_regs(acc_k);
    hopper::wgmma_fence();
    if constexpr (kV) grad_product<DHP>(acc_v, pa, do_addr);
    if constexpr (kK) grad_product<DHP>(acc_k, da, q_addr);
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    if constexpr (kV) hopper::fence_regs(acc_v);
    if constexpr (kK) hopper::fence_regs(acc_k);
    hopper::mbar_arrive(&st.empty[s]);  // this stage is read
  }

  const long long half = (long long)gridDim.y * S * Hq * dh;
  if constexpr (kV)
    write_rows<DHP>(acc_v, 1.f, dv, part ? part + half : nullptr, b, kp0,
                    kp1, S, Hq, Hkv, hq, hk, dh, cq);
  if constexpr (kK)
    write_rows<DHP>(acc_k, scale, dk, part, b, kp0, kp1, S, Hq, Hkv, hq, hk,
                    dh, cq);
}

// A block: one producer warp and one consumer warpgroup (two at padded
// width 192) over keys [64 blockIdx.z, + 64) of (batch row blockIdx.y,
// query head blockIdx.x): k and v of its kv head, q, dO, lse and D of its
// own query head.  part is null when g = 1.
template <int DHP>
__global__ void __launch_bounds__(tc_dkv_threads(DHP), tc_dkv_min_blocks(DHP))
    flash_prefill_bwd_dkv_tc(const __grid_constant__ CUtensorMap tq,
                             const __grid_constant__ CUtensorMap tdo,
                             const __grid_constant__ CUtensorMap tk,
                             const __grid_constant__ CUtensorMap tv,
                             const float* __restrict__ lse,
                             const float* __restrict__ dsum,
                             __nv_bfloat16* __restrict__ dk,
                             __nv_bfloat16* __restrict__ dv,
                             float* __restrict__ part, int S, int Hq,
                             int Hkv, int dh, int window, float scale) {
  constexpr int kConsumers = tc_dkv_threads(DHP) - 32;
  constexpr int kChunks = DHP / kAtomCols;
  constexpr int kTile = 2 * kTcRows * DHP;
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sk = hopper::align_1024(smem_raw);
  uint8_t* sv = sk + kTile;
  DkvStage st;
  st.sq = sv + kTile;
  st.sdo = st.sq + kTcStages * kTile;
  float* sl = reinterpret_cast<float*>(st.sdo + kTcStages * kTile);
  float* sd = sl + kTcStages * kTcRows;
  st.sl = sl;
  st.sd = sd;
  st.own = reinterpret_cast<uint64_t*>(sd + kTcStages * kTcRows);
  st.full = st.own + 1;
  st.empty = st.full + kTcStages;

  const int hq = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kTcRows;  // the first keys see the most queries
  const int hk = hq / (Hq / Hkv);
  // the live q tiles: from the one holding query k0 to the sequence's end
  // or the window's
  const int qt0 = k0 / kTcRows;
  int qt_last = (S - 1) / kTcRows;
  if (window > 0) qt_last = min(qt_last, (k0 + kTcRows - 2 + window) / kTcRows);
  const int n_tiles = qt_last - qt0 + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(st.own, 1);
#pragma unroll
    for (int s = 0; s < kTcStages; ++s) {
      hopper::mbar_init(&st.full[s], 32);
      hopper::mbar_init(&st.empty[s], kConsumers);
    }
    hopper::mbar_fence_init();
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= kConsumers) {  // the producer warp
    if (lane == 0) {
      hopper::mbar_expect_tx(st.own, 2 * kTile);
#pragma unroll
      for (int c = 0; c < kChunks; ++c) {
        hopper::tma_load_4d(sk + c * kBlockBytes, &tk, st.own, c * kAtomCols,
                            hk, k0, b);
        hopper::tma_load_4d(sv + c * kBlockBytes, &tv, st.own, c * kAtomCols,
                            hk, k0, b);
      }
    }
    const long long rows = ((long long)b * Hq + hq) * S;
    for (int i = 0; i < n_tiles; ++i) {
      const int s = i % kTcStages;
      const int q0 = (qt0 + i) * kTcRows;
      if (i >= kTcStages)
        hopper::mbar_wait(&st.empty[s], ((i / kTcStages) & 1) ^ 1);
      // every lane stages two rows' lse and D, then arrives (32 arrivals,
      // the first with the TMA bytes)
      for (int e = lane; e < kTcRows; e += 32) {
        const int p = q0 + e;
        sl[s * kTcRows + e] = p < S ? lse[rows + p] * kLog2e : 0.f;
        sd[s * kTcRows + e] = p < S ? dsum[rows + p] : 0.f;
      }
      if (lane == 0) {
        hopper::mbar_expect_tx(&st.full[s], 2 * kTile);
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          hopper::tma_load_4d(st.sq + s * kTile + c * kBlockBytes, &tq,
                              &st.full[s], c * kAtomCols, hq, q0, b);
          hopper::tma_load_4d(st.sdo + s * kTile + c * kBlockBytes, &tdo,
                              &st.full[s], c * kAtomCols, hq, q0, b);
        }
      } else {
        hopper::mbar_arrive(&st.full[s]);
      }
    }
    return;
  }

  const uint32_t k_addr = hopper::smem_addr(sk);
  const uint32_t v_addr = hopper::smem_addr(sv);
  if constexpr (tc_dkv_split(DHP)) {  // one warpgroup sums dv, one dk
    if (threadIdx.x < 128)
      dkv_consumer<DHP, true, false>(st, k_addr, v_addr, k0, qt0, n_tiles, b,
                                     hq, hk, S, Hq, Hkv, dh, window, scale,
                                     dk, dv, part);
    else
      dkv_consumer<DHP, false, true>(st, k_addr, v_addr, k0, qt0, n_tiles, b,
                                     hq, hk, S, Hq, Hkv, dh, window, scale,
                                     dk, dv, part);
  } else {
    dkv_consumer<DHP, true, true>(st, k_addr, v_addr, k0, qt0, n_tiles, b,
                                  hq, hk, S, Hq, Hkv, dh, window, scale, dk,
                                  dv, part);
  }
}

template <int DHP>
int launch_tc(const void* q, const void* k, const void* v, const void* o,
              const void* dout, const float* lse, float* dsum, void* dq,
              void* dk, void* dv, float* part, int B, int S, int Hq, int Hkv,
              int dh, int window, float scale, long long smem_dq,
              long long smem_dkv, cudaStream_t stream) {
  // the wrapper's budget table must price exactly these launches
  if (smem_dq != tc_smem_bytes(true, DHP) ||
      smem_dkv != tc_smem_bytes(false, DHP))
    return (int)cudaErrorInvalidValue;
  static std::atomic<long long> granted_dq{48 * 1024}, granted_dkv{48 * 1024};
  int err = grant_smem(flash_prefill_bwd_dq_tc<DHP>, smem_dq, granted_dq);
  if (!err)
    err = grant_smem(flash_prefill_bwd_dkv_tc<DHP>, smem_dkv, granted_dkv);
  CUtensorMap tq, tdo, tk, tv;
  if (!err) err = hopper::encode_map(&tq, q, B, S, Hq, dh, kTcRows);
  if (!err) err = hopper::encode_map(&tdo, dout, B, S, Hq, dh, kTcRows);
  if (!err) err = hopper::encode_map(&tk, k, B, S, Hkv, dh, kTcRows);
  if (!err) err = hopper::encode_map(&tv, v, B, S, Hkv, dh, kTcRows);
  if (err) return err;
  const auto bf = [](const void* p) {
    return reinterpret_cast<const __nv_bfloat16*>(p);
  };
  const dim3 dq_grid(Hq, B, (S + kTcRows - 1) / kTcRows);
  flash_prefill_bwd_dq_tc<DHP><<<dq_grid, 160, (size_t)smem_dq, stream>>>(
      tq, tdo, tk, tv, bf(o), bf(dout), lse, dsum, (__nv_bfloat16*)dq, S, Hq,
      Hkv, dh, window, scale);
  err = (int)cudaGetLastError();
  if (err) return err;
  const dim3 dkv_grid(Hq, B, (S + kTcRows - 1) / kTcRows);
  flash_prefill_bwd_dkv_tc<DHP>
      <<<dkv_grid, tc_dkv_threads(DHP), (size_t)smem_dkv, stream>>>(
          tq, tdo, tk, tv, lse, dsum, (__nv_bfloat16*)dk, (__nv_bfloat16*)dv,
          part, S, Hq, Hkv, dh, window, scale);
  err = (int)cudaGetLastError();
  if (err || part == nullptr) return err;
  return launch_group_sum<__nv_bfloat16>(part, (__nv_bfloat16*)dk,
                                         (__nv_bfloat16*)dv, B, S, Hq, Hkv,
                                         dh, scale, stream);
}
#endif  // __CUDACC__

// ===========================================================================
// The SIMT instance (f32)
// ===========================================================================
constexpr int kMaxRows = 64;   // rows a block owns: 4 threads each
constexpr int kMaxTile = 64;   // rows of a streamed tile
constexpr int kPadBytes = 16;  // after each staged row: rows 4 banks apart

// Shared memory of one block, in bytes: the owned rows of two tensors and a
// streamed tile of two tensors, each row dh floats plus kPadBytes, and for
// the dK/dV kernel the streamed query rows' lse and D.
// kernels/flash_prefill.py:bwd_working_set_bytes prices the same.
__host__ __device__ inline long long bwd_smem_bytes(bool dq, int rows,
                                                    int tile, int dh) {
  return (long long)(2 * rows + 2 * tile) * (dh * 4 + kPadBytes) +
         (dq ? 0 : 2LL * 4 * tile);
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
// rows of `ld` bytes, 16 bytes a copy; positions at or past S are zero.
template <int DH>
__device__ __forceinline__ void stage(const float* __restrict__ src,
                                      uint8_t* dst, int ld, int b, int p0,
                                      int n, int S, int H, int h) {
  constexpr int kChunks = DH / 4;
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

// One block of either kernel, over query head h = blockIdx.x.  kDq: the
// block owns query rows (q and dO staged as the owned pair, k and v of the
// kv head streamed); else key rows (k and v of the kv head owned, q and dO
// of head h streamed with their lse and D).  part: null when g = 1.
template <int DH, bool kDq>
__global__ void __launch_bounds__(4 * kMaxRows)
    flash_prefill_bwd_kernel(const float* __restrict__ q,
                             const float* __restrict__ k,
                             const float* __restrict__ v,
                             const float* __restrict__ o,
                             const float* __restrict__ dout,
                             const float* __restrict__ lse,
                             float* __restrict__ dsum, float* __restrict__ dq,
                             float* __restrict__ dk, float* __restrict__ dv,
                             float* __restrict__ part, int S, int Hq,
                             int Hkv, int rows, int tile, int window,
                             float scale) {
  constexpr int kCols = DH / 16;  // 4-wide column chunks a thread owns
  constexpr int kLd = DH * 4 + kPadBytes;
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
  const int hk = h / (Hq / Hkv);
  const int n_own = (S + rows - 1) / rows;
  // heaviest first: the last q tile sees the most keys, the first k tile
  // the most queries
  const int own_tile = kDq ? n_own - 1 - (int)blockIdx.z : (int)blockIdx.z;
  const int p0 = own_tile * rows;      // the first owned position
  const int pos = p0 + r;              // this quad's position
  const int nj = tile / 4;             // streamed rows a thread scores
  const int lane = threadIdx.x % 32;
  const int quad0 = lane & ~3;

  float acc_a[4 * kCols];  // dq (dQ) or dk
  float acc_b[4 * kCols];  // dv (dK/dV only)
#pragma unroll
  for (int i = 0; i < 4 * kCols; ++i) acc_a[i] = acc_b[i] = 0.f;

  // the owned rows: q and dO of query head h, or k and v of its kv head
  if constexpr (kDq) {
    stage<DH>(q, own_a, kLd, b, p0, rows, S, Hq, h);
    stage<DH>(dout, own_b, kLd, b, p0, rows, S, Hq, h);
  } else {
    stage<DH>(k, own_a, kLd, b, p0, rows, S, Hkv, hk);
    stage<DH>(v, own_b, kLd, b, p0, rows, S, Hkv, hk);
  }
  __syncthreads();
  const float* ra = reinterpret_cast<const float*>(own_a + r * kLd);
  const float* rb = reinterpret_cast<const float*>(own_b + r * kLd);

  // dQ: the row's lse, and D = rowsum(dO o) over the quad's columns
  float row_lse = 0.f, row_d = 0.f;
  if constexpr (kDq) {
    if (pos < S) {
      const float* orow = o + (((long long)b * S + pos) * Hq + h) * DH;
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
  // limit (dQ); q tiles from the first at or after the owned keys to the
  // window's end (dK/dV)
  int first, last;
  if (kDq) {
    first = (window > 0 && p0 - window + 1 > 0) ? (p0 - window + 1) / tile
                                                : 0;
    last = min((S - 1) / tile, (p0 + rows - 1) / tile);
  } else {
    first = p0 / tile;
    last = (S - 1) / tile;
    if (window > 0) last = min(last, (p0 + rows - 2 + window) / tile);
  }

  for (int st = first; st <= last; ++st) {
    const int s0 = st * tile;
    __syncthreads();  // every thread is done with the previous tile
    if constexpr (kDq) {
      stage<DH>(k, str_a, kLd, b, s0, tile, S, Hkv, hk);
      stage<DH>(v, str_b, kLd, b, s0, tile, S, Hkv, hk);
    } else {
      stage<DH>(q, str_a, kLd, b, s0, tile, S, Hq, h);
      stage<DH>(dout, str_b, kLd, b, s0, tile, S, Hq, h);
      for (int e = threadIdx.x; e < tile; e += blockDim.x) {
        const int p = s0 + e;
        const long long i = ((long long)b * Hq + h) * S + p;
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
          sp[jj] = dot4(xa, load4(reinterpret_cast<const float*>(
                                  str_a + n * kLd) + c), sp[jj]);
          dp[jj] = dot4(xb, load4(reinterpret_cast<const float*>(
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
          const float* xa = reinterpret_cast<const float*>(str_a + n * kLd);
          const float* xb = reinterpret_cast<const float*>(str_b + n * kLd);
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

  if (pos < S) {
    if constexpr (kDq) {
      float* row = dq + (((long long)b * S + pos) * Hq + h) * DH;
#pragma unroll
      for (int a = 0; a < kCols; ++a)
        store4(row + 4 * (4 * a + t),
               make_float4(acc_a[4 * a] * scale, acc_a[4 * a + 1] * scale,
                           acc_a[4 * a + 2] * scale,
                           acc_a[4 * a + 3] * scale));
    } else {
      // g = 1: the kv head's rows; else head h's unscaled partials
      const float mul = part ? 1.f : scale;
      float* out_k = part ? part + (((long long)b * S + pos) * Hq + h) * DH
                          : dk + (((long long)b * S + pos) * Hkv + hk) * DH;
      float* out_v = part ? out_k + (long long)gridDim.y * S * Hq * DH
                          : dv + (((long long)b * S + pos) * Hkv + hk) * DH;
#pragma unroll
      for (int a = 0; a < kCols; ++a) {
        const int c = 4 * (4 * a + t);
        store4(out_k + c,
               make_float4(acc_a[4 * a] * mul, acc_a[4 * a + 1] * mul,
                           acc_a[4 * a + 2] * mul, acc_a[4 * a + 3] * mul));
        store4(out_v + c, make_float4(acc_b[4 * a], acc_b[4 * a + 1],
                                   acc_b[4 * a + 2], acc_b[4 * a + 3]));
      }
    }
  }
}

template <int DH, bool kDq>
int launch_one(const float* q, const float* k, const float* v,
               const float* o, const float* dout, const float* lse,
               float* dsum, float* dq, float* dk, float* dv, float* part,
               int B, int S, int Hq, int Hkv, int rows, int tile, int window,
               float scale, long long smem, cudaStream_t stream) {
  // the wrapper's budget table must price exactly this launch
  if (smem != bwd_smem_bytes(kDq, rows, tile, DH))
    return (int)cudaErrorInvalidValue;
  static std::atomic<long long> granted{48 * 1024};
  const int err = grant_smem(flash_prefill_bwd_kernel<DH, kDq>, smem, granted);
  if (err) return err;
  const dim3 grid(Hq, B, (S + rows - 1) / rows);
  flash_prefill_bwd_kernel<DH, kDq>
      <<<grid, 4 * rows, (size_t)smem, stream>>>(
          q, k, v, o, dout, lse, dsum, dq, dk, dv, part, S, Hq, Hkv, rows,
          tile, window, scale);
  return (int)cudaGetLastError();
}

// The dQ kernel (which writes D), then the dK/dV kernel (which reads it),
// then for g > 1 the reduction
template <int DH>
int launch_dh(const float* q, const float* k, const float* v, const float* o,
              const float* dout, const float* lse, float* dsum, float* dq,
              float* dk, float* dv, float* part, int B, int S, int Hq,
              int Hkv, int dq_rows, int dkv_rows, int tile, int window,
              float scale, long long smem_dq, long long smem_dkv,
              cudaStream_t stream) {
  int err = launch_one<DH, true>(q, k, v, o, dout, lse, dsum, dq, dk, dv,
                                 part, B, S, Hq, Hkv, dq_rows, tile, window,
                                 scale, smem_dq, stream);
  if (!err)
    err = launch_one<DH, false>(q, k, v, o, dout, lse, dsum, dq, dk, dv, part,
                                B, S, Hq, Hkv, dkv_rows, tile, window, scale,
                                smem_dkv, stream);
  if (err || part == nullptr) return err;
  return launch_group_sum<float>(part, dk, dv, B, S, Hq, Hkv, DH, scale,
                                 stream);
}

// The checks both instances make: shapes the grids take, and scratch for
// the partials exactly when g > 1
bool shape_ok(int B, int S, int Hq, int Hkv, int window, const float* part) {
  return B >= 1 && S >= 1 && Hkv >= 1 && Hq >= Hkv && Hq % Hkv == 0 &&
         window >= 0 && B <= 65535 && (S + 7) / 8 <= 65535 &&
         (Hq > Hkv) == (part != nullptr);
}

}  // namespace

extern "C" {

// Both entry points: q, o, dout, dq (B, S, Hq, dh); k, v, dk, dv (B, S,
// Hkv, dh), all contiguous and 16-byte aligned in the IO type; lse (B, Hq,
// S) f32 from K8t; dsum (B, Hq, S) f32 scratch for D; part f32 scratch of
// 2 B S Hq dh floats for the dK/dV partials when Hq > Hkv, else null.  dh
// is 16, 32, 64, 128 or 160; window 0 for full causal attention.  Launches
// the dQ kernel (grid Hq x B x q tiles), the dK/dV kernel (Hq x B x key
// tiles) and, when Hq > Hkv, the reduction.

#ifdef __CUDACC__
// bf16 on the tensor cores: 64-row tiles; smem_dq and smem_dkv must equal
// tc_smem_bytes of each kernel at the padded head width.
int flash_prefill_bwd_tc(const void* q, const void* k, const void* v,
                         const void* o, const void* dout, const float* lse,
                         float* dsum, void* dq, void* dk, void* dv,
                         float* part, int B, int S, int Hq, int Hkv, int dh,
                         int window, float scale, long long smem_dq,
                         long long smem_dkv, void* stream) {
  if (!shape_ok(B, S, Hq, Hkv, window, part))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16:
    case 32:
    case 64:
      return launch_tc<64>(q, k, v, o, dout, lse, dsum, dq, dk, dv, part, B,
                           S, Hq, Hkv, dh, window, scale, smem_dq, smem_dkv,
                           st);
    case 128:
      return launch_tc<128>(q, k, v, o, dout, lse, dsum, dq, dk, dv, part, B,
                            S, Hq, Hkv, dh, window, scale, smem_dq, smem_dkv,
                            st);
    case 160:
      return launch_tc<192>(q, k, v, o, dout, lse, dsum, dq, dk, dv, part, B,
                            S, Hq, Hkv, dh, window, scale, smem_dq, smem_dkv,
                            st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#endif  // __CUDACC__

// f32 on the SIMT kernels: dq_rows and dkv_rows a multiple of 8 up to 64
// (4 threads a row); tile a multiple of 4 up to 64.  smem_dq and smem_dkv
// must equal bwd_smem_bytes of their kernel.
int flash_prefill_bwd_f32(const float* q, const float* k, const float* v,
                          const float* o, const float* dout, const float* lse,
                          float* dsum, float* dq, float* dk, float* dv,
                          float* part, int B, int S, int Hq, int Hkv, int dh,
                          int dq_rows, int dkv_rows, int tile, int window,
                          float scale, long long smem_dq, long long smem_dkv,
                          void* stream) {
  auto rows_ok = [](int n) { return n >= 8 && n <= kMaxRows && n % 8 == 0; };
  if (!shape_ok(B, S, Hq, Hkv, window, part) || !rows_ok(dq_rows) ||
      !rows_ok(dkv_rows) || tile < 4 || tile > kMaxTile || tile % 4 != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define K8B_CASE(D)                                                          \
  case D:                                                                    \
    return launch_dh<D>(q, k, v, o, dout, lse, dsum, dq, dk, dv, part, B, S, \
                        Hq, Hkv, dq_rows, dkv_rows, tile, window, scale,     \
                        smem_dq, smem_dkv, st);
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

// The shared memory a launch must be given (dq != 0: the dQ kernel), for
// the tests that hold the budget table to it: the SIMT kernels' at `rows`
// and `tile`, and the tensor-core kernels' at head width dh.
long long flash_prefill_bwd_smem_bytes(int dq, int rows, int tile, int dh) {
  return bwd_smem_bytes(dq != 0, rows, tile, dh);
}

long long flash_prefill_bwd_tc_smem_bytes(int dq, int dh) {
  return tc_smem_bytes(dq != 0, padded(dh));
}

const char* flash_prefill_bwd_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
