// Blocked causal prefill attention (K8) for Hopper (sm_90a): a tensor-core
// instance for bf16 IO and a SIMT instance for f32 IO.
//
// Replaces the JAX package's Pallas kernel kernels/flash_prefill.py:_kernel,
// launched by flash_prefill's pallas_call: causal attention of q
// (B, S, Hq, dh) over k, v (B, S, Hkv, dh), query head h reading kv head
// h / (Hq / Hkv), optionally within the last `window` positions; scores
// (q . k) * scale in f32 masked to -1e30, an online softmax over kv tiles
// with m, l and acc in f32 and p masked to 0 after the exp, the output
// acc / max(l, 1e-30) in q's dtype.  kv tiles wholly in the future or
// before the window hold no valid key and are not visited (the Pallas
// kernel's pl.when skip).
//
// What bounds it on the H100.  At Qwen2-0.5B's served prefill (B = 4,
// S = 500, 14 query heads over 2 kv heads, dh 64, bf16) the causal half of
// the two products is 4 B Hq dh S (S + 1) / 2 = 1.8 G operations, 1.8 us at
// the 989 TFLOP/s of the bf16 tensor cores, against 8.2 MB of q, k, v and o
// (2.4 us at 3.35 TB/s); at Yi-9B's (32 over 4 heads of 128) 8.2 G
// operations (8.3 us) against 36.9 MB (11.0 us).  So the bound is the bytes,
// and the products have to run on the tensor cores to come near it.
//
// The tensor-core instance (bf16; flash_prefill_tc).  A block of one
// consumer warpgroup and one producer warp owns one (batch row, query
// head, q tile of 64 rows).  Blocks run heaviest first: the block index
// walks the q tiles from the last, which sees the most kv tiles, to the
// first, with the (row, head) pairs innermost so that the query heads of
// one kv head run side by side and share its tiles in L2.
//   - The producer warp loads the q tile once and the live k and v tiles
//     through a ring of kTcStages stages by TMA, bf16 as stored, in the
//     128-byte swizzle: a tile's rows are cut into column blocks of 64
//     (one 128-byte swizzle atom wide), dh padded to a multiple of 64 with
//     TMA's zero fill (16 and 32 -> 64, 160 -> 192).  Rows at or past S
//     arrive as zeros too.  Each stage has a full barrier (the TMA bytes)
//     and an empty barrier (the consumers' 128 threads).
//   - The consumer warpgroup computes S = Q K^T with wgmma m64nKBk16, both
//     operands K-major in shared memory (the natural (S, dh) rows), scales
//     and masks S on its accumulator fragment (causal, window, k < S)
//     where a tile crosses them, and runs the online softmax in f32
//     registers, in the exp2 domain: each row's values sit on the four
//     threads of a quad, so its maximum and sum take two shuffles.  p is
//     rounded to bf16 in registers, where the S accumulator's layout is
//     the A fragment's, and O += P V runs as wgmma m64nDHPk16 with A from
//     registers and V from shared memory, N-major (the transpose bit).  O
//     stays in f32 registers; the epilogue writes acc / max(l, 1e-30) in
//     bf16, no row at or past S and no padding column.
//   - Two blocks share an SM (the budget table's rule), so that one's
//     softmax overlaps the other's products and loads.  Variants timed on
//     the card were no faster at the served shapes: q in registers as the
//     A operand, the next tile's Q K^T or the softmax overlapped with P V
//     inside the warpgroup (both need the producer folded into the
//     warpgroup for registers), a wider kv tile, no k/v reloads at all.
//   - Numerics against the JAX kernel: one rounding more, p to bf16
//     before the PV product (the plain version's round_p repeats it); q . k
//     of bf16 inputs is exact in both, and both sum in f32.
//
// K8t, the training forward (flash_prefill_tc_traj, flash_prefill_f32_traj):
// either instance with its kLse flag set also writes each query row's
// log-sum-exp, lse = m + log(max(l, 1e-30)) in f32, laid out (B, Hq, S),
// for the backward K8b (flash_prefill_bwd.cu), which recomputes p from it.
// The flag adds one store to the epilogue and changes nothing before it, so
// at the same tiles K8t's output is K8's, bit for bit.  The tensor-core
// instance keeps m in the exp2 domain and converts it to the natural log
// once, there.  K8t has no TPU counterpart: the JAX package trains through
// its jnp flash_attention, which XLA differentiates.
//
// The SIMT instance (f32; flash_prefill_f32).  f32 on the tensor cores
// would be TF32, ~3 decimal digits, outside the f32 gates, so f32 keeps
// the first version: a block of 2 qb threads owns a q tile of qb rows and
// loops over the kv tiles itself.  Two threads share a query row: thread
// `half` holds the scores of keys 2 jj + half of the tile (jj < kb / 2) and
// the output columns of the 4-wide chunks 2 a + half, so m, l and acc stay
// in registers, and the pair exchanges its row maximum, its row sum and its
// probabilities with one shuffle each.  The q tile and the current k and v
// tiles are staged in shared memory, rows padded by kPad floats so that
// the 16-byte loads of a warp fall on distinct banks; rows at or past S are
// zero and masked.  Its f32 fmaf on the CUDA cores peak at 67 TFLOP/s.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

// The tensor-core instance needs tensor maps (cuTensorMapEncodeTiled) and
// wgmma: it is compiled by nvcc only.  The g++ mock of the CUDA runtime (tests/cuda_mock)
// builds the SIMT instance alone.
#ifdef __CUDACC__
#include <cuda.h>

#include "hopper.cuh"
#endif

namespace {

constexpr float kNegInf = -1e30f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ bool key_ok(int qp, int kp, int S, int window) {
  return kp <= qp && kp < S && (window <= 0 || qp - kp < window);
}

#ifdef __CUDACC__

// ===========================================================================
// The tensor-core instance
// ===========================================================================
constexpr int kTcQBlock = 64;   // rows of a q tile: one warpgroup's wgmma M
constexpr int kTcStages = 2;    // k/v stages in the ring
constexpr int kTcThreads = 160;  // one consumer warpgroup + one producer warp
constexpr int kAtomCols = 64;   // bf16 columns of a 128-byte swizzle row
constexpr int kSwizzleAlign = 1024;

// Dynamic shared memory of one block, in bytes: the slack to align the
// tiles to the swizzle's 1024 bytes, the q tile (64, dhp), kTcStages k and
// v tiles (kb, dhp), all bf16, and the barriers (the q tile's; a full and
// an empty one per stage).  kernels/flash_prefill.py:working_set_bytes
// prices the same.
__host__ __device__ constexpr int tc_smem_bytes(int kb, int dhp) {
  return kSwizzleAlign + 2 * kTcQBlock * dhp + 2 * kTcStages * 2 * kb * dhp +
         8 * (1 + 2 * kTcStages);
}

// Blocks the register file must leave room for: two where two blocks'
// shared memory fits an SM (228 KB, 1 KB of it reserved per block).  Of
// their ten warps one of the SM's four register files then holds three,
// which caps a thread at 168 registers.
__host__ __device__ constexpr int tc_min_blocks(int kb, int dhp) {
  return 2 * (tc_smem_bytes(kb, dhp) + 1024) <= 233472 ? 2 : 1;
}

// S (64, KB) (+)= Q K^T over 16 columns of dh, both K-major
template <int KB>
__device__ __forceinline__ void qk_product(float (&s)[KB / 2], uint64_t dq,
                                           uint64_t dk, int accumulate) {
  if constexpr (KB == 32) hopper::wgmma_ss_n32(s, dq, dk, accumulate);
  if constexpr (KB == 64) hopper::wgmma_ss_n64(s, dq, dk, accumulate);
}

// One kv tile's online softmax on the S accumulator fragment of rows r
// (m0, l0) and r + 8 (m1, l1).  The running maxima are kept in the exp2
// domain, scores times c = scale log2(e), so that p = exp(s scale - m) is
// one FFMA and one ex2.  The rows' maxima and sums are reduced over their
// quads.  p in f32 feeds the row sums, in bf16 pairs the PV product: the
// 16 keys of step t are accumulator blocks 2 t and 2 t + 1, whose
// registers in order are the A fragment's (r, r + 8) x (cq, cq + 8).
// kMask masks (causal, window, k < S) keys from kp0, the thread's first
// column of the tile; a masked key's score is -1e30 and its p 0.
template <int KB, bool kMask>
__device__ __forceinline__ void softmax_tile(
    float (&sc)[KB / 2], uint32_t (&pa)[KB / 16][4], float& m0, float& m1,
    float& l0, float& l1, float& alpha0, float& alpha1, float c, int qp0,
    int qp1, int kp0, int S, int window) {
  float mx0 = kNegInf, mx1 = kNegInf;
#pragma unroll
  for (int j = 0; j < KB / 8; ++j) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      if constexpr (kMask) {
        const int kp = kp0 + 8 * j + e;
        if (!key_ok(qp0, kp, S, window)) sc[4 * j + e] = kNegInf;
        if (!key_ok(qp1, kp, S, window)) sc[4 * j + 2 + e] = kNegInf;
      }
      mx0 = fmaxf(mx0, sc[4 * j + e]);
      mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
    }
  }
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
  mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
  mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
  const float mn0 = fmaxf(m0, mx0 * c), mn1 = fmaxf(m1, mx1 * c);
  alpha0 = hopper::exp2_approx(m0 - mn0);
  alpha1 = hopper::exp2_approx(m1 - mn1);
  float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
  for (int j = 0; j < KB / 8; ++j) {
    float p[4];
#pragma unroll
    for (int e = 0; e < 4; ++e)
      p[e] = hopper::exp2_approx(
          fmaf(sc[4 * j + e], c, e < 2 ? -mn0 : -mn1));
    if constexpr (kMask) {
      const int kp = kp0 + 8 * j;
      if (!key_ok(qp0, kp, S, window)) p[0] = 0.f;
      if (!key_ok(qp0, kp + 1, S, window)) p[1] = 0.f;
      if (!key_ok(qp1, kp, S, window)) p[2] = 0.f;
      if (!key_ok(qp1, kp + 1, S, window)) p[3] = 0.f;
    }
    ps0 += p[0] + p[1];
    ps1 += p[2] + p[3];
    pa[j / 2][2 * (j % 2)] = hopper::pack_bf16(p[0], p[1]);
    pa[j / 2][2 * (j % 2) + 1] = hopper::pack_bf16(p[2], p[3]);
  }
  ps0 += __shfl_xor_sync(0xffffffffu, ps0, 1);
  ps0 += __shfl_xor_sync(0xffffffffu, ps0, 2);
  ps1 += __shfl_xor_sync(0xffffffffu, ps1, 1);
  ps1 += __shfl_xor_sync(0xffffffffu, ps1, 2);
  l0 = l0 * alpha0 + ps0;
  l1 = l1 * alpha1 + ps1;
  m0 = mn0;
  m1 = mn1;
}

// kLse (K8t): also write each row's log-sum-exp to lse (B, Hq, S)
template <int DHP, int KB, bool kLse>
__global__ void __launch_bounds__(kTcThreads, tc_min_blocks(KB, DHP))
    flash_prefill_tc_kernel(const __grid_constant__ CUtensorMap tq,
                            const __grid_constant__ CUtensorMap tk,
                            const __grid_constant__ CUtensorMap tv,
                            __nv_bfloat16* __restrict__ o,
                            float* __restrict__ lse, int B, int S, int Hq,
                            int Hkv, int dh, int window, float scale) {
  constexpr int kChunks = DHP / kAtomCols;      // column blocks of a row
  constexpr int kQBytes = 2 * kTcQBlock * DHP;
  constexpr int kTileBytes = 2 * KB * DHP;      // one k or v tile
  extern __shared__ uint8_t smem_raw[];
  uint8_t* sq = hopper::align_1024(smem_raw);
  uint8_t* sk = sq + kQBytes;
  uint8_t* sv = sk + kTcStages * kTileBytes;
  uint64_t* q_full = reinterpret_cast<uint64_t*>(sv + kTcStages * kTileBytes);
  uint64_t* full = q_full + 1;
  uint64_t* empty = full + kTcStages;

  // heaviest first: q tiles from the last, (row, head) innermost
  const int nq = (S + kTcQBlock - 1) / kTcQBlock;
  const int bh = blockIdx.x % (B * Hq);
  const int q0 = (nq - 1 - (int)(blockIdx.x / (B * Hq))) * kTcQBlock;
  const int b = bh / Hq, hq = bh % Hq;
  const int hk = hq / (Hq / Hkv);
  // the live kv tiles: from the window's first to the causal limit
  int kt_first = 0;
  if (window > 0 && q0 - window + 1 > 0) kt_first = (q0 - window + 1) / KB;
  const int kt_last = min((S - 1) / KB, (q0 + kTcQBlock - 1) / KB);
  const int n_tiles = kt_last - kt_first + 1;

  if (threadIdx.x == 0) {
    hopper::mbar_init(q_full, 1);
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
      hopper::mbar_expect_tx(q_full, kQBytes);
#pragma unroll
      for (int c = 0; c < kChunks; ++c)
        hopper::tma_load_4d(sq + c * kTcQBlock * 128, &tq, q_full,
                            c * kAtomCols, hq, q0, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kTcStages;
        // the consumers released this stage's previous round
        if (i >= kTcStages)
          hopper::mbar_wait(&empty[s], ((i / kTcStages) & 1) ^ 1);
        hopper::mbar_expect_tx(&full[s], 2 * kTileBytes);
        const int k0 = (kt_first + i) * KB;
#pragma unroll
        for (int c = 0; c < kChunks; ++c) {
          hopper::tma_load_4d(sk + s * kTileBytes + c * KB * 128, &tk,
                              &full[s], c * kAtomCols, hk, k0, b);
          hopper::tma_load_4d(sv + s * kTileBytes + c * KB * 128, &tv,
                              &full[s], c * kAtomCols, hk, k0, b);
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
  float acc[DHP / 2];
#pragma unroll
  for (int i = 0; i < DHP / 2; ++i) acc[i] = 0.f;
  float m0 = kNegInf, m1 = kNegInf, l0 = 0.f, l1 = 0.f;
  const float to_exp2 = scale * 1.4426950408889634f;  // scale log2(e)
  const uint32_t q_addr = hopper::smem_addr(sq);

  hopper::mbar_wait(q_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kTcStages;
    const int k0 = (kt_first + i) * KB;
    hopper::mbar_wait(&full[s], (i / kTcStages) & 1);

    // S = Q K^T: 16 columns of dh a step, within a 128-byte swizzle row by
    // 32-byte offsets of the start address, across column blocks by whole
    // blocks
    float sc[KB / 2];
#pragma unroll
    for (int j = 0; j < KB / 2; ++j) sc[j] = 0.f;
    const uint32_t k_addr = hopper::smem_addr(sk + s * kTileBytes);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DHP / 16; ++kk) {
      const uint32_t col = (kk % 4) * 32;
      qk_product<KB>(
          sc,
          hopper::sw128_desc(q_addr + (kk / 4) * kTcQBlock * 128 + col, 16,
                             1024),
          hopper::sw128_desc(k_addr + (kk / 4) * KB * 128 + col, 16, 1024),
          kk > 0);
    }
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(sc);

    // the softmax; the mask only where the tile crosses the diagonal, S
    // or the window's start
    float alpha0, alpha1;
    uint32_t pa[KB / 16][4];
    const bool edge = k0 + KB - 1 > q0 || k0 + KB > S ||
                      (window > 0 && q0 + kTcQBlock - 1 - k0 >= window);
    if (edge)
      softmax_tile<KB, true>(sc, pa, m0, m1, l0, l1, alpha0, alpha1,
                             to_exp2, qp0, qp1, k0 + cq, S, window);
    else
      softmax_tile<KB, false>(sc, pa, m0, m1, l0, l1, alpha0, alpha1,
                              to_exp2, qp0, qp1, k0 + cq, S, window);

    // O = O alpha + P V: V's 16 keys of step t are two 8-row groups 1024
    // bytes apart (sbo), its column blocks KB rows of 128 bytes apart (lbo)
#pragma unroll
    for (int j = 0; j < DHP / 8; ++j) {
      acc[4 * j] *= alpha0;
      acc[4 * j + 1] *= alpha0;
      acc[4 * j + 2] *= alpha1;
      acc[4 * j + 3] *= alpha1;
    }
    const uint32_t v_addr = hopper::smem_addr(sv + s * kTileBytes);
    hopper::fence_regs(acc);
    hopper::wgmma_fence();
#pragma unroll
    for (int t = 0; t < KB / 16; ++t)
      hopper::wgmma_rs<DHP>(
          acc, pa[t],
          hopper::sw128_desc(v_addr + t * 16 * 128, KB * 128, 1024));
    hopper::wgmma_commit();
    hopper::wgmma_wait_all();
    hopper::fence_regs(acc);
    hopper::mbar_arrive(&empty[s]);  // k and v of this stage are read
  }

  const float lc0 = fmaxf(l0, 1e-30f), lc1 = fmaxf(l1, 1e-30f);
  __nv_bfloat16* o0 = o + (((long long)b * S + qp0) * Hq + hq) * dh;
  __nv_bfloat16* o1 = o0 + 8LL * Hq * dh;
#pragma unroll
  for (int j = 0; j < DHP / 8; ++j) {
    const int c = 8 * j + cq;
    if (c < dh) {
      if (qp0 < S)
        *reinterpret_cast<__nv_bfloat162*>(o0 + c) =
            __floats2bfloat162_rn(acc[4 * j] / lc0, acc[4 * j + 1] / lc0);
      if (qp1 < S)
        *reinterpret_cast<__nv_bfloat162*>(o1 + c) = __floats2bfloat162_rn(
            acc[4 * j + 2] / lc1, acc[4 * j + 3] / lc1);
    }
  }
  // K8t: the quad's first thread writes its two rows' lse; m is in the exp2
  // domain (scores times scale log2(e)), so m ln(2) is the natural maximum
  if constexpr (kLse) {
    if ((lane & 3) == 0) {
      float* row = lse + ((long long)b * Hq + hq) * S;
      if (qp0 < S) row[qp0] = m0 * kLn2 + logf(lc0);
      if (qp1 < S) row[qp1] = m1 * kLn2 + logf(lc1);
    }
  }
}

template <int DHP, int KB, bool kLse>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              float* lse, int B, int S, int Hq, int Hkv, int dh, int window,
              float scale, long long smem, cudaStream_t stream) {
  if (smem != tc_smem_bytes(KB, DHP)) return (int)cudaErrorInvalidValue;
  static std::atomic<long long> granted{48 * 1024};
  if (smem > granted.load()) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_tc_kernel<DHP, KB, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted.store(smem);
  }
  CUtensorMap tq, tk, tv;
  int err = hopper::encode_map(&tq, q, B, S, Hq, dh, kTcQBlock);
  if (!err) err = hopper::encode_map(&tk, k, B, S, Hkv, dh, KB);
  if (!err) err = hopper::encode_map(&tv, v, B, S, Hkv, dh, KB);
  if (err) return err;
  const long long blocks =
      (long long)((S + kTcQBlock - 1) / kTcQBlock) * B * Hq;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  flash_prefill_tc_kernel<DHP, KB, kLse>
      <<<(unsigned)blocks, kTcThreads, (size_t)smem, stream>>>(
          tq, tk, tv, (__nv_bfloat16*)o, lse, B, S, Hq, Hkv, dh, window,
          scale);
  return (int)cudaGetLastError();
}

// K8 without lse, K8t with it
template <int DHP, int KB>
int launch_tc_lse(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int S, int Hq, int Hkv, int dh,
                  int window, float scale, long long smem,
                  cudaStream_t stream) {
  if (lse != nullptr)
    return launch_tc<DHP, KB, true>(q, k, v, o, lse, B, S, Hq, Hkv, dh,
                                    window, scale, smem, stream);
  return launch_tc<DHP, KB, false>(q, k, v, o, lse, B, S, Hq, Hkv, dh,
                                   window, scale, smem, stream);
}

template <int DHP>
int launch_tc_kb(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int S, int Hq, int Hkv, int dh, int kb,
                 int window, float scale, long long smem,
                 cudaStream_t stream) {
  switch (kb) {
    case 32:
      return launch_tc_lse<DHP, 32>(q, k, v, o, lse, B, S, Hq, Hkv, dh,
                                    window, scale, smem, stream);
    case 64:
      return launch_tc_lse<DHP, 64>(q, k, v, o, lse, B, S, Hq, Hkv, dh,
                                    window, scale, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

int launch_tc_dh(const void* q, const void* k, const void* v, void* o,
                 float* lse, int B, int S, int Hq, int Hkv, int dh, int kb,
                 int window, float scale, long long smem, void* stream) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || window < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  switch (dh) {
    case 16:
    case 32:
    case 64:
      return launch_tc_kb<64>(q, k, v, o, lse, B, S, Hq, Hkv, dh, kb, window,
                              scale, smem, st);
    case 128:
      return launch_tc_kb<128>(q, k, v, o, lse, B, S, Hq, Hkv, dh, kb,
                               window, scale, smem, st);
    case 160:
      return launch_tc_kb<192>(q, k, v, o, lse, B, S, Hq, Hkv, dh, kb,
                               window, scale, smem, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}
#endif  // __CUDACC__

// ===========================================================================
// The SIMT instance
// ===========================================================================
constexpr int kMaxQBlock = 64;  // rows of a q tile: 2 kMaxQBlock threads
constexpr int kMaxKBlock = 64;  // rows of a k or v tile
constexpr int kPad = 4;         // floats after each staged row

// Shared memory of one block, in floats: the q tile (qb, dh + kPad) and the
// k and v tiles (kb, dh + kPad).  kernels/flash_prefill.py:working_set_bytes
// prices the same terms.
__host__ __device__ inline long long smem_floats(int qb, int kb, int dh) {
  return (long long)(qb + 2 * kb) * (dh + kPad);
}

// Positions [p0, p0 + rows) of head h of a (B, S, H, DH) tensor into a
// (rows, DH + kPad) tile; positions at or past S are zero.
template <int DH>
__device__ __forceinline__ void load_tile(const float* __restrict__ src,
                                          float* dst, int b, int p0,
                                          int rows, int S, int H, int h) {
  constexpr int kChunks = DH / 4;
  for (int e = threadIdx.x; e < rows * kChunks; e += blockDim.x) {
    const int r = e / kChunks, c = (e % kChunks) * 4;
    const int p = p0 + r;
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (p < S)
      x = *reinterpret_cast<const float4*>(
          src + (((long long)b * S + p) * H + h) * DH + c);
    *reinterpret_cast<float4*>(dst + r * (DH + kPad) + c) = x;
  }
}

// kLse (K8t): also write each row's log-sum-exp to lse (B, Hq, S)
template <int DH, bool kLse>
__global__ void __launch_bounds__(2 * kMaxQBlock)
    flash_prefill_kernel(const float* __restrict__ q,
                         const float* __restrict__ k,
                         const float* __restrict__ v, float* __restrict__ o,
                         float* __restrict__ lse, int S, int Hq, int Hkv,
                         int qb, int kb, int window, float scale) {
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

  load_tile<DH>(q, sq, b, q0, qb, S, Hq, hq);

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
    load_tile<DH>(k, sk, b, k0, kb, S, Hkv, hk);
    load_tile<DH>(v, sv, b, k0, kb, S, Hkv, hk);
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
        const bool ok = key_ok(qp, kp, S, window);
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
    float* orow = o + (((long long)b * S + qp) * Hq + hq) * DH + 4 * half;
#pragma unroll
    for (int a = 0; a < kOut; ++a)
      *reinterpret_cast<float4*>(orow + 8 * a) =
          make_float4(acc[4 * a] / lc, acc[4 * a + 1] / lc,
                      acc[4 * a + 2] / lc, acc[4 * a + 3] / lc);
    // K8t: m and l are the pair's; the first thread writes the row's lse
    if constexpr (kLse)
      if (half == 0) lse[((long long)b * Hq + hq) * S + qp] = m + logf(lc);
  }
}

template <int DH, bool kLse>
int launch_simt(const float* q, const float* k, const float* v, float* o,
                float* lse, int B, int S, int Hq, int Hkv, int qb, int kb,
                int window, float scale, long long smem,
                cudaStream_t stream) {
  // raise the block's shared-memory limit once per instance
  static std::atomic<long long> granted{48 * 1024};
  if (smem > granted.load()) {
    const cudaError_t e = cudaFuncSetAttribute(
        flash_prefill_kernel<DH, kLse>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
    granted.store(smem);
  }
  const dim3 grid((S + qb - 1) / qb, Hq, B);
  flash_prefill_kernel<DH, kLse><<<grid, 2 * qb, (size_t)smem, stream>>>(
      q, k, v, o, lse, S, Hq, Hkv, qb, kb, window, scale);
  return (int)cudaGetLastError();
}

// K8 without lse, K8t with it
template <int DH>
int launch_dh(const float* q, const float* k, const float* v, float* o,
              float* lse, int B, int S, int Hq, int Hkv, int qb, int kb,
              int window, float scale, long long smem, cudaStream_t stream) {
  if (lse != nullptr)
    return launch_simt<DH, true>(q, k, v, o, lse, B, S, Hq, Hkv, qb, kb,
                                 window, scale, smem, stream);
  return launch_simt<DH, false>(q, k, v, o, lse, B, S, Hq, Hkv, qb, kb,
                                window, scale, smem, stream);
}

int launch(const float* q, const float* k, const float* v, float* o,
           float* lse, int B, int S, int Hq, int Hkv, int dh, int qb, int kb,
           int window, float scale, long long smem, void* stream_) {
  if (B < 1 || S < 1 || Hkv < 1 || Hq < Hkv || Hq % Hkv != 0 || qb < 16 ||
      qb > kMaxQBlock || qb % 16 != 0 || kb < 2 || kb > kMaxKBlock ||
      kb % 2 != 0 || window < 0 || Hq > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  // the wrapper's budget table must price exactly this launch
  if (smem != 4 * smem_floats(qb, kb, dh)) return (int)cudaErrorInvalidValue;
  const cudaStream_t stream = (cudaStream_t)stream_;
  switch (dh) {
    case 16:
      return launch_dh<16>(q, k, v, o, lse, B, S, Hq, Hkv, qb, kb, window,
                           scale, smem, stream);
    case 32:
      return launch_dh<32>(q, k, v, o, lse, B, S, Hq, Hkv, qb, kb, window,
                           scale, smem, stream);
    case 64:
      return launch_dh<64>(q, k, v, o, lse, B, S, Hq, Hkv, qb, kb, window,
                           scale, smem, stream);
    case 128:
      return launch_dh<128>(q, k, v, o, lse, B, S, Hq, Hkv, qb, kb, window,
                            scale, smem, stream);
    case 160:
      return launch_dh<160>(q, k, v, o, lse, B, S, Hq, Hkv, qb, kb, window,
                            scale, smem, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

#ifdef __CUDACC__
// q, o (B, S, Hq, dh); k, v (B, S, Hkv, dh); all contiguous and 16-byte
// aligned, bf16.  dh is 16, 32, 64, 128 or 160 (padded to 64, 64, 64, 128,
// 192 in shared memory); kb 32 or 64; window 0 for full causal attention.
// smem must equal tc_smem_bytes(kb, padded dh).  Grid: ceil(S / 64) Hq B
// blocks of 160 threads, heaviest first.
int flash_prefill_tc(const void* q, const void* k, const void* v, void* o,
                     int B, int S, int Hq, int Hkv, int dh, int kb,
                     int window, float scale, long long smem, void* stream) {
  return launch_tc_dh(q, k, v, o, nullptr, B, S, Hq, Hkv, dh, kb, window,
                      scale, smem, stream);
}

// K8t on the tensor cores: flash_prefill_tc that also writes lse (B, Hq, S)
// f32, each row's m + log(max(l, 1e-30)) in the natural log.
int flash_prefill_tc_traj(const void* q, const void* k, const void* v,
                          void* o, float* lse, int B, int S, int Hq, int Hkv,
                          int dh, int kb, int window, float scale,
                          long long smem, void* stream) {
  return launch_tc_dh(q, k, v, o, lse, B, S, Hq, Hkv, dh, kb, window, scale,
                      smem, stream);
}
#endif  // __CUDACC__

// q, o (B, S, Hq, dh); k, v (B, S, Hkv, dh); all contiguous and 16-byte
// aligned, f32.  dh is 16, 32, 64, 128 or 160; qb a multiple of 16 up to 64,
// kb even up to 64; window 0 for full causal attention.  smem must equal
// 4 * smem_floats(qb, kb, dh) bytes.  Grid: ceil(S / qb) x Hq x B blocks of
// 2 qb threads.
int flash_prefill_f32(const float* q, const float* k, const float* v,
                      float* o, int B, int S, int Hq, int Hkv, int dh, int qb,
                      int kb, int window, float scale, long long smem,
                      void* stream) {
  return launch(q, k, v, o, nullptr, B, S, Hq, Hkv, dh, qb, kb, window,
                scale, smem, stream);
}

// K8t on the SIMT instance: flash_prefill_f32 that also writes lse
// (B, Hq, S) f32.
int flash_prefill_f32_traj(const float* q, const float* k, const float* v,
                           float* o, float* lse, int B, int S, int Hq,
                           int Hkv, int dh, int qb, int kb, int window,
                           float scale, long long smem, void* stream) {
  return launch(q, k, v, o, lse, B, S, Hq, Hkv, dh, qb, kb, window, scale,
                smem, stream);
}

const char* flash_prefill_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
