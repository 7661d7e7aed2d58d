// The chunk math of the RWKV6 chunked scan, shared by the forward
// (csrc/wkv6.cu: K6, K6t) and the backward (csrc/wkv6_bwd.cu: K6b): the
// shared-memory layout both kernels and kernels/wkv6.py:working_set_bytes
// price, the window loads, the column cumsums, the sub-chunk decay
// factors, the intra-chunk scores A and the register-tiled products.
//
// Sub-chunks.  A chunk of C steps splits into sub-chunks of s = min(8, C)
// steps (the last one shorter when s does not divide C).  With L the
// inclusive cumsum of logw down each column and Lp_i = L_{i-1} (0 at
// i = 0), the pairwise decay e^{Lp_i - L_j} (j < i) factors, for i in
// sub-chunk I and j in an earlier sub-chunk J, through b_I = the step
// before I and e_J = the last step of J (e_J <= b_I < i):
//   e^{Lp_i - L_j} = alpha_i * gamma_IJ * beta_j,
//   alpha_i = e^{Lp_i - L_{b_I}},  gamma_IJ = e^{L_{b_I} - L_{e_J}},
//   beta_j  = e^{L_{e_J} - L_j},
// three exponents that are each <= 0, so nothing overflows, and a factor
// that underflows stands for a product that is smaller still.  The blocks
// of A below the diagonal blocks, and the intra-chunk sums of dr and dk,
// become products of r * alpha and k * beta scaled by gamma per column.
// Only the diagonal sub-blocks keep the pairwise exponent: diag_pass takes
// each of those decays once per chunk and uses it for A (and for dr and dk
// in the backward).  Every exponent goes through exp_le0, which clamps its
// argument at 0: the warp-scan cumsums round in tree order, so a later
// cumsum can exceed an earlier one by an ulp.
//
// Products.  Every decay-free product is a register tile (tile_mac): a
// thread holds TM x TN outputs, rows contiguous, columns strided by the
// tile grid's width, so a warp reads one operand as a broadcast and the
// other along a row; every (rows, d) tile is padded by one word, so reads
// down a column hit distinct banks.  Each output is summed by one thread
// in a fixed order, so a row's results do not depend on the launch: the
// kernels are deterministic and a row alone equals the same row in a
// batch.  All arithmetic is f32.

#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

namespace wkv {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSub = 8;  // steps of a sub-chunk
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// e^x for an exponent that is <= 0 in exact arithmetic.
__device__ __forceinline__ float exp_le0(float x) {
  return __expf(fminf(x, 0.f));
}

// The chunk's shape: padded strides and its sub-chunks.
struct Dims {
  int C, dk, dv, pk, pv, pc, s, ns, npairs;
};

__host__ __device__ inline Dims dims(int C, int dk, int dv) {
  Dims d;
  d.C = C;
  d.dk = dk;
  d.dv = dv;
  d.pk = dk + 1;
  d.pv = dv + 1;
  d.pc = C + 1;
  d.s = C < kSub ? C : kSub;
  d.ns = (C + d.s - 1) / d.s;
  d.npairs = d.ns * (d.ns - 1) / 2;
  return d;
}

// Index of the sub-chunk pair (I, J), J < I, in the gamma table.
__device__ __forceinline__ int pair(int I, int J) {
  return I * (I - 1) / 2 + J;
}

// Offsets of one block's shared memory, in floats: the (C, dk + 1) tiles
// r, k, L, r * alpha, k * beta, and r * e^{Lp}, k * e^{Llast - L} (the
// backward computes these two into the tiles of r * alpha and k * beta
// once those are read, and adds its dr and dk partials instead); v [and
// dO] as (C, dv + 1); A as (C, C + 1) (the backward keeps dA transposed in
// its upper triangle, dA_ij at [j][i] for j < i); the state S and [the
// backward's] state cotangent dS as (dk, dv + 1); gamma (npairs, dk + 1);
// u, [Llast's term (two), du,] the bonus b [and db = dA's diagonal].  The
// windows are read straight into the tiles at the start of each chunk.
// kernels/wkv6.py:working_set_bytes prices the same terms.
struct Layout {
  int R, K, L, Ra, Kb, RE, KD, GR, GK, V, DO, A, S, dS, G, u, lt, du, b, db;
  long long bytes;
};

__host__ __device__ inline Layout layout(bool bwd, const Dims& d) {
  Layout l;
  const int ck = d.C * d.pk, cv = d.C * d.pv, cc = d.C * d.pc;
  const int kv = d.dk * d.pv;
  int at = 0;
  l.R = at;
  at += ck;
  l.K = at;
  at += ck;
  l.L = at;
  at += ck;
  l.Ra = at;
  at += ck;
  l.Kb = at;
  at += ck;
  l.RE = bwd ? l.Ra : at;
  at += bwd ? 0 : ck;
  l.KD = bwd ? l.Kb : at;
  at += bwd ? 0 : ck;
  l.GR = at;
  at += bwd ? ck : 0;
  l.GK = at;
  at += bwd ? ck : 0;
  l.V = at;
  at += cv;
  l.DO = at;
  at += bwd ? cv : 0;
  l.A = at;
  at += cc;
  l.S = at;
  at += kv;
  l.dS = at;
  at += bwd ? kv : 0;
  l.G = at;
  at += d.npairs * d.pk;
  l.u = at;
  at += d.dk;
  l.lt = at;
  at += bwd ? 2 * d.dk : 0;
  l.du = at;
  at += bwd ? d.dk : 0;
  l.b = at;
  at += d.C;
  l.db = at;
  at += bwd ? d.C : 0;
  l.bytes = 4LL * at;
  return l;
}

// ---------------------------------------------------------------------------
// Window loads
// ---------------------------------------------------------------------------
// Element q of a thread's share of a (rows, w) block: flat index tid +
// q * kThreads, row and column advanced without dividing.
struct Walk {
  int i, c, di, dc, w;
  __device__ __forceinline__ Walk(int tid, int w_) : w(w_) {
    i = tid / w;
    c = tid - i * w;
    di = kThreads / w;
    dc = kThreads - di * w;
  }
  __device__ __forceinline__ void next() {
    i += di;
    c += dc;
    if (c >= w) {
      c -= w;
      ++i;
    }
  }
};

// NT windows of one width, n rows each read straight from global memory,
// the rows from n to C zero (identity steps).  Each thread issues kBatch
// loads of every window before storing any, so their latencies overlap.
template <int NT, typename IO>
__device__ __forceinline__ void load_rows(float* const (&tile)[NT], int ld,
                                          const IO* const (&src)[NT], int n,
                                          int C, int w, int tid) {
  constexpr int kBatch = 8;
  Walk at(tid, w);
  for (int e = tid; e < C * w; e += kBatch * kThreads) {
    float v[NT][kBatch];
    Walk p = at;
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
        v[t][q] = p.i < n ? to_f32(src[t][p.i * w + p.c]) : 0.f;
      p.next();
    }
#pragma unroll
    for (int q = 0; q < kBatch; ++q) {
#pragma unroll
      for (int t = 0; t < NT; ++t)
        if (at.i < C) tile[t][at.i * ld + at.c] = v[t][q];
      at.next();
    }
  }
}

// n rows of f32 from global memory (a window, or a (dk, dv) state) into a
// padded tile by 4-byte cp.async, the rows from n to C zero; the caller
// commits and waits.
__device__ __forceinline__ void copy_rows(float* tile, int ld,
                                          const float* src, int n, int C,
                                          int w, int tid) {
  Walk at(tid, w);
  for (int e = tid; e < C * w; e += kThreads, at.next()) {
    if (at.i < n)
      __pipeline_memcpy_async(tile + at.i * ld + at.c, src + e, 4);
    else
      tile[at.i * ld + at.c] = 0.f;
  }
}

// A padded (rows, w) tile out to contiguous global memory.
__device__ __forceinline__ void store_rows(float* dst, const float* tile,
                                           int ld, int rows, int w, int warp,
                                           int lane) {
  for (int i = warp; i < rows; i += kWarps)
    for (int c = lane; c < w; c += 32) dst[i * w + c] = tile[i * ld + c];
}

// ---------------------------------------------------------------------------
// Column scans
// ---------------------------------------------------------------------------
// Inclusive cumsum down each of the ncols columns of X (C rows, stride
// ld), in place: a warp per column, a lane per row, 32 rows at a time with
// the running total carried.
__device__ __forceinline__ void scan_cols(float* X, int C, int ncols, int ld,
                                          int warp, int lane) {
  for (int c = warp; c < ncols; c += kWarps) {
    float carry = 0.f;
    for (int base = 0; base < C; base += 32) {
      const int i = base + lane;
      float x = i < C ? X[i * ld + c] : 0.f;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const float y = __shfl_up_sync(kFull, x, o);
        if (lane >= o) x += y;
      }
      x += carry;
      if (i < C) X[i * ld + c] = x;
      carry = __shfl_sync(kFull, x, 31);
    }
  }
}

// Sum of x over the warp, the same tree in every lane.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o >= 1; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
}

// ---------------------------------------------------------------------------
// Per-chunk factors
// ---------------------------------------------------------------------------
// r * alpha and k * beta (C, dk); gamma for each pair of sub-chunks
// (npairs, dk); the bonus b_i = r_i . u . k_i; with RE and KD also
// r * e^{Lp} and k * e^{Llast - L} (the forward; the backward takes them
// later with decay_operands).  L holds the inclusive cumsums.  A warp per
// row, a lane per column.
__device__ __forceinline__ void prep(const Dims& d, const float* R,
                                     const float* K, const float* L,
                                     const float* u, float* Ra, float* Kb,
                                     float* RE, float* KD, float* G, float* b,
                                     int warp, int lane) {
  const int pk = d.pk, s = d.s;
  const float* Llast = L + (d.C - 1) * pk;
  for (int i = warp; i < d.C; i += kWarps) {
    const int I = i / s;
    const float* Lb = L + (I * s - 1) * pk;                   // I > 0
    const float* Le = L + (min(d.C, (I + 1) * s) - 1) * pk;  // I < ns - 1
    float bonus = 0.f;
    for (int c = lane; c < d.dk; c += 32) {
      const int e = i * pk + c;
      const float Li = L[e], Lp = i > 0 ? L[e - pk] : 0.f;
      const float r = R[e], k = K[e];
      Ra[e] = I > 0 ? r * exp_le0(Lp - Lb[c]) : 0.f;
      Kb[e] = I < d.ns - 1 ? k * exp_le0(Le[c] - Li) : 0.f;
      if (RE != nullptr) {
        RE[e] = r * exp_le0(Lp);
        KD[e] = k * exp_le0(Llast[c] - Li);
      }
      bonus = fmaf(r * u[c], k, bonus);
    }
    bonus = warp_sum(bonus);
    if (lane == 0) b[i] = bonus;
  }
  for (int p = warp; p < d.npairs; p += kWarps) {
    int I = 1;
    while (I * (I + 1) / 2 <= p) ++I;
    const int J = p - I * (I - 1) / 2;
    const float* Lb = L + (I * s - 1) * pk;
    const float* Le = L + (J * s + s - 1) * pk;
    for (int c = lane; c < d.dk; c += 32)
      G[p * pk + c] = exp_le0(Lb[c] - Le[c]);
  }
}

// r * e^{Lp} and k * e^{Llast - L} into RE and KD (the backward's second
// use of the r * alpha and k * beta tiles).
__device__ __forceinline__ void decay_operands(const Dims& d, const float* R,
                                               const float* K, const float* L,
                                               float* RE, float* KD, int warp,
                                               int lane) {
  const int pk = d.pk;
  const float* Llast = L + (d.C - 1) * pk;
  for (int i = warp; i < d.C; i += kWarps)
    for (int c = lane; c < d.dk; c += 32) {
      const int e = i * pk + c;
      RE[e] = R[e] * exp_le0(i > 0 ? L[e - pk] : 0.f);
      KD[e] = K[e] * exp_le0(Llast[c] - L[e]);
    }
}

// ---------------------------------------------------------------------------
// Register tiles
// ---------------------------------------------------------------------------
// acc[x][y] += sum_{k0 <= k < k1} a[oa[x] + k * sa] * b[ob[y] + k * sb]
template <int TM, int TN>
__device__ __forceinline__ void tile_mac(float (&acc)[TM][TN],
                                         const float* a, const int (&oa)[TM],
                                         int sa, const float* b,
                                         const int (&ob)[TN], int sb, int k0,
                                         int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int x = 0; x < TM; ++x) av[x] = a[oa[x] + k * sa];
#pragma unroll
    for (int y = 0; y < TN; ++y) bv[y] = b[ob[y] + k * sb];
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TN; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

// The same with the b operand's column y scaled by g[y].
template <int TM, int TN>
__device__ __forceinline__ void tile_mac_scaled(float (&acc)[TM][TN],
                                                const float* a,
                                                const int (&oa)[TM], int sa,
                                                const float* b,
                                                const int (&ob)[TN], int sb,
                                                const float (&g)[TN], int k0,
                                                int k1) {
#pragma unroll 4
  for (int k = k0; k < k1; ++k) {
    float av[TM], bv[TN];
#pragma unroll
    for (int x = 0; x < TM; ++x) av[x] = a[oa[x] + k * sa];
#pragma unroll
    for (int y = 0; y < TN; ++y) bv[y] = b[ob[y] + k * sb] * g[y];
#pragma unroll
    for (int x = 0; x < TM; ++x)
#pragma unroll
      for (int y = 0; y < TN; ++y) acc[x][y] = fmaf(av[x], bv[y], acc[x][y]);
  }
}

template <int TM, int TN>
__device__ __forceinline__ void zero(float (&acc)[TM][TN]) {
#pragma unroll
  for (int x = 0; x < TM; ++x)
#pragma unroll
    for (int y = 0; y < TN; ++y) acc[x][y] = 0.f;
}

// One thread's tile of an (M, N) output: TM contiguous rows from m0, TN
// columns n0 + y * nstride; out-of-range rows and columns are clamped to
// the last (their results are dropped by the caller's bounds checks).
template <int TM, int TN>
struct Tile {
  int m[TM], n[TN];
  __device__ __forceinline__ Tile(int t, int M, int N) {
    const int tiles_n = (N + TN - 1) / TN;
    const int tm = t / tiles_n, tn = t - tm * tiles_n;
#pragma unroll
    for (int x = 0; x < TM; ++x) m[x] = tm * TM + x;
#pragma unroll
    for (int y = 0; y < TN; ++y) n[y] = tn + y * tiles_n;
  }
  __device__ __forceinline__ int mc(int x, int M) const {
    return min(m[x], M - 1);
  }
  __device__ __forceinline__ int nc(int y, int N) const {
    return min(n[y], N - 1);
  }
};

template <int TM, int TN>
__device__ __forceinline__ int tiles(int M, int N) {
  return ((M + TM - 1) / TM) * ((N + TN - 1) / TN);
}

// ---------------------------------------------------------------------------
// The scores A
// ---------------------------------------------------------------------------
// A below the diagonal sub-blocks, A_ij = sum_c (r alpha)_ic gamma_IJc
// (k beta)_jc, in 2 x 2 tiles that never straddle a sub-chunk (s is even
// whenever there is more than one sub-chunk); the bonus b_i on the
// diagonal.  The diagonal blocks' lower part is diag_pass's.  The forward
// (packed = false) zeroes A above the diagonal; the backward (packed)
// writes dA_ij = dO_i . v_j (j < i) there, transposed, at [j][i].
__device__ __forceinline__ void scores(const Dims& d, const float* Ra,
                                       const float* Kb, const float* G,
                                       const float* b, float* A,
                                       const float* DO, const float* V,
                                       bool packed, int tid) {
  const int C = d.C, TT = (C + 1) / 2;
  for (int t = tid; t < TT * TT; t += kThreads) {
    const int tm = t / TT, tn = t - tm * TT;
    const int i0 = 2 * tm, j0 = 2 * tn;
    const int I = i0 / d.s, J = j0 / d.s;
    if (J < I) {
      const int oi[2] = {min(i0, C - 1) * d.pk, min(i0 + 1, C - 1) * d.pk};
      const int oj[2] = {min(j0, C - 1) * d.pk, min(j0 + 1, C - 1) * d.pk};
      const float* g = G + pair(I, J) * d.pk;
      float acc[2][2];
      zero(acc);
      for (int c = 0; c < d.dk; ++c) {
        const float gc = g[c];
        const float a0 = Ra[oi[0] + c] * gc, a1 = Ra[oi[1] + c] * gc;
        const float b0 = Kb[oj[0] + c], b1 = Kb[oj[1] + c];
        acc[0][0] = fmaf(a0, b0, acc[0][0]);
        acc[0][1] = fmaf(a0, b1, acc[0][1]);
        acc[1][0] = fmaf(a1, b0, acc[1][0]);
        acc[1][1] = fmaf(a1, b1, acc[1][1]);
      }
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 2; ++y)
          if (i0 + x < C && j0 + y < C) A[(i0 + x) * d.pc + j0 + y] = acc[x][y];
    } else if (!packed) {
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 2; ++y) {
          const int i = i0 + x, j = j0 + y;
          if (i < C && j < C && j > i) A[i * d.pc + j] = 0.f;
        }
    }
    if (tn == tm)
#pragma unroll
      for (int x = 0; x < 2; ++x)
        if (i0 + x < C) A[(i0 + x) * d.pc + i0 + x] = b[i0 + x];
    if (packed && tn <= tm) {
      const int oo[2] = {min(i0, C - 1) * d.pv, min(i0 + 1, C - 1) * d.pv};
      const int ov[2] = {min(j0, C - 1) * d.pv, min(j0 + 1, C - 1) * d.pv};
      float acc[2][2];
      zero(acc);
      tile_mac(acc, DO, oo, 1, V, ov, 1, 0, d.dv);
#pragma unroll
      for (int x = 0; x < 2; ++x)
#pragma unroll
        for (int y = 0; y < 2; ++y)
          if (i0 + x < C && j0 + y < i0 + x)
            A[(j0 + y) * d.pc + i0 + x] = acc[x][y];
    }
  }
}

// The diagonal sub-blocks: a warp per sub-chunk, a lane per column (32 at
// a time).  Each pairwise decay e^{Lp_ic - L_jc} (i > j in one sub-chunk)
// is taken once and used for A_ij's column term and, in the backward, for
// dr_ic += dA_ij k_jc decay and dk_jc += dA_ij r_ic decay (dA read from
// A's upper triangle; written to GR and GK, the tiles the products add
// to).  A_ij sums its column terms over
// the warp by a halving exchange: after five shuffle steps lane p holds
// pair p's sum.
template <bool kBwd>
__device__ __forceinline__ void diag_pass(const Dims& d, const float* R,
                                          const float* K, const float* L,
                                          float* A, float* GR, float* GK,
                                          int warp, int lane) {
  const int pk = d.pk;
  for (int I = warp; I < d.ns; I += kWarps) {
    const int i0 = I * d.s, n = min(d.s, d.C - i0);
    float part[32];
#pragma unroll
    for (int p = 0; p < 32; ++p) part[p] = 0.f;
    for (int c0 = 0; c0 < d.dk; c0 += 32) {
      const int c = c0 + lane;
      const bool live = c < d.dk;
      // row a's L_{i-1} is ll[a - 1]: only rows a >= 1 have a j < a
      float rr[kSub], kk[kSub], ll[kSub], gk[kSub];
#pragma unroll
      for (int a = 0; a < kSub; ++a) {
        const bool in = live && a < n;
        const int i = i0 + a;
        rr[a] = in ? R[i * pk + c] : 0.f;
        kk[a] = in ? K[i * pk + c] : 0.f;
        ll[a] = in ? L[i * pk + c] : 0.f;
        gk[a] = 0.f;
      }
#pragma unroll
      for (int a = 1; a < kSub; ++a) {
        if (a >= n) break;
        float gr = 0.f;
#pragma unroll
        for (int j = 0; j < a; ++j) {
          const float dec = exp_le0(ll[a - 1] - ll[j]);
          const int p = a * (a - 1) / 2 + j;
          part[p] = fmaf(rr[a] * kk[j], dec, part[p]);
          if (kBwd) {
            const float da = A[(i0 + j) * d.pc + i0 + a];  // dA, packed
            gr = fmaf(da * kk[j], dec, gr);
            gk[j] = fmaf(da * rr[a], dec, gk[j]);
          }
        }
        if (kBwd && live) GR[(i0 + a) * pk + c] = gr;
      }
      if (kBwd && live) {
        GR[i0 * pk + c] = 0.f;  // the sub-chunk's first row has no j < i
#pragma unroll
        for (int a = 0; a < kSub; ++a)
          if (a < n) GK[(i0 + a) * pk + c] = gk[a];
      }
    }
#pragma unroll
    for (int off = 16; off >= 1; off >>= 1) {
      const bool up = lane & off;
#pragma unroll
      for (int q = 0; q < off; ++q) {
        const float send = up ? part[q] : part[q + off];
        const float keep = up ? part[q + off] : part[q];
        part[q] = keep + __shfl_xor_sync(kFull, send, off);
      }
    }
    if (lane < n * (n - 1) / 2) {
      int a = 1;
      while (a * (a + 1) / 2 <= lane) ++a;
      const int j = lane - a * (a - 1) / 2;
      A[(i0 + a) * d.pc + i0 + j] = part[0];
    }
  }
}

}  // namespace wkv
