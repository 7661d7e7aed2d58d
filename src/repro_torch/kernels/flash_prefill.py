"""Blocked causal prefill attention (K8), its training forward (K8t) and
its backward (K8b): wrappers, budget tables, launch counters, plain
versions and the autograd Function that pairs K8t with K8b.

Replaces the JAX package's Pallas kernel ``kernels/flash_prefill.py:
_kernel`` (launched by ``flash_prefill``'s ``pallas_call``) with the CUDA
C++ kernels in ``csrc/flash_prefill.cu``.  The function is the Pallas
kernel's: causal attention of q (B, S, Hq, dh) over k, v (B, S, Hkv, dh),
query head h reading kv head ``h // (Hq // Hkv)`` (GQA), optionally
restricted to the last ``window`` positions; scores ``(q . k) * scale`` in
f32 masked to -1e30, an online softmax over kv tiles (m, l and acc in f32,
p masked to 0 after the exp), the output ``acc / max(l, 1e-30)`` in q's
dtype.  kv tiles wholly in a q tile's future or wholly before its window
are skipped: they would change nothing.

The TPU runs the kv tiles as the innermost, sequential grid axis with m, l
and acc in VMEM scratch; on the H100 a thread block owns one (batch row,
query head, q tile) and loops over its live kv tiles itself, from the
window's first tile to the causal limit.  Two instances, chosen by
``route`` from the dtype and head width, never by catching a failure:

* ``"tc"``, bf16 at every head width of ``HEAD_DIMS``: the tensor-core
  kernel.  A block is one consumer warpgroup and one producer warp over a
  64-row q tile; TMA brings k and v through a ring of ``TC_STAGES``
  shared-memory stages in bf16, both products run as ``wgmma`` with f32
  sums, and p is rounded to bf16 before the PV product (the plain
  version's ``round_p``).  Blocks are launched heaviest first
  (``tile_order``).  ``flash_prefill.tc_launches`` counts its launches.
* ``"simt"``, f32: the first version, f32 multiply-adds on the CUDA cores
  (f32 on the tensor cores would be TF32, outside the f32 gates).

What bounds each on the card and what its design does about that is
written at the top of the CUDA source.

Tiling: ``PrefillBlocks(q_block, k_block)``.  ``working_set_bytes``
prices the dynamic shared memory a launch asks for, per instance (the C
side refuses any other figure).  ``choose_blocks`` keeps the f32 instance
within the share of an SM that leaves ``MIN_WARPS_PER_SM`` warps resident,
and gives the bf16 instance the coarsest kv tile of ``TC_K_BLOCKS`` that
leaves ``TC_MIN_BLOCKS_PER_SM`` blocks on an SM.  The tiles change the
order of the online softmax's sums, not its function: results agree
across tiles to rounding (2e-4 in f32, the JAX package's block-invariance
tolerance).

Training (``_FlashPrefillFn``, which ``flash_prefill`` runs when autograd
would record the call).  Neither kernel has a TPU counterpart: the JAX
package trains through its jnp ``flash_attention``, which XLA
differentiates, and gives K8 no VJP.
* K8t (``flash_prefill_traj``, ``csrc/flash_prefill.cu`` with its kLse
  flag): K8 at the same tiles, bit for bit, that also writes each query
  row's log-sum-exp ``lse = m + log(max(l, 1e-30))``, f32 (B, Hq, S).
* K8b (``flash_prefill_bwd``, ``csrc/flash_prefill_bwd.cu``): dq, dk and
  dv from dO, q, k, v, o and lse, in the IO dtype, summed in f32: D =
  rowsum(dO o), p recomputed tile by tile as exp(scale q.k - lse) under
  K8's mask (fully masked tiles skipped), dv = p^T dO, ds = p (dO v^T -
  D), dq = scale ds k, dk = scale ds^T q, dk and dv summed over each GQA
  group.  One call, no atomics: a dQ kernel over q tiles (which writes
  D), a dK/dV kernel over key tiles of each QUERY head (the group split
  over blocks) and, for GQA, a reduction that sums each kv head's f32
  partials in head order.  ``route`` picks its instance as it picks K8's:
  bf16 on the tensor cores (wgmma on TMA-fed tiles, p and ds rounded to
  bf16 before the products that take them: the plain version's
  ``round_p``; ``flash_prefill_bwd.tc_launches`` counts these calls), f32
  on the SIMT kernels.  Its tiling is ``BwdBlocks``, priced by
  ``bwd_working_set_bytes`` and chosen by ``choose_bwd_blocks``.
With remat each training step runs K8t twice an attention layer (the
forward and its recompute) and K8b once; ``eval_step`` runs K8 alone.

A tensor on the CPU takes the plain version, which repeats the kernel's
tiles in PyTorch (``flash_prefill_plain``, ``flash_prefill_traj_plain``,
``flash_prefill_bwd_plain``; float64 too, for gradient checks); a tensor
on the card launches a kernel or raises.  ``flash_prefill.launches``,
``flash_prefill_traj.launches`` and ``flash_prefill_bwd.launches`` count
kernel launches (K8b's kernels count as one call) and nothing else.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import factorization, tiling
from repro_torch.kernels import _build, called, meta_like

F32 = torch.float32
NEG_INF = -1e30
#: head widths the CUDA source has instances for (csrc/flash_prefill.cu):
#: Qwen2, Yi and Command-R use 64 and 128, StableLM 160; 16 and 32 are the
#: JAX package's test shapes
HEAD_DIMS = (16, 32, 64, 128, 160)
#: rows of a q tile (two threads a row) and of a kv tile, at most
MAX_Q_BLOCK = 64
MAX_K_BLOCK = 64
#: floats of padding after each staged tile row (kPad): rows then start 4
#: banks apart, so the 16-byte loads of a warp spread over the banks
PAD = 4
#: warps the budget keeps resident on an SM
MIN_WARPS_PER_SM = 8
_IO_DTYPES = (torch.float32, torch.bfloat16)

# The tensor-core instance (csrc/flash_prefill.cu, flash_prefill_tc)
#: rows of its q tile: the M of one warpgroup's wgmma
TC_Q_BLOCK = 64
#: its kv tiles, coarsest first, no wider than its q tile: a 128-row kv
#: tile computes the masked half of the diagonal tile for nothing, holds
#: more registers and at dh 128 leaves one block an SM; it was slower at
#: both served shapes on the H100
TC_K_BLOCKS = (64, 32)
#: k/v stages of its TMA ring
TC_STAGES = 2
#: bf16 columns of one 128-byte swizzle row: a tile's rows are cut into
#: column blocks this wide, dh padded up to a multiple of it
SWIZZLE_COLS = 64
#: the 128-byte swizzle's atom (8 rows of 128 bytes) must start 1024-byte
#: aligned; the block reserves this much to align its tiles
SWIZZLE_ALIGN = 1024
#: one mbarrier: the q tile's, and a full and an empty one per stage
MBARRIER_BYTES = 8
#: blocks the bf16 table keeps on an SM, so that one block's softmax
#: overlaps another's products and loads
TC_MIN_BLOCKS_PER_SM = 2

# The backward K8b (csrc/flash_prefill_bwd.cu)
#: rows a block of the SIMT dQ kernel owns (four threads a row: 128 threads)
BWD_DQ_ROWS = 32
#: rows a block of the SIMT dK/dV kernel owns (64 threads); its grid is
#: Hq x B x key tiles, as the dQ kernel's
BWD_DKV_ROWS = 16
#: rows of the SIMT kernels' streamed tile, coarsest first (a multiple of
#: 4, at most 64)
BWD_TILES = (64, 32, 16)
#: bytes of padding after each staged row (kPadBytes)
BWD_PAD_BYTES = 16
#: blocks of either SIMT kernel the table keeps on an SM
BWD_MIN_BLOCKS_PER_SM = 2
#: rows of every tile of the tensor-core instance (one warpgroup's wgmma M)
#: and the streamed tiles of its TMA ring
BWD_TC_ROWS = 64
BWD_TC_STAGES = 2


class PrefillBlocks(NamedTuple):
    """K8's tiling: rows of a q tile (a thread block, two threads a row) x
    rows of a kv tile (staged in shared memory, one tile at a time)."""
    q_block: int
    k_block: int


class BwdBlocks(NamedTuple):
    """K8b's tiling: query rows a dQ block owns, key rows a dK/dV block
    owns, and rows of the tile each streams (kv rows for dQ, q rows for
    dK/dV)."""
    dq_rows: int
    dkv_rows: int
    tile: int


def padded_head_dim(dh: int) -> int:
    """dh as the tensor-core instance holds it in shared memory: whole
    128-byte swizzle rows (16, 32, 64 -> 64; 128; 160 -> 192)."""
    return factorization.round_up(dh, SWIZZLE_COLS)


def route(dtype: torch.dtype, dh: int) -> str:
    """The instance that serves ``dtype`` at head width ``dh`` on the card:
    ``"tc"`` (bf16, tensor cores) or ``"simt"`` (f32).  Raises TypeError
    for another dtype and ValueError for a head width with no instance."""
    if dtype not in _IO_DTYPES:
        raise TypeError(f"flash_prefill on the card takes float32 or "
                        f"bfloat16, not {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_prefill has no instance for head width "
                         f"{dh} (head widths {HEAD_DIMS})")
    return "tc" if dtype == torch.bfloat16 else "simt"


def working_set_bytes(q_block: int, k_block: int, dh: int,
                      dtype: torch.dtype = F32) -> int:
    """Dynamic shared memory of one thread block, exactly as the kernel
    launches it.  f32 (the SIMT instance): the q tile (q_block, dh) and the
    k and v tiles (k_block, dh), each row padded by ``PAD`` floats, all
    f32.  bf16 (the tensor-core instance): the slack that aligns the tiles
    to ``SWIZZLE_ALIGN``, the q tile (q_block, padded dh) and ``TC_STAGES``
    k and v tiles (k_block, padded dh) in bf16, and the barriers."""
    ws = tiling.WorkingSet()
    if dtype == torch.bfloat16:
        dhp = padded_head_dim(dh)
        ws.add("align", SWIZZLE_ALIGN)
        ws.add("q", q_block * dhp * 2)
        ws.add("k_v", TC_STAGES * 2 * k_block * dhp * 2)
        ws.add("barriers", (1 + 2 * TC_STAGES) * MBARRIER_BYTES)
        return ws.total()
    ws.add("q", q_block * (dh + PAD) * 4)
    ws.add("k_v", 2 * k_block * (dh + PAD) * 4)
    return ws.total()


def block_budget(q_block: int) -> int:
    """Shared memory one block of ``2 * q_block`` threads may take so that
    ``MIN_WARPS_PER_SM`` warps fit on an SM: the SM's shared memory over
    the blocks needed, less the runtime's reserve of each."""
    blocks = max(1, MIN_WARPS_PER_SM * factorization.WARP // (2 * q_block))
    return min(factorization.H100_SMEM_PER_BLOCK,
               factorization.H100_SMEM_PER_SM // blocks
               - factorization.H100_SMEM_RESERVED_PER_BLOCK)


def choose_blocks(seq_len: int, dh: int, dtype: torch.dtype = F32
                  ) -> PrefillBlocks | None:
    """Pick ``(q_block, k_block)`` for a prefill of ``seq_len`` positions
    at head width ``dh`` in ``dtype``, or None when the kernel has no
    instance for ``dh`` or no kv tile fits.

    bf16 (the tensor-core instance): the q tile is ``TC_Q_BLOCK`` rows;
    the kv tile is the coarsest of ``TC_K_BLOCKS`` that is no longer than
    the sequence needs (S rounded up to a power of two, 32 at least) and
    leaves ``TC_MIN_BLOCKS_PER_SM`` blocks on an SM.  Otherwise (f32):
    the q tile is ``MAX_Q_BLOCK`` rows (fewer, in whole warps of 16 rows,
    for a shorter sequence); the kv tile halves from ``MAX_K_BLOCK`` until
    the working set fits ``block_budget``."""
    if dh not in HEAD_DIMS:
        return None
    if dtype == torch.bfloat16:
        need = max(TC_K_BLOCKS[-1], 1 << max(seq_len - 1, 0).bit_length())
        for kb in TC_K_BLOCKS:
            if kb <= need and factorization.blocks_per_sm(
                    working_set_bytes(TC_Q_BLOCK, kb, dh, dtype)) \
                    >= TC_MIN_BLOCKS_PER_SM:
                return PrefillBlocks(TC_Q_BLOCK, kb)
        return None
    qb = min(MAX_Q_BLOCK, factorization.round_up(max(seq_len, 1), 16))
    for kb in tiling.halving(MAX_K_BLOCK):
        if kb >= 2 and working_set_bytes(qb, kb, dh) <= block_budget(qb):
            return PrefillBlocks(qb, kb)
    return None


def bwd_working_set_bytes(rows: int, tile: int, dh: int,
                          dtype: torch.dtype = F32, dq: bool = True) -> int:
    """Dynamic shared memory of one block of K8b's dQ kernel (``dq``) or
    its dK/dV kernel, exactly as the C side launches it.

    f32 (the SIMT kernels): the owned rows of two tensors (q and dO, or k
    and v) and a streamed tile of two (k and v, or q and dO), each row dh
    floats plus ``BWD_PAD_BYTES``; for dK/dV also the streamed rows' lse
    and D.  bf16 (the tensor-core kernels): the slack that aligns the
    tiles to ``SWIZZLE_ALIGN``; the owned tiles of two tensors (q and dO,
    or k and v), (rows, padded dh) bf16 each; ``BWD_TC_STAGES`` stages of
    two streamed tiles
    (tile, padded dh) and, for dK/dV, their rows' lse and D (f32); the
    barriers (the owned tiles', a full and an empty one per stage)."""
    ws = tiling.WorkingSet()
    if dtype == torch.bfloat16:
        dhp = padded_head_dim(dh)
        ws.add("align", SWIZZLE_ALIGN)
        ws.add("owned", 2 * rows * dhp * 2)
        ws.add("streamed", BWD_TC_STAGES * 2 * tile * dhp * 2)
        if not dq:
            ws.add("lse_d", BWD_TC_STAGES * 2 * 4 * tile)
        ws.add("barriers", (1 + 2 * BWD_TC_STAGES) * MBARRIER_BYTES)
        return ws.total()
    ws.add("owned", 2 * rows * (dh * 4 + BWD_PAD_BYTES))
    ws.add("streamed", 2 * tile * (dh * 4 + BWD_PAD_BYTES))
    if not dq:
        ws.add("lse_d", 2 * 4 * tile)
    return ws.total()


def choose_bwd_blocks(seq_len: int, dh: int, dtype: torch.dtype = F32
                      ) -> BwdBlocks | None:
    """K8b's tiling for a sequence of ``seq_len`` at head width ``dh`` in
    ``dtype``, or None when the kernel has no instance for ``dh`` or
    ``dtype`` or no tile fits.  bf16 (the tensor-core instance): owned and
    streamed tiles of ``BWD_TC_ROWS``, whatever the sequence.  f32 (the SIMT instance):
    ``BWD_DQ_ROWS`` and ``BWD_DKV_ROWS`` owned rows, and the coarsest
    streamed tile of ``BWD_TILES`` that is no longer than the sequence
    needs (S rounded up to a multiple of 16) and leaves
    ``BWD_MIN_BLOCKS_PER_SM`` blocks of both kernels on an SM."""
    if dh not in HEAD_DIMS or dtype not in _IO_DTYPES:
        return None
    if dtype == torch.bfloat16:
        bl = BwdBlocks(BWD_TC_ROWS, BWD_TC_ROWS, BWD_TC_ROWS)
        fits = all(bwd_working_set_bytes(rows, bl.tile, dh, dtype, dq)
                   <= factorization.H100_SMEM_PER_BLOCK
                   for rows, dq in ((bl.dq_rows, True), (bl.dkv_rows, False)))
        return bl if fits else None
    need = factorization.round_up(max(seq_len, 1), 16)
    for tile in BWD_TILES:
        if tile > need and tile != BWD_TILES[-1]:
            continue
        sizes = (bwd_working_set_bytes(BWD_DQ_ROWS, tile, dh, dtype, True),
                 bwd_working_set_bytes(BWD_DKV_ROWS, tile, dh, dtype, False))
        if all(b <= factorization.H100_SMEM_PER_BLOCK
               and factorization.blocks_per_sm(b) >= BWD_MIN_BLOCKS_PER_SM
               for b in sizes):
            return BwdBlocks(BWD_DQ_ROWS, BWD_DKV_ROWS, tile)
    return None


def live_tiles(q0: int, q_block: int, k_block: int, seq_len: int,
               window: int) -> range:
    """The kv tiles a q tile starting at ``q0`` reads: from the window's
    first tile (0 without a window) to the last tile that starts at or
    before the q tile's last row, and within the sequence."""
    first = 0
    if window > 0 and q0 - window + 1 > 0:
        first = (q0 - window + 1) // k_block
    last = min((seq_len - 1) // k_block, (q0 + q_block - 1) // k_block)
    return range(first, last + 1)


def live_q_tiles(k0: int, k_rows: int, q_tile: int, seq_len: int,
                 window: int) -> range:
    """The q tiles a block of K8b's dK/dV kernel owning keys [k0, k0 +
    k_rows) reads: from the tile holding query k0 (no earlier query sees
    these keys) to the last query a key of the block reaches (the
    sequence's end, or ``k0 + k_rows - 2 + window``)."""
    last = (seq_len - 1) // q_tile
    if window > 0:
        last = min(last, (k0 + k_rows - 2 + window) // q_tile)
    return range(k0 // q_tile, last + 1)


def tile_order(batch: int, heads: int, seq_len: int
               ) -> list[tuple[int, int, int]]:
    """``(batch row, query head, q tile)`` of each block of a tensor-core
    launch, in block-index order, as the kernel decodes ``blockIdx.x``:
    heaviest first, the q tiles from the last (which reads the most kv
    tiles) to the first, the (row, head) pairs innermost so that the query
    heads of one kv head run side by side."""
    n_q = -(-seq_len // TC_Q_BLOCK)
    rows = batch * heads
    return [((i % rows) // heads, (i % rows) % heads, n_q - 1 - i // rows)
            for i in range(n_q * rows)]


# ---------------------------------------------------------------------------
# The plain version: the CPU path of the wrapper and the kernel's yardstick
# ---------------------------------------------------------------------------
def _compute_dtype(t: torch.Tensor) -> torch.dtype:
    """f32, or float64 for float64 inputs (the gradient checks)."""
    return torch.float64 if t.dtype == torch.float64 else F32


def _mask(qp: torch.Tensor, kp: torch.Tensor, window: int) -> torch.Tensor:
    """K8's mask of (query, key) positions: causal, within the window."""
    mask = qp[:, None] >= kp[None, :]
    if window:
        mask &= (qp[:, None] - kp[None, :]) < window
    return mask


def _forward_plain(q, k, v, window, scale, q_block, k_block, round_p
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """The online softmax of K8, tile by tile: (o in q's dtype, lse f32 or
    float64, (B, Hq, S))."""
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    ct = _compute_dtype(q)
    scale = dh ** -0.5 if scale is None else scale
    q5 = q.to(ct).reshape(B, S, Hkv, g, dh)
    k32, v32 = k.to(ct), v.to(ct)
    pos = torch.arange(S, device=q.device)
    outs, lses = [], []
    for q0 in range(0, S, q_block):
        qi = q5[:, q0:q0 + q_block]
        qp = pos[q0:q0 + q_block]
        n = qi.shape[1]
        m = torch.full((B, Hkv, g, n), NEG_INF, dtype=ct, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, g, n, dh, dtype=ct, device=q.device)
        for kt in live_tiles(q0, q_block, k_block, S, window):
            win = slice(kt * k_block, (kt + 1) * k_block)
            mask = _mask(qp, pos[win], window)
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, k32[:, win]) * scale
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            pv = p.to(torch.bfloat16).to(ct) if round_p else p
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", pv, v32[:, win])
            m = m_new
        lc = torch.clamp_min(l, 1e-30)
        out = acc / lc[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, n, Hkv, g, dh)
        lses.append(m + torch.log(lc))                    # (B, Hkv, g, n)
    o = torch.cat(outs, dim=1).reshape(B, S, Hq, dh).to(q.dtype)
    return o, torch.cat(lses, dim=-1).reshape(B, Hq, S)


def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, scale: float | None = None,
                        q_block: int = MAX_Q_BLOCK,
                        k_block: int = MAX_K_BLOCK,
                        round_p: bool = False) -> torch.Tensor:
    """K8's function in PyTorch, tile by tile as the kernel runs it: for
    each q tile, the online softmax over its live kv tiles in f32, scores
    ``(q . k) * scale`` masked to -1e30, p masked to 0, the output over
    ``max(l, 1e-30)`` in q's dtype.  Batched over rows and heads; GQA by
    grouping the query heads of each kv head.  ``round_p`` rounds p to
    bf16 before the PV product, as the tensor-core instance does (the row
    sums keep p in f32); the JAX kernel keeps p in f32 (the default)."""
    return _forward_plain(q, k, v, window, scale, q_block, k_block,
                          round_p)[0]


def flash_prefill_traj_plain(q: torch.Tensor, k: torch.Tensor,
                             v: torch.Tensor, *, window: int = 0,
                             scale: float | None = None,
                             q_block: int = MAX_Q_BLOCK,
                             k_block: int = MAX_K_BLOCK,
                             round_p: bool = False
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """K8t's function: ``flash_prefill_plain``'s output (the same code,
    bit for bit) and each query row's ``lse = m + log(max(l, 1e-30))``,
    (B, Hq, S) f32."""
    return _forward_plain(q, k, v, window, scale, q_block, k_block, round_p)


def head_order_sum(parts: torch.Tensor) -> torch.Tensor:
    """The sum over dim 2 (the query heads of each kv head) of ``parts``,
    taken in head order 0 ... g - 1, as K8b's reduction takes it."""
    total = parts[:, :, 0]
    for i in range(1, parts.shape[2]):
        total = total + parts[:, :, i]
    return total


def flash_prefill_bwd_plain(q: torch.Tensor, k: torch.Tensor,
                            v: torch.Tensor, o: torch.Tensor,
                            lse: torch.Tensor, dout: torch.Tensor, *,
                            window: int = 0, scale: float | None = None,
                            blocks: BwdBlocks | None = None,
                            round_p: bool = False
                            ) -> tuple[torch.Tensor, torch.Tensor,
                                       torch.Tensor]:
    """K8b's function in PyTorch, step by step as the kernel runs it, in
    f32 (float64 for float64 inputs): D = rowsum(dO o); then, for each q
    tile of ``dq_rows`` over its live kv tiles, p = exp(scale q.k - lse)
    under K8's mask, ds = p (dO v^T - D) and dq += ds k; for each kv tile
    of ``dkv_rows`` over the live q tiles (``live_q_tiles``), dv += p^T dO
    and dk += ds^T q, summed over the GQA group; dq and dk times the
    scale.  Returns (dq, dk, dv) in the inputs' dtype.

    ``round_p`` rounds as the tensor-core instance does: p to bf16 before
    p^T dO, ds (computed in f32 from the unrounded p) to bf16 before ds k
    and ds^T q, and dk and dv summed per query head, the heads' partials
    then added in head order (``head_order_sum``).  Without it (the SIMT
    instance's f32 sums, the default) p and ds stay unrounded and only the
    outputs are rounded."""
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    ct = _compute_dtype(q)
    scale = dh ** -0.5 if scale is None else scale
    bl = blocks or choose_bwd_blocks(S, dh, q.dtype) \
        or BwdBlocks(BWD_DQ_ROWS, BWD_DKV_ROWS, BWD_TILES[0])
    q5 = q.to(ct).reshape(B, S, Hkv, g, dh)
    do5 = dout.to(ct).reshape(B, S, Hkv, g, dh)
    k32, v32 = k.to(ct), v.to(ct)
    lse4 = lse.to(ct).reshape(B, Hkv, g, S)
    d4 = (do5 * o.to(ct).reshape(B, S, Hkv, g, dh)).sum(-1) \
        .permute(0, 2, 3, 1)                             # (B, Hkv, g, S)
    pos = torch.arange(S, device=q.device)

    def rounded(x):
        return x.to(torch.bfloat16).to(ct) if round_p else x

    def probs(q0, n, k0, m):
        """p and ds of queries [q0, q0 + n) against keys [k0, k0 + m):
        (B, Hkv, g, n, m) each."""
        qs, ks = slice(q0, q0 + n), slice(k0, k0 + m)
        s = torch.einsum("bqhgd,bkhd->bhgqk", q5[:, qs], k32[:, ks])
        mask = _mask(pos[qs], pos[ks], window)
        p = torch.where(mask, torch.exp(s * scale - lse4[..., qs, None]),
                        0.0)
        dp = torch.einsum("bqhgd,bkhd->bhgqk", do5[:, qs], v32[:, ks])
        return p, p * (dp - d4[..., qs, None])

    dq = torch.empty(B, S, Hkv, g, dh, dtype=ct, device=q.device)
    for q0 in range(0, S, bl.dq_rows):
        n = min(bl.dq_rows, S - q0)
        acc = torch.zeros(B, Hkv, g, n, dh, dtype=ct, device=q.device)
        for kt in live_tiles(q0, bl.dq_rows, bl.tile, S, window):
            k0 = kt * bl.tile
            _, ds = probs(q0, n, k0, min(bl.tile, S - k0))
            acc += torch.einsum("bhgqk,bkhd->bhgqd", rounded(ds),
                                k32[:, k0:k0 + bl.tile])
        dq[:, q0:q0 + n] = (acc * scale).permute(0, 3, 1, 2, 4)
    # per query head with round_p (partials, then head_order_sum), else
    # summed over the group inside the products
    heads = "bhgkd" if round_p else "bhkd"
    dk = torch.empty(B, S, Hkv, dh, dtype=ct, device=q.device)
    dv = torch.empty_like(dk)
    for k0 in range(0, S, bl.dkv_rows):
        m = min(bl.dkv_rows, S - k0)
        shape = (B, Hkv, g, m, dh) if round_p else (B, Hkv, m, dh)
        acc_k = torch.zeros(shape, dtype=ct, device=q.device)
        acc_v = torch.zeros_like(acc_k)
        for qt in live_q_tiles(k0, bl.dkv_rows, bl.tile, S, window):
            q0 = qt * bl.tile
            n = min(bl.tile, S - q0)
            p, ds = probs(q0, n, k0, m)
            qs = slice(q0, q0 + n)
            acc_v += torch.einsum(f"bhgqk,bqhgd->{heads}", rounded(p),
                                  do5[:, qs])
            acc_k += torch.einsum(f"bhgqk,bqhgd->{heads}", rounded(ds),
                                  q5[:, qs])
        if round_p:
            acc_k, acc_v = head_order_sum(acc_k), head_order_sum(acc_v)
        dk[:, k0:k0 + m] = (acc_k * scale).transpose(1, 2)
        dv[:, k0:k0 + m] = acc_v.transpose(1, 2)
    return (dq.reshape(B, S, Hq, dh).to(q.dtype), dk.to(k.dtype),
            dv.to(v.dtype))


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------
def _entry(kind: str, lse: bool = False):
    """The C entry point of an instance (K8t's with ``lse``): q, k, v, o,
    (lse,) then B, S, Hq, Hkv, dh, (the SIMT instance's q_block,)
    k_block, window, the scale, the shared-memory bytes and the stream."""
    lib = _build.load("flash_prefill")
    fn = getattr(lib, "flash_prefill_" + ("tc" if kind == "tc" else "f32")
                 + ("_traj" if lse else ""))
    if fn.argtypes is None:
        ints = 7 if kind == "tc" else 8
        fn.argtypes = ([ctypes.c_void_p] * (5 if lse else 4)
                       + [ctypes.c_int] * ints
                       + [ctypes.c_float, ctypes.c_longlong,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def _validate(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape \
            or k.shape[:2] != q.shape[:2] or k.shape[3] != q.shape[3] \
            or q.shape[2] % k.shape[2] != 0:
        raise ValueError(f"flash_prefill takes q (B, S, Hq, dh) and k, v "
                         f"(B, S, Hkv, dh) with Hkv dividing Hq; got q "
                         f"{tuple(q.shape)}, k {tuple(k.shape)}, v "
                         f"{tuple(v.shape)}")
    if k.device != q.device or v.device != q.device:
        raise ValueError("flash_prefill: q, k and v must share a device")


def _tiles(q: torch.Tensor, q_block: int | None, k_block: int | None
           ) -> tuple[int, int]:
    """The tiles of a forward call: the caller's, else ``choose_blocks``."""
    chosen = choose_blocks(q.shape[1], q.shape[3], q.dtype) \
        or PrefillBlocks(MAX_Q_BLOCK, MAX_K_BLOCK)
    return (chosen.q_block if q_block is None else q_block,
            chosen.k_block if k_block is None else k_block)


def grid_steps(q: torch.Tensor, q_block: int, k_block: int) -> int:
    """The JAX kernel's grid of a call at these tiles: (B, Hq,
    ceil(S / q_block), ceil(S / k_block)) steps.  K8t's call counts as
    K8's; K8b (no JAX counterpart) counts the forward's grid at the default
    tiles."""
    B, S, Hq, _ = q.shape
    return B * Hq * -(-S // q_block) * -(-S // k_block)


def _card_checks(name: str, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor) -> None:
    """Raise unless the call can launch a kernel on the card."""
    if q.device.type != "cuda":
        raise ValueError(f"{name} runs on cpu or cuda, not {q.device}")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"{name} on the card takes q, k and v in one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")


def _launch_fwd(q, k, v, window, scale, qb, kb, with_lse):
    """One K8 launch (K8t with ``with_lse``): (o, lse or None)."""
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    kind = route(q.dtype, dh)
    smem = working_set_bytes(qb, kb, dh, q.dtype)
    if kind == "tc":
        if qb != TC_Q_BLOCK or kb not in TC_K_BLOCKS:
            raise ValueError(f"flash_prefill: no bf16 instance for dh {dh} "
                             f"at q_block {qb}, k_block {kb} (q_block "
                             f"{TC_Q_BLOCK}, k_block one of {TC_K_BLOCKS})")
    elif not 16 <= qb <= MAX_Q_BLOCK or qb % 16 or not 2 <= kb <= MAX_K_BLOCK \
            or kb % 2 or smem > factorization.H100_SMEM_PER_BLOCK:
        raise ValueError(f"flash_prefill: no f32 instance for dh {dh} at "
                         f"q_block {qb}, k_block {kb} (q_block a multiple "
                         f"of 16 up to {MAX_Q_BLOCK}, k_block even up to "
                         f"{MAX_K_BLOCK})")
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    out = torch.empty_like(q)
    lse = (torch.empty(B, Hq, S, dtype=F32, device=q.device) if with_lse
           else None)
    lib, fn = _entry(kind, with_lse)
    tiles = (kb,) if kind == "tc" else (qb, kb)
    ptrs = (q, k, v, out) + ((lse,) if with_lse else ())
    err = fn(*(t.data_ptr() for t in ptrs), B, S, Hq, Hkv, dh, *tiles,
             int(window), scale, smem,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_prefill", err)
    return out, lse


def flash_prefill(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  window: int = 0, scale: float | None = None,
                  q_block: int | None = None, k_block: int | None = None
                  ) -> torch.Tensor:
    """Causal (optionally windowed) GQA attention over a whole prefill —
    ONE kernel launch (K8).

    q: (B, S, Hq, dh); k, v: (B, S, Hkv, dh).  Returns (B, S, Hq, dh) in
    q's dtype.  Any S; ``q_block``/``k_block`` default to
    ``choose_blocks`` for q's dtype.  On the card q, k and v share one
    dtype and dh is one of ``HEAD_DIMS``: bfloat16 runs the tensor-core
    instance (q_block ``TC_Q_BLOCK``, k_block one of ``TC_K_BLOCKS``),
    float32 the SIMT instance (q_block a multiple of 16 up to
    ``MAX_Q_BLOCK``, k_block even up to ``MAX_K_BLOCK``); no bf16 head
    width is left on the SIMT instance.  The CPU runs
    ``flash_prefill_plain``.

    Differentiable: when autograd would record the call, it runs
    ``_FlashPrefillFn`` — K8t forward and K8b backward (on the CPU their
    plain versions)."""
    _validate(q, k, v)
    qb, kb = _tiles(q, q_block, k_block)
    scale = q.shape[3] ** -0.5 if scale is None else float(scale)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashPrefillFn.apply(q, k, v, int(window), scale, qb, kb)
    called("flash_prefill", grid_steps(q, qb, kb))
    if q.device.type == "meta":
        return meta_like((q.shape, q.dtype))[0]
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, window=window, scale=scale,
                                   q_block=qb, k_block=kb)
    _card_checks("flash_prefill", q, k, v)
    out, _ = _launch_fwd(q, k, v, window, scale, qb, kb, with_lse=False)
    flash_prefill.launches += 1
    if route(q.dtype, q.shape[3]) == "tc":
        flash_prefill.tc_launches += 1
    return out


def flash_prefill_traj(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                       *, window: int = 0, scale: float | None = None,
                       q_block: int | None = None,
                       k_block: int | None = None
                       ) -> tuple[torch.Tensor, torch.Tensor]:
    """The training forward — ONE kernel launch (K8t): ``flash_prefill``'s
    output (bit for bit at the same tiles, on the same instance) and each
    query row's log-sum-exp, (B, Hq, S) f32.  The CPU runs
    ``flash_prefill_traj_plain``."""
    _validate(q, k, v)
    qb, kb = _tiles(q, q_block, k_block)
    scale = q.shape[3] ** -0.5 if scale is None else float(scale)
    called("flash_prefill_traj", grid_steps(q, qb, kb))
    if q.device.type == "meta":
        B, S, Hq, _ = q.shape
        return meta_like((q.shape, q.dtype), ((B, Hq, S), F32))
    if q.device.type == "cpu":
        return flash_prefill_traj_plain(q, k, v, window=window, scale=scale,
                                        q_block=qb, k_block=kb)
    _card_checks("flash_prefill_traj", q, k, v)
    out, lse = _launch_fwd(q, k, v, window, scale, qb, kb, with_lse=True)
    flash_prefill_traj.launches += 1
    return out, lse


def _bwd_entry(kind: str):
    """K8b's C entry point of an instance: q, k, v, o, dout, lse, D, dq,
    dk, dv, the partials' scratch (or None), then B, S, Hq, Hkv, dh, (the
    SIMT instance's dq_rows, dkv_rows, tile,) window, the scale, both
    kernels' shared-memory bytes and the stream."""
    lib = _build.load("flash_prefill_bwd")
    fn = getattr(lib, "flash_prefill_bwd_" + ("tc" if kind == "tc"
                                              else "f32"))
    if fn.argtypes is None:
        ints = 6 if kind == "tc" else 9
        fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * ints
                       + [ctypes.c_float, ctypes.c_longlong,
                          ctypes.c_longlong, ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def flash_prefill_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                      o: torch.Tensor, lse: torch.Tensor,
                      dout: torch.Tensor, *, window: int = 0,
                      scale: float | None = None
                      ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The attention backward — ONE call of K8b's kernels (dQ, dK/dV and,
    when Hq > Hkv, the reduction): (dq, dk, dv) in the inputs' dtype from
    the forward's q, k, v, its output o and K8t's lse (B, Hq, S) f32, and
    the output's gradient ``dout``, at the tiles of ``choose_bwd_blocks``.
    On the card q, k, v, o and dout share one dtype and dh is one of
    ``HEAD_DIMS``: bfloat16 runs the tensor-core instance, float32 the
    SIMT one (``route``); anything else raises.  The wrapper allocates D
    and, for GQA, the f32 partials of dk and dv.  The CPU runs
    ``flash_prefill_bwd_plain``."""
    _validate(q, k, v)
    if o.shape != q.shape or dout.shape != q.shape \
            or lse.shape != (q.shape[0], q.shape[2], q.shape[1]):
        raise ValueError(f"flash_prefill_bwd takes o and dout shaped as q "
                         f"{tuple(q.shape)} and lse (B, Hq, S); got o "
                         f"{tuple(o.shape)}, dout {tuple(dout.shape)}, lse "
                         f"{tuple(lse.shape)}")
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    scale = dh ** -0.5 if scale is None else float(scale)
    called("flash_prefill_bwd", grid_steps(q, *_tiles(q, None, None)))
    if q.device.type == "meta":
        return meta_like((q.shape, q.dtype), (k.shape, k.dtype),
                         (v.shape, v.dtype))
    if q.device.type == "cpu":
        return flash_prefill_bwd_plain(q, k, v, o, lse, dout, window=window,
                                       scale=scale)
    _card_checks("flash_prefill_bwd", q, k, v)
    if o.dtype != q.dtype or dout.dtype != q.dtype or lse.dtype != F32:
        raise TypeError(f"flash_prefill_bwd on the card takes o and dout in "
                        f"q's dtype and lse in float32; got {o.dtype}, "
                        f"{dout.dtype}, {lse.dtype}")
    kind = route(q.dtype, dh)                # raises without an instance
    bl = choose_bwd_blocks(S, dh, q.dtype)
    if bl is None:
        raise ValueError(f"flash_prefill_bwd: no tile of {BWD_TILES} fits "
                         f"dh {dh} in {q.dtype}")
    smem = (bwd_working_set_bytes(bl.dq_rows, bl.tile, dh, q.dtype, True),
            bwd_working_set_bytes(bl.dkv_rows, bl.tile, dh, q.dtype, False))
    ins = [_build.aligned(t) for t in (q, k, v, o, dout, lse)]
    d = torch.empty(B, Hq, S, dtype=F32, device=q.device)
    part = (torch.empty(2, B, S, Hq, dh, dtype=F32, device=q.device)
            if Hq > Hkv else None)
    dq, dk, dv = (torch.empty_like(ins[0]), torch.empty_like(ins[1]),
                  torch.empty_like(ins[2]))
    lib, fn = _bwd_entry(kind)
    tiles = () if kind == "tc" else tuple(bl)
    err = fn(*(t.data_ptr() for t in (*ins, d, dq, dk, dv)),
             None if part is None else part.data_ptr(), B, S, Hq, Hkv, dh,
             *tiles, int(window), scale, *smem,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_prefill_bwd", err)
    flash_prefill_bwd.launches += 1
    if kind == "tc":
        flash_prefill_bwd.tc_launches += 1
    return dq, dk, dv


class _FlashPrefillFn(torch.autograd.Function):
    """Attention under autograd: the forward is K8t, keeping q, k, v, its
    output and the rows' lse, the backward is K8b.  The module's wrappers
    are looked up at call time, so a wrapper installed in their place (a
    counting or checking one) is the one that runs."""

    @staticmethod
    def forward(ctx, q, k, v, window, scale, q_block, k_block):
        o, lse = flash_prefill_traj(q, k, v, window=window, scale=scale,
                                    q_block=q_block, k_block=k_block)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.window, ctx.scale = window, scale
        return o

    @staticmethod
    def backward(ctx, dout):
        q, k, v, o, lse = ctx.saved_tensors
        dq, dk, dv = flash_prefill_bwd(q, k, v, o, lse,
                                       dout.to(q.dtype).contiguous(),
                                       window=ctx.window, scale=ctx.scale)
        return dq, dk, dv, None, None, None, None


#: kernel launches of either instance since the last reset, and those of
#: the tensor-core instance; K8t's launches; K8b's calls (two or three
#: kernels each), and those on the tensor cores (CPU calls are not counted)
flash_prefill.launches = 0
flash_prefill.tc_launches = 0
flash_prefill_traj.launches = 0
flash_prefill_bwd.launches = 0
flash_prefill_bwd.tc_launches = 0
