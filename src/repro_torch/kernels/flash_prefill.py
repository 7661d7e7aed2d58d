"""Blocked causal prefill attention (K8): wrapper, budget tables, launch
counters and plain version.

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

A tensor on the CPU takes the plain version, which repeats the kernel's
tiles in PyTorch; a tensor on the card launches a kernel or raises, and
raises under autograd (the JAX package gives the kernel no VJP).
``flash_prefill.launches`` counts kernel launches of either instance and
nothing else.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.core import factorization, tiling
from repro_torch.kernels import _build

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


class PrefillBlocks(NamedTuple):
    """K8's tiling: rows of a q tile (a thread block, two threads a row) x
    rows of a kv tile (staged in shared memory, one tile at a time)."""
    q_block: int
    k_block: int


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


def blocks_per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes of dynamic shared memory an SM holds."""
    return factorization.H100_SMEM_PER_SM // (
        smem + factorization.H100_SMEM_RESERVED_PER_BLOCK)


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
            if kb <= need and blocks_per_sm(working_set_bytes(
                    TC_Q_BLOCK, kb, dh, dtype)) >= TC_MIN_BLOCKS_PER_SM:
                return PrefillBlocks(TC_Q_BLOCK, kb)
        return None
    qb = min(MAX_Q_BLOCK, factorization.round_up(max(seq_len, 1), 16))
    for kb in tiling.halving(MAX_K_BLOCK):
        if kb >= 2 and working_set_bytes(qb, kb, dh) <= block_budget(qb):
            return PrefillBlocks(qb, kb)
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
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    scale = dh ** -0.5 if scale is None else scale
    q5 = q.to(F32).reshape(B, S, Hkv, g, dh)
    k32, v32 = k.to(F32), v.to(F32)
    pos = torch.arange(S, device=q.device)
    outs = []
    for q0 in range(0, S, q_block):
        qi = q5[:, q0:q0 + q_block]
        qp = pos[q0:q0 + q_block]
        n = qi.shape[1]
        m = torch.full((B, Hkv, g, n), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, g, n, dh, dtype=F32, device=q.device)
        for kt in live_tiles(q0, q_block, k_block, S, window):
            win = slice(kt * k_block, (kt + 1) * k_block)
            kp = pos[win]
            mask = qp[:, None] >= kp[None, :]
            if window:
                mask &= (qp[:, None] - kp[None, :]) < window
            s = torch.einsum("bqhgd,bkhd->bhgqk", qi, k32[:, win]) * scale
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            pv = p.to(torch.bfloat16).to(F32) if round_p else p
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", pv, v32[:, win])
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, n, Hkv, g, dh)
    return torch.cat(outs, dim=1).reshape(B, S, Hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------
def _entry(kind: str):
    """The C entry point of an instance: q, k, v, o, then B, S, Hq, Hkv,
    dh, (the SIMT instance's q_block,) k_block, window, the scale, the
    shared-memory bytes and the stream."""
    lib = _build.load("flash_prefill")
    fn = getattr(lib, "flash_prefill_" + ("tc" if kind == "tc" else "f32"))
    if fn.argtypes is None:
        ints = 7 if kind == "tc" else 8
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * ints
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
    width is left on the SIMT instance.  A call that autograd would record
    raises there.  The CPU runs ``flash_prefill_plain``."""
    _validate(q, k, v)
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    scale = dh ** -0.5 if scale is None else float(scale)
    chosen = choose_blocks(S, dh, q.dtype) \
        or PrefillBlocks(MAX_Q_BLOCK, MAX_K_BLOCK)
    qb = chosen.q_block if q_block is None else q_block
    kb = chosen.k_block if k_block is None else k_block
    if q.device.type == "cpu":
        return flash_prefill_plain(q, k, v, window=window, scale=scale,
                                   q_block=qb, k_block=kb)
    if q.device.type != "cuda":
        raise ValueError(f"flash_prefill runs on cpu or cuda, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError("flash_prefill has no backward: the kernel K8 "
                           "serves prefill only (the JAX package gives it "
                           "no VJP)")
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise TypeError(f"flash_prefill on the card takes q, k and v in one "
                        f"dtype; got {q.dtype}, {k.dtype}, {v.dtype}")
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
    lib, fn = _entry(kind)
    tiles = (kb,) if kind == "tc" else (qb, kb)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
             Hq, Hkv, dh, *tiles, int(window), scale, smem,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_prefill", err)
    flash_prefill.launches += 1
    if kind == "tc":
        flash_prefill.tc_launches += 1
    return out


#: kernel launches of either instance since the last reset, and those of
#: the tensor-core instance (CPU calls are not counted)
flash_prefill.launches = 0
flash_prefill.tc_launches = 0
