"""Blocked causal prefill attention (K8): wrapper, budget table, launch
counter and plain version.

Replaces the JAX package's Pallas kernel ``kernels/flash_prefill.py:
_kernel`` (launched by ``flash_prefill``'s ``pallas_call``) with the CUDA
C++ kernel in ``csrc/flash_prefill.cu``.  The function is the Pallas
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
window's first tile to the causal limit.  What bounds it on the card and
what the design does about that is written at the top of the CUDA source.

Tiling: ``PrefillBlocks(q_block, k_block)``.  ``working_set_bytes`` prices
the dynamic shared memory a launch asks for (the C side refuses any other
figure); ``choose_blocks`` keeps it within the share of an SM that leaves
``MIN_WARPS_PER_SM`` warps resident, so that the SMs have warps to switch
between while a block waits on its tile loads.  The tiles change the order of the
online softmax's sums, not its function: results agree across tiles to
rounding (2e-4, the JAX package's block-invariance tolerance).

A tensor on the CPU takes the plain version, which repeats the kernel's
tiles in PyTorch; a tensor on the card launches the kernel or raises, and
raises under autograd (the JAX package gives the kernel no VJP).
``flash_prefill.launches`` counts kernel launches and nothing else.
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


class PrefillBlocks(NamedTuple):
    """K8's tiling: rows of a q tile (a thread block, two threads a row) x
    rows of a kv tile (staged in shared memory, one tile at a time)."""
    q_block: int
    k_block: int


def working_set_bytes(q_block: int, k_block: int, dh: int) -> int:
    """Dynamic shared memory of one thread block, exactly as the kernel
    launches it: the q tile (q_block, dh) and the k and v tiles (k_block,
    dh), each row padded by ``PAD`` floats, all f32 whatever the IO
    dtype."""
    ws = tiling.WorkingSet()
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


def choose_blocks(seq_len: int, dh: int) -> PrefillBlocks | None:
    """Pick ``(q_block, k_block)`` for a prefill of ``seq_len`` positions
    at head width ``dh``, or None when the kernel has no instance for
    ``dh`` or no even kv tile fits.  The q tile is ``MAX_Q_BLOCK`` rows
    (fewer, in whole warps of 16 rows, for a shorter sequence); the kv
    tile halves from ``MAX_K_BLOCK`` until the working set fits
    ``block_budget``."""
    if dh not in HEAD_DIMS:
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


# ---------------------------------------------------------------------------
# The plain version: the CPU path of the wrapper and the kernel's yardstick
# ---------------------------------------------------------------------------
def flash_prefill_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        *, window: int = 0, scale: float | None = None,
                        q_block: int = MAX_Q_BLOCK,
                        k_block: int = MAX_K_BLOCK) -> torch.Tensor:
    """K8's function in PyTorch, tile by tile as the kernel runs it: for
    each q tile, the online softmax over its live kv tiles in f32, scores
    ``(q . k) * scale`` masked to -1e30, p masked to 0, the output over
    ``max(l, 1e-30)`` in q's dtype.  Batched over rows and heads; GQA by
    grouping the query heads of each kv head."""
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
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, v32[:, win])
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, n, Hkv, g, dh)
    return torch.cat(outs, dim=1).reshape(B, S, Hq, dh).to(q.dtype)


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------
def _entry(dtype: torch.dtype):
    """The C entry point of ``dtype``'s instances: q, k, v, o, then B, S,
    Hq, Hkv, dh, q_block, k_block, window, the scale, the shared-memory
    bytes and the stream."""
    lib = _build.load("flash_prefill")
    fn = getattr(lib, "flash_prefill_" + (
        "f32" if dtype == torch.float32 else "bf16"))
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 8
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
    ``choose_blocks``.  On the card q, k and v share one dtype, float32 or
    bfloat16, dh is one of ``HEAD_DIMS``, q_block a multiple of 16 up to
    ``MAX_Q_BLOCK`` and k_block even up to ``MAX_K_BLOCK``; a call that
    autograd would record raises there.  The CPU runs
    ``flash_prefill_plain``."""
    _validate(q, k, v)
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    scale = dh ** -0.5 if scale is None else float(scale)
    chosen = choose_blocks(S, dh) or PrefillBlocks(MAX_Q_BLOCK, MAX_K_BLOCK)
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
    if q.dtype not in _IO_DTYPES or k.dtype != q.dtype \
            or v.dtype != q.dtype:
        raise TypeError(f"flash_prefill on the card takes q, k and v in one "
                        f"dtype, float32 or bfloat16; got {q.dtype}, "
                        f"{k.dtype}, {v.dtype}")
    smem = working_set_bytes(qb, kb, dh)
    if dh not in HEAD_DIMS or not 16 <= qb <= MAX_Q_BLOCK or qb % 16 \
            or not 2 <= kb <= MAX_K_BLOCK or kb % 2 \
            or smem > factorization.H100_SMEM_PER_BLOCK:
        raise ValueError(f"flash_prefill: no instance for dh {dh} at "
                         f"q_block {qb}, k_block {kb} (head widths "
                         f"{HEAD_DIMS}; q_block a multiple of 16 up to "
                         f"{MAX_Q_BLOCK}, k_block even up to {MAX_K_BLOCK})")
    q, k, v = _build.aligned(q), _build.aligned(k), _build.aligned(v)
    out = torch.empty_like(q)
    lib, fn = _entry(q.dtype)
    err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, S,
             Hq, Hkv, dh, qb, kb, int(window), scale, smem,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "flash_prefill", err)
    flash_prefill.launches += 1
    return out


#: kernel launches since the last reset (CPU calls are not counted)
flash_prefill.launches = 0
