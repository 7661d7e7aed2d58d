"""Single-token decode attention (K9): wrapper, budget table, launch counter
and plain version.

Replaces the JAX package's Pallas kernel ``kernels/decode_attn.py:
_kernel`` (launched by ``decode_attn``'s ``pallas_call``) with the CUDA C++
kernel in ``csrc/decode_attn.cu``.  The function is the Pallas kernel's:
one new token's query q (B, Hq, dk) attends over a (B, S, Hkv, dk) cache,
query head h reading kv head ``h // (Hq // Hkv)``, row b over its first
``lengths[b]`` positions; scores ``(k . q) * scale`` in f32, an online
softmax over blocks of ``block_s`` positions (m, l and acc in f32), the
output ``acc / l`` in q's dtype.  A row of length 0 gives 0, as the Pallas
kernel's does (``ref.decode_attn``, the naive oracle, gives NaN there).

The Pallas grid reads a kv head's cache once for each of its query heads;
the port's thread block owns one (batch row, kv head) and its whole group,
and reads the cache once.  The lengths stay on the device (a decode step
passes ``pos + 1`` as a tensor): no step waits on the host.  What bounds it
on the card is written at the top of the CUDA source.

A tensor on the CPU takes the plain version, which repeats the kernel's
blocks in PyTorch; a tensor on the card launches the kernel or raises, and
raises under autograd (decode is never differentiated).
``decode_attn.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.core import factorization, tiling
from repro_torch.kernels import _build

F32 = torch.float32
NEG_INF = -1e30
#: threads of a block and the (head, dim) accumulators each keeps
#: (csrc/decode_attn.cu kThreads, kMaxPairs): group * dk may not exceed
#: their product
THREADS = 128
MAX_PAIRS = 16
#: floats of padding after each staged cache row (kPad)
PAD = 4
#: positions of a cache block the table starts from (the JAX entry's
#: default is 128; the grid here is only B x Hkv blocks, so a block's share
#: of an SM is no constraint and a smaller block keeps the working set
#: small)
BLOCK_S = 64
_IO_DTYPES = (torch.float32, torch.bfloat16)


def working_set_bytes(group: int, block_s: int, dk: int) -> int:
    """Dynamic shared memory of one thread block, exactly as the kernel
    launches it: the k and v blocks (block_s, dk) with rows padded by
    ``PAD`` floats, the group's queries (group, dk), their scores (group,
    block_s) and each head's m, l and rescale factor, all f32 whatever the
    IO dtype."""
    ws = tiling.WorkingSet()
    ws.add("k_v", 2 * block_s * (dk + PAD) * 4)
    ws.add("q", group * dk * 4)
    ws.add("scores", group * block_s * 4)
    ws.add("stats", 3 * group * 4)
    return ws.total()


def choose_block(seq_len: int, group: int, dk: int, *,
                 target: int = BLOCK_S) -> int | None:
    """The cache block ``block_s``: halving from ``target`` (clamped to the
    cache length) until the working set fits a thread block's shared
    memory; None when the kernel cannot take the heads (dk not a multiple
    of 4, or more than ``THREADS * MAX_PAIRS`` (head, dim) pairs)."""
    if dk % 4 or group * dk > THREADS * MAX_PAIRS:
        return None
    for bs in tiling.halving(max(1, min(target, seq_len))):
        if working_set_bytes(group, bs, dk) <= \
                factorization.H100_SMEM_PER_BLOCK:
            return bs
    return None


# ---------------------------------------------------------------------------
# The plain version: the CPU path of the wrapper and the kernel's yardstick
# ---------------------------------------------------------------------------
def decode_attn_plain(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, lengths: torch.Tensor, *,
                      scale: float | None = None,
                      block_s: int = BLOCK_S) -> torch.Tensor:
    """K9's function in PyTorch, block by block as the kernel runs it: the
    online softmax over blocks of ``block_s`` positions in f32, positions
    at or past each row's length masked (a block wholly past it changes
    nothing), the output ``acc / l``, 0 where l is 0 (a row of length 0).
    GQA by grouping the query heads of each kv head."""
    B, S, Hkv, dk = k_cache.shape
    Hq = q.shape[1]
    g = Hq // Hkv
    scale = dk ** -0.5 if scale is None else scale
    q4 = q.to(F32).reshape(B, Hkv, g, dk)
    length = lengths.to(q.device).reshape(B, 1, 1, 1)
    pos = torch.arange(S, device=q.device)
    m = torch.full((B, Hkv, g), NEG_INF, dtype=F32, device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, g, dk, dtype=F32, device=q.device)
    for s0 in range(0, S, block_s):
        win = slice(s0, s0 + block_s)
        valid = pos[win] < length                         # (B, 1, 1, n)
        s = torch.einsum("bkgd,bskd->bkgs", q4, k_cache[:, win].to(F32))
        s = torch.where(valid, s * scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgs,bskd->bkgd", p, v_cache[:, win].to(F32))
        m = m_new
    out = torch.where(l[..., None] > 0, acc / torch.where(
        l > 0, l, 1.0)[..., None], 0.0)
    return out.reshape(B, Hq, dk).to(q.dtype)


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------
def _entry(dtype: torch.dtype):
    """The C entry point of ``dtype``'s instance: q, the two caches, the
    lengths, o, then B, S, Hq, Hkv, dk, block_s, the scale, the
    shared-memory bytes and the stream."""
    lib = _build.load("decode_attn")
    fn = getattr(lib, "decode_attn_" + (
        "f32" if dtype == torch.float32 else "bf16"))
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                       + [ctypes.c_float, ctypes.c_longlong,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, lengths: torch.Tensor, *,
                scale: float | None = None, block_s: int | None = None
                ) -> torch.Tensor:
    """One new token's GQA attention over a cache — ONE kernel launch (K9).

    q: (B, Hq, dk); k_cache, v_cache: (B, S, Hkv, dk); lengths: (B,) int32
    on q's device, the valid positions of each row.  Returns (B, Hq, dk) in
    q's dtype.  ``block_s`` defaults to ``choose_block``.  On the card q
    and the caches share one dtype, float32 or bfloat16, and a call that
    autograd would record raises.  The CPU runs ``decode_attn_plain``."""
    B, Hq, dk = q.shape
    if k_cache.dim() != 4 or v_cache.shape != k_cache.shape \
            or k_cache.shape[0] != B or k_cache.shape[3] != dk \
            or Hq % k_cache.shape[2] != 0 or lengths.shape != (B,):
        raise ValueError(f"decode_attn takes q (B, Hq, dk), caches (B, S, "
                         f"Hkv, dk) with Hkv dividing Hq and lengths (B,); "
                         f"got q {tuple(q.shape)}, k {tuple(k_cache.shape)},"
                         f" v {tuple(v_cache.shape)}, lengths "
                         f"{tuple(lengths.shape)}")
    if any(t.device != q.device for t in (k_cache, v_cache, lengths)):
        raise ValueError("decode_attn: q, the caches and lengths must share "
                         "a device")
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    g = Hq // Hkv
    scale = dk ** -0.5 if scale is None else float(scale)
    bs = block_s if block_s is not None else (
        choose_block(S, g, dk) or min(BLOCK_S, S))
    if q.device.type == "cpu":
        return decode_attn_plain(q, k_cache, v_cache, lengths, scale=scale,
                                 block_s=bs)
    if q.device.type != "cuda":
        raise ValueError(f"decode_attn runs on cpu or cuda, not {q.device}")
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in (q, k_cache, v_cache)):
        raise RuntimeError("decode_attn has no backward: the kernel K9 "
                           "serves decode only")
    if q.dtype not in _IO_DTYPES or k_cache.dtype != q.dtype \
            or v_cache.dtype != q.dtype or lengths.dtype != torch.int32:
        raise TypeError(f"decode_attn on the card takes q and the caches in "
                        f"one dtype, float32 or bfloat16, and int32 lengths;"
                        f" got {q.dtype}, {k_cache.dtype}, {v_cache.dtype}, "
                        f"{lengths.dtype}")
    smem = working_set_bytes(g, bs, dk)
    if choose_block(S, g, dk) is None or bs < 1 \
            or smem > factorization.H100_SMEM_PER_BLOCK:
        raise ValueError(f"decode_attn: no launch for {g} heads of {dk} a "
                         f"kv head at block_s {bs} (dk a multiple of 4, "
                         f"group x dk at most {THREADS * MAX_PAIRS}, "
                         f"{smem} bytes of shared memory)")
    q, k_cache, v_cache = (_build.aligned(t) for t in (q, k_cache, v_cache))
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    lib, fn = _entry(q.dtype)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(), B, S, Hq, Hkv, dk, bs,
             scale, smem, torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "decode_attn", err)
    decode_attn.launches += 1
    return out


#: kernel launches since the last reset (CPU calls are not counted)
decode_attn.launches = 0
