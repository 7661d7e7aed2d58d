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

The launch is split over cache positions (flash-decoding) in one kernel:
splits x Hkv x B blocks, each owning a span of positions of one (batch row,
kv head) and its whole group of query heads (so the cache is read once),
each writing its partial (m, l, acc) to a workspace; the last block of a
(row, kv head) to arrive merges the partials in split order.  The split
comes from ``choose_blocks``, from the cache capacity S alone: the lengths
stay on the device (a decode step passes ``pos + 1`` as a tensor) and no
step waits on the host.  The arrival counters live in a buffer zeroed once
per device and size (``_counters``) and reset by the kernel, so a CUDA
graph can capture the launch.  What bounds it on the card is written at
the top of the CUDA source.

A tensor on the CPU takes the plain version, which repeats the kernel's
order (each split's online softmax over its blocks, then the merge in
split order) in PyTorch; a tensor on the card launches the kernel or
raises, and raises under autograd (decode is never differentiated).
``decode_attn.launches`` counts kernel launches and nothing else.
"""
from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from repro_torch.core import factorization, tiling
from repro_torch.kernels import _build, called, meta_like

F32 = torch.float32
NEG_INF = -1e30
#: threads of a block and the f32 accumulators each keeps
#: (csrc/decode_attn.cu kThreads, kAccFloats): group * dk may not exceed
#: their product
THREADS = 256
ACC_FLOATS = 8
#: positions of a cache block the table starts from, and the fewest it
#: halves to while looking for more splits
BLOCK_S = 64
MIN_BLOCK_S = 16
#: f32 floats of one head's partial row in the workspace beside acc (dk):
#: m, l and two of padding (16-byte rows)
ROW_PAD = 4
#: the kernel's static shared memory (the last-block flag), beside the
#: dynamic bytes ``working_set_bytes`` prices
STATIC_SMEM = 16
_IO_DTYPES = (torch.float32, torch.bfloat16)


class DecodeBlocks(NamedTuple):
    """One launch of K9: cache blocks of ``block_s`` positions, ``splits``
    spans of ``span`` positions (a multiple of block_s) covering the cache,
    ``smem`` bytes of dynamic shared memory a block, ``grid`` blocks."""
    block_s: int
    splits: int
    span: int
    smem: int
    grid: int


def _io_bytes(dtype: torch.dtype) -> int:
    return 2 if dtype == torch.bfloat16 else 4


def working_set_bytes(group: int, block_s: int, dk: int,
                      dtype: torch.dtype = F32) -> int:
    """Dynamic shared memory of one thread block, exactly as the kernel
    launches it: two stages of the k and v blocks (block_s, dk) in the IO
    dtype, the group's queries (group, dk), their scores (group, block_s)
    and each head's m, l and rescale factor, these in f32."""
    ws = tiling.WorkingSet()
    ws.add("k_v", 2 * 2 * block_s * dk * _io_bytes(dtype))
    ws.add("q", group * dk * 4)
    ws.add("scores", group * block_s * 4)
    ws.add("stats", 3 * group * 4)
    return ws.total()


def split_span(seq_len: int, block_s: int, splits: int) -> tuple[int, int]:
    """(splits, span): ``splits`` spans of whole blocks of ``block_s``
    positions as even as they come, each ``span`` positions, none wholly
    past the cache (so the count can come out lower than asked)."""
    blocks = -(-seq_len // block_s)
    span = -(-blocks // max(1, min(splits, blocks))) * block_s
    return -(-seq_len // span), span


def workspace_floats(batch: int, n_kv: int, group: int, dk: int,
                     splits: int) -> int:
    """f32 workspace of one launch: each split's row a head, acc (dk), m,
    l and padding, for every (row, kv head)."""
    return batch * n_kv * splits * group * (dk + ROW_PAD)


@functools.lru_cache(maxsize=None)
def choose_blocks(seq_len: int, batch: int, n_kv: int, group: int, dk: int,
                  dtype: torch.dtype = F32, *, block_s: int | None = None
                  ) -> DecodeBlocks | None:
    """K9's budget table: the cache block and the split, from the cache
    capacity, B, Hkv and the head shape alone.

    Splits aim at one block for each of the H100's SMs: ``ceil(132 / (B x
    Hkv))`` (a block's time is mostly fixed latencies, and the last
    block's merge grows with the splits).  ``block_s`` (unless pinned)
    starts at ``BLOCK_S`` clamped to the cache and halves, down to
    ``MIN_BLOCK_S``, while the cache holds fewer blocks than that, then
    until the working set fits a thread block's shared memory.  None when
    the kernel cannot take the heads (dk not a whole number of 16-byte
    chunks of ``dtype``, or more than ``THREADS * ACC_FLOATS`` (head, dim)
    pairs) or a pinned block does not fit."""
    io = _io_bytes(dtype)
    if seq_len < 1 or batch < 1 or n_kv < 1 or dk < 1 or (dk * io) % 16 \
            or group * dk > THREADS * ACC_FLOATS:
        return None
    target = -(-factorization.H100_SMS // (batch * n_kv))
    budget = factorization.H100_SMEM_PER_BLOCK - STATIC_SMEM
    bs = block_s
    if bs is None:
        bs = min(BLOCK_S, seq_len)
        while bs > MIN_BLOCK_S and -(-seq_len // bs) < target:
            bs = max(MIN_BLOCK_S, bs // 2)
        while bs > 1 and working_set_bytes(group, bs, dk, dtype) > budget:
            bs //= 2
    smem = working_set_bytes(group, bs, dk, dtype)
    if bs < 1 or smem > budget:
        return None
    splits, span = split_span(seq_len, bs, target)
    return DecodeBlocks(bs, splits, span, smem, splits * n_kv * batch)


# ---------------------------------------------------------------------------
# The plain version: the CPU path of the wrapper and the kernel's yardstick
# ---------------------------------------------------------------------------
def decode_attn_plain(q: torch.Tensor, k_cache: torch.Tensor,
                      v_cache: torch.Tensor, lengths: torch.Tensor, *,
                      scale: float | None = None, block_s: int = BLOCK_S,
                      splits: int = 1, with_lse: bool = False):
    """K9's function in PyTorch, in the kernel's order: the cache cut into
    ``split_span(S, block_s, splits)`` spans, each span's online softmax
    over its blocks of ``block_s`` positions in f32 (positions at or past
    each row's length masked; a block wholly past it changes nothing), then
    the spans merged: each head's largest m, and l and acc weighted by
    ``exp(m - max)`` summed in split order; the output ``acc / l``, 0
    where l is 0 (a row of length 0).  GQA by grouping the query heads of
    each kv head.  ``with_lse``: also each head's log-sum-exp ``max +
    log l`` (B, Hq) in f32, ``NEG_INF`` where l is 0."""
    B, S, Hkv, dk = k_cache.shape
    Hq = q.shape[1]
    g = Hq // Hkv
    scale = dk ** -0.5 if scale is None else scale
    n_split, span = split_span(S, block_s, splits)
    dev = q.device
    q4 = q.to(F32).reshape(B, Hkv, g, dk)
    length = lengths.to(dev).reshape(B, 1, 1, 1, 1)
    # position of (split, offset in the span)
    pos = (torch.arange(n_split, device=dev)[:, None] * span
           + torch.arange(span, device=dev)[None, :])
    keys, vals = (torch.cat([t.to(F32), t.new_zeros(
        B, n_split * span - S, Hkv, dk, dtype=F32)], 1)[:, pos]
        for t in (k_cache, v_cache))         # (B, n_split, span, Hkv, dk)
    m = torch.full((B, Hkv, g, n_split), NEG_INF, dtype=F32, device=dev)
    l = torch.zeros_like(m)
    acc = torch.zeros(B, Hkv, g, n_split, dk, dtype=F32, device=dev)
    for s0 in range(0, span, block_s):
        win = slice(s0, s0 + block_s)
        valid = (pos[:, win] < S) & (pos[:, win] < length)  # (B,1,1,n,bs)
        s = torch.einsum("bkgd,bnjkd->bkgnj", q4, keys[:, :, win])
        s = torch.where(valid, s * scale, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        p = torch.where(valid, torch.exp(s - m_new[..., None]), 0.0)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgnj,bnjkd->bkgnd", p, vals[:, :, win])
        m = m_new
    wgt = torch.exp(m - m.amax(-1, keepdim=True))
    big_l = torch.zeros(B, Hkv, g, dtype=F32, device=dev)
    out = torch.zeros(B, Hkv, g, dk, dtype=F32, device=dev)
    for i in range(n_split):
        big_l = big_l + l[..., i] * wgt[..., i]
        out = out + acc[..., i, :] * wgt[..., i, None]
    out = torch.where(big_l[..., None] > 0, out / torch.where(
        big_l > 0, big_l, 1.0)[..., None], 0.0)
    out = out.reshape(B, Hq, dk).to(q.dtype)
    if not with_lse:
        return out
    lse = torch.where(big_l > 0, m.amax(-1) + torch.log(torch.where(
        big_l > 0, big_l, 1.0)), NEG_INF)
    return out, lse.reshape(B, Hq)


# ---------------------------------------------------------------------------
# The launch
# ---------------------------------------------------------------------------
_COUNTERS: dict[tuple[int, int], torch.Tensor] = {}


def _counters(device: torch.device, n: int) -> torch.Tensor:
    """The arrival counters of ``n`` (row, kv head) pairs on ``device``:
    zeroed once per device and size and kept, because each launch leaves
    them at 0 again (so a CUDA graph may capture a launch that uses
    them)."""
    key = (device.index if device.index is not None
           else torch.cuda.current_device(), n)
    buf = _COUNTERS.get(key)
    if buf is None:
        buf = _COUNTERS[key] = torch.zeros(n, dtype=torch.int32,
                                           device=device)
    return buf


def _entry(dtype: torch.dtype):
    """The C entry point of ``dtype``'s instance: q, the two caches, the
    lengths, o, the log-sum-exp (or null), the workspace, the counters,
    then B, S, Hq, Hkv, dk,
    block_s, splits, span, the scale, the shared-memory bytes and the
    stream."""
    lib = _build.load("decode_attn")
    fn = getattr(lib, "decode_attn_" + (
        "f32" if dtype == torch.float32 else "bf16"))
    if fn.argtypes is None:
        fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8
                       + [ctypes.c_float, ctypes.c_longlong,
                          ctypes.c_void_p])
        fn.restype = ctypes.c_int
    return lib, fn


def decode_attn(q: torch.Tensor, k_cache: torch.Tensor,
                v_cache: torch.Tensor, lengths: torch.Tensor, *,
                scale: float | None = None, block_s: int | None = None,
                with_lse: bool = False):
    """One new token's GQA attention over a cache — ONE kernel launch (K9).

    q: (B, Hq, dk); k_cache, v_cache: (B, S, Hkv, dk); lengths: (B,) int32
    on q's device, the valid positions of each row.  Returns (B, Hq, dk) in
    q's dtype; with ``with_lse`` also each head's log-sum-exp of its
    scaled scores, (B, Hq) f32 (``NEG_INF`` for a row of length 0), by
    which the outputs over slices of one cache combine (a cache whose
    positions are split over ranks).  ``block_s`` (pinned, or from ``choose_blocks``) and the
    table's split set the order of the sums.  On the card q and the caches
    share one dtype, float32 or bfloat16, and a call that autograd would
    record raises.  The CPU runs ``decode_attn_plain`` at the table's
    blocks."""
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
    blocks = choose_blocks(S, B, Hkv, g, dk, q.dtype, block_s=block_s)
    bs = blocks.block_s if blocks else block_s or min(BLOCK_S, S)
    # the JAX kernel's grid: (B, Hq, ceil(S / block_s))
    called("decode_attn", B * Hq * -(-S // bs))
    if q.device.type == "meta":
        out = meta_like((q.shape, q.dtype), ((B, Hq), F32))
        return tuple(out) if with_lse else out[0]
    if q.device.type == "cpu":
        return decode_attn_plain(q, k_cache, v_cache, lengths, scale=scale,
                                 block_s=bs,
                                 splits=blocks.splits if blocks else 1,
                                 with_lse=with_lse)
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
    if blocks is None:
        raise ValueError(f"decode_attn: no launch for {g} heads of {dk} a "
                         f"kv head at block_s {block_s} (dk a whole number "
                         f"of 16-byte chunks, group x dk at most "
                         f"{THREADS * ACC_FLOATS}, the working set within a "
                         "block's shared memory)")
    q, k_cache, v_cache = (_build.aligned(t) for t in (q, k_cache, v_cache))
    lengths = lengths.contiguous()
    out = torch.empty_like(q)
    lse = torch.empty(B, Hq, dtype=F32, device=q.device) if with_lse \
        else None
    ws = torch.empty(workspace_floats(B, Hkv, g, dk, blocks.splits),
                     dtype=F32, device=q.device)
    counters = _counters(q.device, B * Hkv)
    lib, fn = _entry(q.dtype)
    err = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
             lengths.data_ptr(), out.data_ptr(),
             lse.data_ptr() if with_lse else None, ws.data_ptr(),
             counters.data_ptr(), B, S, Hq, Hkv, dk, blocks.block_s,
             blocks.splits, blocks.span, scale, blocks.smem,
             torch.cuda.current_stream(q.device).cuda_stream)
    _build.check(lib, "decode_attn", err)
    decode_attn.launches += 1
    return (out, lse) if with_lse else out


#: kernel launches since the last reset (CPU calls are not counted)
decode_attn.launches = 0
