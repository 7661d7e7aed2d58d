"""GQA attention: blocked causal prefill and cached single-token decode (the
port's twin of the JAX package's ``models/attention.py``).

The full-sequence path runs the prefill plan named by the module-level
``PREFILL_PLAN``: ``flash_prefill``, the hand-written CUDA kernel K8
(kernels/flash_prefill.py), so that every prefill on the card runs the
kernel; ``blocked``, ``flash_attention`` below (the plain twin of the JAX
model's two-level blockwise scan), takes its place for comparisons.  Decode
of a full, unquantized cache runs the plan named by ``DECODE_PLAN``:
``decode_attn``, the CUDA kernel K9 (kernels/decode_attn.py), or
``einsum``, the plain twin of the JAX model's grouped contractions.  As in
the JAX package, ring (sliding-window) and int8 caches always take the
torch-op decode.  The JAX models never reach their Pallas kernels: their
attention is the jnp ``flash_attention``.

Two cache layouts, as in the JAX package:
  * full — (B, S_max, Hkv, dh), position ``pos`` written in place
  * ring — sliding-window (B, W, Hkv, dh), slot ``pos % W`` overwritten;
           slot j holds absolute position pos - ((pos - j) mod W)
and, with ``cfg.kv_quant``, int8 values plus per-(token, kv-head) f32
scales.  The port writes the cache in place (the JAX package returns new
arrays and donates the old ones to its jits): a prefill writes the
positions it covers, a prefill chunk (``chunk_prefill_attention``, the
slot engine's chunked admission) its positions' slots, a decode step its
slot, indexed by the device ``pos`` tensor, so no step waits on the host
and a decode step can be captured in a CUDA graph (serving/tick.py).
Under autograd the ``flash_prefill`` plan trains: ``ops.flash_prefill``
runs K8t (K8 that also writes each row's log-sum-exp) forward and the
hand-written backward K8b (kernels/flash_prefill.py), where the JAX
package differentiates its jnp ``flash_attention``; the ``blocked`` plan
stays that function's twin, differentiated by autograd, for comparisons.
"""
from __future__ import annotations

import torch

from repro_torch import partitioning as pt
from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common
from repro_torch.partitioning import constrain, dense_init, zeros_init

F32 = torch.float32
NEG_INF = -1e30

#: the full-sequence attention: "flash_prefill" (K8) or "blocked" (the
#: plain ``flash_attention``, what the JAX model computes); comparisons
#: swap it
PREFILL_PLAN = "flash_prefill"
#: the decode of a full, unquantized cache: "decode_attn" (K9) or "einsum"
#: (the plain twin of the JAX model's ``decode_attention``)
DECODE_PLAN = "decode_attn"


def init_attention_annot(gen: torch.Generator, cfg: ModelConfig,
                         dtype: torch.dtype, device="cpu") -> dict:
    """``wq`` (d, Hq, dh), ``wk``/``wv`` (d, Hkv, dh), ``wo`` (Hq, dh, d),
    each drawn at scale d^-1/2, and with ``cfg.qkv_bias`` the zero biases
    ``bq`` (Hq, dh), ``bk``/``bv`` (Hkv, dh): the JAX package's tree and
    logical axes."""
    d, hq, hkv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)

    def w(shape, axes):
        return dense_init(gen, shape, axes, dtype, device, scale=d ** -0.5)

    p = {"wq": w((d, hq, dh), ("embed", "heads", None)),
         "wk": w((d, hkv, dh), ("embed", "kv_heads", None)),
         "wv": w((d, hkv, dh), ("embed", "kv_heads", None)),
         "wo": w((hq, dh, d), ("heads", None, "embed"))}
    if cfg.qkv_bias:
        for name, h, ax in (("bq", hq, "heads"), ("bk", hkv, "kv_heads"),
                            ("bv", hkv, "kv_heads")):
            p[name] = zeros_init((h, dh), (ax, None), dtype, device)
    return p


def _qkv(p: dict, x: torch.Tensor
         ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    q = torch.einsum("...d,dhk->...hk", x, p["wq"])
    k = torch.einsum("...d,dhk->...hk", x, p["wk"])
    v = torch.einsum("...d,dhk->...hk", x, p["wv"])
    if "bq" in p:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    return q, k, v


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    window: int = 0, q_block: int = 512,
                    kv_block: int = 1024) -> torch.Tensor:
    """Causal blockwise attention with grouped GQA, the kv heads never
    expanded (the JAX model's ``flash_attention``: ``q * scale`` before the
    product, every kv block visited, f32 online softmax).  q: (B, S, Hq,
    dh); k, v: (B, S, Hkv, dh).  ``window`` > 0 restricts attention to the
    last ``window`` positions.  S must be a multiple of the blocks, as the
    JAX function asserts."""
    B, S, Hq, dh = q.shape
    Hkv = k.shape[2]
    g = Hq // Hkv
    qb, kb = min(q_block, S), min(kv_block, S)
    if S % qb or S % kb:
        raise ValueError(f"flash_attention: S={S} is not a multiple of the "
                         f"blocks ({qb}, {kb})")
    nq, nk = S // qb, S // kb
    qr = q.reshape(B, nq, qb, Hkv, g, dh).to(F32) * dh ** -0.5
    kr, vr = k.reshape(B, nk, kb, Hkv, dh), v.reshape(B, nk, kb, Hkv, dh)
    pos = torch.arange(S, device=q.device)
    outs = []
    for qi in range(nq):
        q_i, qp = qr[:, qi], pos[qi * qb:(qi + 1) * qb]
        m = torch.full((B, Hkv, g, qb), NEG_INF, dtype=F32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(B, Hkv, g, qb, dh, dtype=F32, device=q.device)
        for kj in range(nk):
            kp = pos[kj * kb:(kj + 1) * kb]
            s = torch.einsum("bqhgd,bkhd->bhgqk", q_i, kr[:, kj].to(F32))
            mask = qp[:, None] >= kp[None, :]
            if window:
                mask &= (qp[:, None] - kp[None, :]) < window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            alpha = torch.exp(m - m_new)
            p = torch.where(mask, torch.exp(s - m_new[..., None]), 0.0)
            l = l * alpha + p.sum(-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p, vr[:, kj].to(F32))
            m = m_new
        out = acc / torch.clamp_min(l, 1e-30)[..., None]
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, qb, Hkv, g, dh)
    return torch.cat(outs, dim=1).reshape(B, S, Hq, dh).to(q.dtype)


def _attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            window: int) -> torch.Tensor:
    """The full-sequence attention of ``PREFILL_PLAN``."""
    if PREFILL_PLAN == "flash_prefill":
        return ops.flash_prefill(q, k, v, window=window)
    if PREFILL_PLAN == "blocked":
        return flash_attention(q, k, v, window=window)
    raise ValueError(f"unknown prefill plan {PREFILL_PLAN!r}")


def apply_attention(p: dict, x: torch.Tensor, cfg: ModelConfig,
                    positions: torch.Tensor, cache: dict | None = None
                    ) -> torch.Tensor:
    """Full-sequence (prefill) attention.  x: (B, S, d); positions (B, S).
    With ``cache`` (one layer's slot), the roped k and the v it computes
    are also written into it in place, as ``prefill_cache`` writes them
    (the JAX package computes them a second time there).  On a mesh of
    more than one device (DTensors) the positions are 0..S-1 and the
    section below runs it."""
    rules = pt.active_rules()
    if rules is not None:
        return _apply_attention_sharded(p, x, cfg, cache, rules)
    q, k, v = _qkv(p, x)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    if cache is not None:
        _write_prefill(cache, k, v, cfg)
    out = _attend(q, k, v, cfg.sliding_window)
    return torch.einsum("bshk,hkd->bsd", out, p["wo"])


def _write_prefill(cache: dict, k: torch.Tensor, v: torch.Tensor,
                   cfg: ModelConfig) -> None:
    """Write a prefill segment's k, v (B, S, Hkv, dh) into the cache slot
    in place: positions [0, S) of a full cache, or for a ring cache (or a
    segment longer than the cache) only the last S_c positions, at their
    ``pos % S_c`` slots."""
    writes = {"k": k, "v": v}
    if cfg.kv_quant:
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    S, s_c = k.shape[1], cache["k"].shape[1]
    for name, val in writes.items():
        tgt = cache[name]
        if S <= s_c and not cfg.sliding_window:
            tgt[:, :S] = val.to(tgt.dtype)
        else:
            keep = min(S, s_c)
            slots = torch.arange(S - keep, S, device=tgt.device) % s_c
            tgt[:, slots] = val[:, S - keep:].to(tgt.dtype)


def prefill_cache(p: dict, x: torch.Tensor, cache: dict, cfg: ModelConfig,
                  positions: torch.Tensor) -> dict:
    """Write the (roped) k and the v of a full prefill segment into the
    cache slot, in place, and return it.  x: (B, S, d); cache arrays
    (B, S_c, Hkv, dh).  For ring caches only the last W positions are
    written, at their ``pos % W`` slots."""
    _, k, v = _qkv(p, x)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    _write_prefill(cache, k, v, cfg)
    return cache


def chunk_prefill_attention(p: dict, x: torch.Tensor, cache: dict,
                            cfg: ModelConfig, positions: torch.Tensor
                            ) -> torch.Tensor:
    """One fixed-shape prefill CHUNK against the decode cache (the JAX
    model's ``chunk_prefill_attention``, computed with torch ops as JAX
    computes it with jnp, outside any kernel).

    x is a (B, L, d) slice of the prompt whose absolute positions are
    ``positions`` (B, L): consecutive, continuing wherever the previous
    chunk stopped.  The chunk's roped k and its v are written into the
    cache slot in place at their position slots (ring slots ``pos % S_c``
    for sliding-window layouts; int8 values and scales with
    ``kv_quant``), and the chunk's queries attend the FULL cache under a
    content-position mask, so chunk k sees every key chunks 0..k-1 wrote
    plus its own causal prefix.  Token identity with whole-prompt prefill
    holds as long as the ring never evicts a position a later query still
    needs (for sliding-window layouts: while the prompt fits the ring);
    the serving engine routes longer windowed prompts through the
    whole-prompt path.  Returns the attention output (B, L, d)."""
    B, L, _ = x.shape
    q, k, v = _qkv(p, x)
    q = common.apply_rope(q, positions, cfg.rope_theta)
    k = common.apply_rope(k, positions, cfg.rope_theta)
    s_c = cache["k"].shape[1]
    w = cfg.sliding_window or 0
    slots = ((positions % s_c) if w else positions).long()   # (B, L)
    b_idx = torch.arange(B, device=x.device)[:, None]
    writes = {"k": k, "v": v}
    if cfg.kv_quant:
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    for name, val in writes.items():
        cache[name][b_idx, slots] = val.to(cache[name].dtype)
    k_cache, v_cache = cache["k"], cache["v"]

    hkv = cfg.n_kv_heads
    group = cfg.n_heads // hkv
    dh = cfg.resolved_head_dim
    q5 = q.reshape(B, L, hkv, group, dh)
    q5 = q5.to(x.dtype if cfg.kv_quant else k_cache.dtype)
    # bf16 products summed in f32, as preferred_element_type=f32 does
    scores = torch.einsum("blkgd,bskd->bkgls", q5.to(F32),
                          k_cache.to(q5.dtype).to(F32)) * dh ** -0.5
    if cfg.kv_quant:
        # per-(token, head) dequant scales fold into the scores, exactly
        # as in decode_attention
        scores = scores * cache["k_scale"].transpose(1, 2)[:, :, None, None]
    scores = constrain(scores, ("batch", None, None, None, "cache_seq"))

    # content-position mask: slot j holds the key of absolute position
    # content_pos[j]; a query at qp may attend it iff 0 <= content_pos <=
    # qp (and within the sliding window).  One formula covers the full
    # layout and the ring, including the intra-chunk causal half.
    idx = torch.arange(s_c, device=x.device)                 # (S_c,)
    p_last = positions[:, -1][:, None]                       # (B, 1)
    written = torch.remainder(p_last - idx[None], s_c) < L   # (B, S_c)
    prev_last = p_last - L                       # end of chunks 0..k-1
    content_pos = torch.where(
        written, p_last - torch.remainder(p_last - idx[None], s_c),
        prev_last - torch.remainder(prev_last - idx[None], s_c))
    qp = positions[:, :, None]                               # (B, L, 1)
    cp = content_pos[:, None, :]                             # (B, 1, S_c)
    valid = (cp >= 0) & (cp <= qp)                           # (B, L, S_c)
    if w:
        valid &= (qp - cp) < w
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)                    # f32
    if cfg.kv_quant:
        probs = probs * cache["v_scale"].transpose(1, 2)[:, :, None, None]
        out = torch.einsum("bkgls,bskd->blkgd", probs.to(x.dtype).to(F32),
                           v_cache.to(x.dtype).to(F32))
    else:
        out = torch.einsum("bkgls,bskd->blkgd",
                           probs.to(v_cache.dtype).to(F32),
                           v_cache.to(F32))
    out = out.reshape(B, L, cfg.n_heads, dh).to(x.dtype)
    return torch.einsum("blhk,hkd->bld", out, p["wo"])


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_cache_slot_annot(cfg: ModelConfig, n_groups: int, batch: int,
                          max_seq: int, dtype: torch.dtype, device="cpu"
                          ) -> dict:
    """Zero KV cache of one attention slot, stacked over groups, with the
    JAX package's logical axes: ``k``, ``v`` (G, B, S_c, Hkv, dh) with S_c
    = min(max_seq, window) for a ring; with ``kv_quant`` int8 values plus
    ``k_scale``/``v_scale`` (G, B, S_c, Hkv) f32."""
    w = cfg.sliding_window or 0
    s_c = min(max_seq, w) if w else max_seq
    shape = (n_groups, batch, s_c, cfg.n_kv_heads, cfg.resolved_head_dim)
    axes = ("layers", "batch", "cache_seq", "kv_heads", None)

    if cfg.kv_quant:
        return {"k": zeros_init(shape, axes, torch.int8, device),
                "v": zeros_init(shape, axes, torch.int8, device),
                "k_scale": zeros_init(shape[:-1], axes[:-1], F32, device),
                "v_scale": zeros_init(shape[:-1], axes[:-1], F32, device)}
    return {"k": zeros_init(shape, axes, dtype, device),
            "v": zeros_init(shape, axes, dtype, device)}


def _quantize(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(..., head) symmetric int8 quantization over the last dim."""
    x32 = x.to(F32)
    scale = torch.clamp_min(x32.abs().amax(-1) / 127.0, 1e-8)
    return torch.round(x32 / scale[..., None]).to(torch.int8), scale


def _dequant(q: torch.Tensor, scale: torch.Tensor, dtype: torch.dtype
             ) -> torch.Tensor:
    return (q.to(F32) * scale[..., None]).to(dtype)


def _decode_einsum(q4: torch.Tensor, cache: dict, valid: torch.Tensor,
                   cfg: ModelConfig, dtype: torch.dtype) -> torch.Tensor:
    """The JAX model's grouped decode contractions: q4 (B, Hkv, g, dh)
    against the whole cache, invalid slots (``valid`` (B, S_c) false)
    masked, int8 scales folded into the scores and the probabilities.
    Its bf16 products are upcast to f32 before each contraction, which is
    what ``preferred_element_type=f32`` computes; the probabilities are
    rounded to the cache dtype (``dtype``, the activations', for int8)
    first, as JAX rounds them.  Returns (B, Hkv, g, dh) f32."""
    k_cache, v_cache = cache["k"], cache["v"]
    q4 = q4.to(dtype if cfg.kv_quant else k_cache.dtype)
    scores = torch.einsum("bkgd,bskd->bkgs", q4.to(F32),
                          k_cache.to(q4.dtype).to(F32))
    scores = scores * cfg.resolved_head_dim ** -0.5
    if cfg.kv_quant:
        scores = scores * cache["k_scale"].transpose(1, 2)[:, :, None]
    scores = constrain(scores, ("batch", None, None, "cache_seq"))
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if cfg.kv_quant:
        probs = probs * cache["v_scale"].transpose(1, 2)[:, :, None]
        return torch.einsum("bkgs,bskd->bkgd", probs.to(dtype).to(F32),
                            v_cache.to(dtype).to(F32))
    return torch.einsum("bkgs,bskd->bkgd", probs.to(v_cache.dtype).to(F32),
                        v_cache.to(F32))


def decode_attention(p: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, cfg: ModelConfig,
                     active: torch.Tensor | None = None) -> torch.Tensor:
    """One-token cached attention.  x: (B, 1, d); cache slot arrays
    (B, S_c, Hkv, dh), written in place at each lane's slot; pos: the
    absolute position of this token, a 0-d tensor (the wave engine's
    lockstep lanes) or one per lane (B,) (the slot engine's), on x's
    device.  With ``active`` (B,) bool, a lane where it is False keeps its
    cache bit for bit: the row at its slot is written back as it was
    (``torch.where`` against the old row, no boolean indexing, so nothing
    waits on the host).  A full, unquantized cache runs ``DECODE_PLAN``,
    with ``lengths = pos + 1`` handed to K9 as a device tensor; ring and
    int8 caches run the grouped contractions.  Returns (B, 1, d).  On a
    mesh of more than one device (DTensors, no ``active``) the section
    below runs it."""
    rules = pt.active_rules()
    if rules is not None:
        if active is not None:
            raise NotImplementedError("decode_attention: a lane mask on a "
                                      "mesh of more than one device")
        return _decode_sharded(p, x, cache, pos, cfg, rules)
    B = x.shape[0]
    pos_b = torch.broadcast_to(torch.as_tensor(pos, device=x.device), (B,))
    q, k, v = _qkv(p, x)                                  # (B, 1, h, dh)
    q = common.apply_rope(q, pos_b[:, None], cfg.rope_theta)
    k = common.apply_rope(k, pos_b[:, None], cfg.rope_theta)
    s_c = cache["k"].shape[1]
    w = cfg.sliding_window or 0
    slot_b = ((pos_b % s_c) if w else pos_b).long()      # per-lane slot
    rows = torch.arange(B, device=x.device)
    writes = {"k": k, "v": v}
    if cfg.kv_quant:
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    for name, val in writes.items():
        new = val[:, 0].to(cache[name].dtype)
        if active is not None:
            keep = active.reshape((B,) + (1,) * (new.dim() - 1))
            new = torch.where(keep, new, cache[name][rows, slot_b])
        cache[name][rows, slot_b] = new

    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim
    if DECODE_PLAN == "decode_attn" and not cfg.kv_quant and not w:
        out = ops.decode_attn(q[:, 0].to(cache["k"].dtype), cache["k"],
                              cache["v"], (pos_b + 1).to(torch.int32))
    elif DECODE_PLAN in ("decode_attn", "einsum"):
        idx = torch.arange(s_c, device=x.device)
        if w:
            # slot j holds absolute position pos - ((pos - j) mod S_c)
            slot_pos = pos_b[:, None] - torch.remainder(
                pos_b[:, None] - idx[None], s_c)
            valid = slot_pos >= 0
        else:
            valid = idx[None] <= pos_b[:, None]
        out = _decode_einsum(q[:, 0].reshape(B, hkv, hq // hkv, dh), cache,
                             valid, cfg, x.dtype)
    else:
        raise ValueError(f"unknown decode plan {DECODE_PLAN!r}")
    out = out.reshape(B, hq, dh).to(x.dtype)
    return torch.einsum("bhk,hkd->bd", out, p["wo"])[:, None]


# ---------------------------------------------------------------------------
# A mesh of more than one device
#
# The kernels have no DTensor sharding rule, so on a mesh over a process
# group each path runs as a ``shard_map`` body on rank-local tensors, laid
# out as the resolved specs say: the batch over ('pod', 'data'), the heads
# over 'model' where they divide it (the weights gathered over 'data' on
# entry: FSDP), the decode cache's sequence over 'model' (``cache_seq``).
# With the heads split, each rank attends its own heads (their kv heads
# beside them) and the output projection's partial sums meet in one psum
# over 'model'.  A prefill writes the cache slice this rank holds; a decode
# step writes its token where its slot lies and, on the ``decode_attn``
# plan, runs K9 on the local tensors: on its own heads where only the
# heads are split, else over its cache slice with the log-sum-exp out, the
# slices' outputs combined by it across 'model' (``_decode_k9_local``).
# The int8 cache and the sliding window, which K9 does not take on one
# device either, combine each rank's softmax over its slice (max, sum and
# weighted values) in torch ops.  Where 'model' splits nothing, the body
# is the single-device code on the batch shard.
# ---------------------------------------------------------------------------
def _layout(rules, p: dict, cache: dict | None):
    """(param specs, cache specs, heads split, kv heads split, cache
    sequence split, cache kv heads split) over 'model': the parameters
    gathered over the batch axes, the cache as placed."""
    p_specs = pt.body_specs(p)
    hs = pt.sharded_over(p_specs["wq"], 1, rules.mesh)
    kvs = pt.sharded_over(p_specs["wk"], 1, rules.mesh)
    c_specs, cs, ckv = None, False, False
    if cache is not None:
        c_specs = {k: pt.spec_of(v) for k, v in cache.items()}
        cs = pt.sharded_over(c_specs["k"], 1, rules.mesh)
        ckv = pt.sharded_over(c_specs["k"], 2, rules.mesh)
    return p_specs, c_specs, hs, kvs, cs, ckv


def _local_kv(k: torch.Tensor, v: torch.Tensor, nq: int, cfg: ModelConfig
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """The kv heads that this rank's ``nq`` query heads attend, from all
    of them (the query heads split over 'model', the kv heads not): a
    contiguous run where the group size and ``nq`` divide one another,
    else one kv head per query head."""
    g = cfg.n_heads // cfg.n_kv_heads
    h0 = pt.axis_index("model") * nq
    lo = h0 // g
    if nq % g == 0 or g % nq == 0:
        n = max(nq // g, 1)
        return k[:, :, lo:lo + n], v[:, :, lo:lo + n]
    idx = (h0 + torch.arange(nq, device=k.device)) // g
    return k[:, :, idx], v[:, :, idx]


def _write_prefill_local(cache: dict, k: torch.Tensor, v: torch.Tensor,
                         cfg: ModelConfig, c_lo: int, s_c: int) -> None:
    """``_write_prefill`` into the slice of a cache of ``s_c`` slots that
    starts at slot ``c_lo``: each local slot takes the position the whole
    cache would hold there after the segment, or keeps its row."""
    writes = {"k": k, "v": v}
    if cfg.kv_quant:
        kq, ks = _quantize(k)
        vq, vs = _quantize(v)
        writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    S, s_loc = k.shape[1], cache["k"].shape[1]
    j = c_lo + torch.arange(s_loc, device=k.device)       # global slots
    if S <= s_c and not cfg.sliding_window:
        src, valid = j, j < S
    else:
        keep = min(S, s_c)
        src = j + s_c * torch.div(S - 1 - j, s_c, rounding_mode="floor")
        valid = src >= S - keep
    src = src.clamp(0, S - 1)
    for name, val in writes.items():
        tgt = cache[name]
        m = valid.reshape((1, -1) + (1,) * (tgt.dim() - 2))
        tgt.copy_(torch.where(m, val[:, src].to(tgt.dtype), tgt))


def _apply_attention_sharded(p: dict, x: torch.Tensor, cfg: ModelConfig,
                             cache: dict | None, rules) -> torch.Tensor:
    """``apply_attention`` on DTensors (the section comment); positions are
    the prefill's 0..S-1."""
    p_specs, c_specs, hs, kvs, cs, ckv = _layout(rules, p, cache)
    x_spec = rules.spec_for(("batch", "seq", None), x.shape)
    m = rules.mesh.shape.get("model", 1)

    def local_fn(x_l, p_l, cache_l):
        B, S = x_l.shape[:2]
        positions = torch.arange(S, device=x_l.device).expand(B, S)
        if not (hs or cs or ckv):
            return apply_attention(p_l, x_l, cfg, positions, cache_l)
        q, k, v = _qkv(p_l, x_l)
        q = common.apply_rope(q, positions, cfg.rope_theta)
        k = common.apply_rope(k, positions, cfg.rope_theta)
        if cache_l is not None:
            kc, vc = k, v
            if kvs and not ckv:
                kc, vc = (pt.all_gather(t, "model", 2) for t in (k, v))
            s_loc = cache_l["k"].shape[1]
            c_lo = pt.axis_index("model") * s_loc if cs else 0
            _write_prefill_local(cache_l, kc, vc, cfg, c_lo,
                                 s_loc * (m if cs else 1))
        ka, va = (k, v) if kvs or not hs else _local_kv(k, v, q.shape[2],
                                                        cfg)
        out = _attend(q, ka, va, cfg.sliding_window)
        out = torch.einsum("bshk,hkd->bsd", out, p_l["wo"])
        return pt.psum(out, "model") if hs else out

    if cache is None:
        fn = pt.shard_map(lambda x_l, p_l: local_fn(x_l, p_l, None),
                          rules.mesh, in_specs=(x_spec, p_specs),
                          out_specs=x_spec)
        return fn(x, p)
    fn = pt.shard_map(local_fn, rules.mesh, in_specs=(x_spec, p_specs,
                                                      c_specs),
                      out_specs=x_spec)
    return fn(x, p, cache)


def _decode_k9_local(q: torch.Tensor, cache: dict, pos_b: torch.Tensor,
                     c_lo: int, cfg: ModelConfig, hs: bool, cs: bool,
                     ckv: bool) -> torch.Tensor:
    """K9 inside ``_decode_sharded``'s body: this rank's query heads'
    attention (B, heads, dh), ``q`` (B, local heads, dh) after the token's
    write.  With the cache's sequence split (``cs``) every rank runs K9
    over all the query heads against its slice of the cache (the lengths
    cut to it) with the log-sum-exp out, and the slices' outputs combine
    by it across 'model' (a pmax, two psums), as one softmax over the
    whole cache; else each rank runs K9 on its own query heads against the
    kv heads they read."""
    nq = q.shape[1]
    kc, vc = cache["k"], cache["v"]
    q = q.to(kc.dtype)
    if cs:
        if hs:
            q = pt.all_gather(q, "model", 1)
        s_loc = kc.shape[1]
        lens = (pos_b + 1 - c_lo).clamp(0, s_loc).to(torch.int32)
        out, lse = ops.decode_attn(q, kc, vc, lens, with_lse=True)
        mx = pt.pmax(lse, "model")
        wgt = torch.exp(lse - mx)
        out = (pt.psum(out.to(F32) * wgt[..., None], "model")
               / pt.psum(wgt, "model")[..., None])
        if hs:
            h0 = pt.axis_index("model") * nq
            out = out[:, h0:h0 + nq]
        return out
    if ckv and not hs:
        raise ValueError("decode_attn: the cache's kv heads are split over "
                         "'model' but the query heads are not")
    if hs and not ckv:
        kc, vc = _local_kv(kc, vc, nq, cfg)
    return ops.decode_attn(q, kc, vc, (pos_b + 1).to(torch.int32))


def _decode_sharded(p: dict, x: torch.Tensor, cache: dict,
                    pos: torch.Tensor, cfg: ModelConfig, rules
                    ) -> torch.Tensor:
    """``decode_attention`` on DTensors (the section comment)."""
    p_specs, c_specs, hs, kvs, cs, ckv = _layout(rules, p, cache)
    x_spec = rules.spec_for(("batch", None, None), x.shape)
    pos_spec = rules.spec_for(("batch",)[:pos.dim()], pos.shape)
    m = rules.mesh.shape.get("model", 1)
    hq, hkv, dh = cfg.n_heads, cfg.n_kv_heads, cfg.resolved_head_dim

    def local_fn(x_l, pos_l, cache_l, p_l):
        if not (hs or cs or ckv):
            return decode_attention(p_l, x_l, cache_l, pos_l, cfg)
        B = x_l.shape[0]
        pos_b = torch.broadcast_to(pos_l, (B,))
        q, k, v = _qkv(p_l, x_l)                             # (B, 1, h, dh)
        q = common.apply_rope(q, pos_b[:, None], cfg.rope_theta)
        k = common.apply_rope(k, pos_b[:, None], cfg.rope_theta)
        if kvs and not ckv:
            k, v = (pt.all_gather(t, "model", 2) for t in (k, v))
        s_loc = cache_l["k"].shape[1]
        c_lo = pt.axis_index("model") * s_loc if cs else 0
        s_c = s_loc * (m if cs else 1)
        w = cfg.sliding_window or 0
        slot = ((pos_b % s_c) if w else pos_b).long() - c_lo
        mine = (slot >= 0) & (slot < s_loc)
        slot = slot.clamp(0, s_loc - 1)
        rows = torch.arange(B, device=x_l.device)
        writes = {"k": k, "v": v}
        if cfg.kv_quant:
            kq, ks = _quantize(k)
            vq, vs = _quantize(v)
            writes = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
        for name, val in writes.items():
            new = val[:, 0].to(cache_l[name].dtype)
            keep = mine.reshape((B,) + (1,) * (new.dim() - 1))
            old = cache_l[name][rows, slot]
            cache_l[name][rows, slot] = torch.where(keep, new, old)
        if DECODE_PLAN == "decode_attn" and not cfg.kv_quant and not w:
            out = _decode_k9_local(q[:, 0], cache_l, pos_b, c_lo, cfg, hs,
                                   cs, ckv)
            out = torch.einsum("bhk,hkd->bd", out.to(x_l.dtype),
                               p_l["wo"])[:, None]
            return pt.psum(out, "model") if hs else out
        # every query head against this rank's slice of the cache
        qa = pt.all_gather(q, "model", 2) if hs else q
        j = c_lo + torch.arange(s_loc, device=x_l.device)
        if w:
            valid = (pos_b[:, None] - torch.remainder(
                pos_b[:, None] - j[None], s_c)) >= 0
        else:
            valid = j[None] <= pos_b[:, None]
        dtype = x_l.dtype if cfg.kv_quant else cache_l["k"].dtype
        q4 = qa[:, 0].reshape(B, hkv, hq // hkv, dh).to(dtype)
        scores = torch.einsum("bkgd,bskd->bkgs", q4.to(F32),
                              cache_l["k"].to(q4.dtype).to(F32)) * dh ** -0.5
        if cfg.kv_quant:
            scores = scores * cache_l["k_scale"].transpose(1, 2)[:, :, None]
        scores = torch.where(valid[:, None, None], scores, NEG_INF)
        mx = scores.amax(-1)
        if cs:
            mx = pt.pmax(mx, "model")
        e = torch.exp(scores - mx[..., None])
        denom = e.sum(-1)
        if cfg.kv_quant:
            e = e * cache_l["v_scale"].transpose(1, 2)[:, :, None]
        acc = torch.einsum("bkgs,bskd->bkgd", e.to(dtype).to(F32),
                           cache_l["v"].to(dtype).to(F32))
        if cs:
            denom, acc = pt.psum(denom, "model"), pt.psum(acc, "model")
        out = (acc / denom[..., None]).reshape(B, hq, dh).to(x_l.dtype)
        if hs:
            nq = hq // m
            h0 = pt.axis_index("model") * nq
            out = out[:, h0:h0 + nq]
        out = torch.einsum("bhk,hkd->bd", out, p_l["wo"])[:, None]
        return pt.psum(out, "model") if hs else out

    fn = pt.shard_map(local_fn, rules.mesh,
                      in_specs=(x_spec, pos_spec, c_specs, p_specs),
                      out_specs=x_spec)
    return fn(x, pos, cache, p)
