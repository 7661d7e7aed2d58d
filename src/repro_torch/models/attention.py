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
positions it covers, a decode step its slot, indexed by the device ``pos``
tensor, so no step waits on the host.  Training through attention is not
ported (``transformer.forward`` raises under autograd for a config with
attention layers): K8 has no backward in the JAX package either.
"""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.kernels import ops
from repro_torch.models import common

F32 = torch.float32
NEG_INF = -1e30

#: the full-sequence attention: "flash_prefill" (K8) or "blocked" (the
#: plain ``flash_attention``, what the JAX model computes); comparisons
#: swap it
PREFILL_PLAN = "flash_prefill"
#: the decode of a full, unquantized cache: "decode_attn" (K9) or "einsum"
#: (the plain twin of the JAX model's ``decode_attention``)
DECODE_PLAN = "decode_attn"


def init_attention(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, device="cpu") -> dict:
    """``wq`` (d, Hq, dh), ``wk``/``wv`` (d, Hkv, dh), ``wo`` (Hq, dh, d),
    each drawn at scale d^-1/2, and with ``cfg.qkv_bias`` the zero biases
    ``bq`` (Hq, dh), ``bk``/``bv`` (Hkv, dh): the JAX package's tree."""
    d, hq, hkv, dh = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
                      cfg.resolved_head_dim)

    def w(shape):
        return common.truncated_normal(gen, shape, d ** -0.5, dtype, device)

    p = {"wq": w((d, hq, dh)), "wk": w((d, hkv, dh)), "wv": w((d, hkv, dh)),
         "wo": w((hq, dh, d))}
    if cfg.qkv_bias:
        for name, h in (("bq", hq), ("bk", hkv), ("bv", hkv)):
            p[name] = torch.zeros(h, dh, dtype=dtype, device=device)
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
    (the JAX package computes them a second time there)."""
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


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def init_cache_slot(cfg: ModelConfig, n_groups: int, batch: int,
                    max_seq: int, dtype: torch.dtype, device="cpu") -> dict:
    """Zero KV cache of one attention slot, stacked over groups: ``k``,
    ``v`` (G, B, S_c, Hkv, dh) with S_c = min(max_seq, window) for a ring;
    with ``kv_quant`` int8 values plus ``k_scale``/``v_scale`` (G, B, S_c,
    Hkv) f32."""
    w = cfg.sliding_window or 0
    s_c = min(max_seq, w) if w else max_seq
    shape = (n_groups, batch, s_c, cfg.n_kv_heads, cfg.resolved_head_dim)
    if cfg.kv_quant:
        return {"k": torch.zeros(shape, dtype=torch.int8, device=device),
                "v": torch.zeros(shape, dtype=torch.int8, device=device),
                "k_scale": torch.zeros(shape[:-1], dtype=F32, device=device),
                "v_scale": torch.zeros(shape[:-1], dtype=F32, device=device)}
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


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
    scores = torch.where(valid[:, None, None], scores, NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    if cfg.kv_quant:
        probs = probs * cache["v_scale"].transpose(1, 2)[:, :, None]
        return torch.einsum("bkgs,bskd->bkgd", probs.to(dtype).to(F32),
                            v_cache.to(dtype).to(F32))
    return torch.einsum("bkgs,bskd->bkgd", probs.to(v_cache.dtype).to(F32),
                        v_cache.to(F32))


def decode_attention(p: dict, x: torch.Tensor, cache: dict,
                     pos: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """One-token cached attention.  x: (B, 1, d); cache slot arrays
    (B, S_c, Hkv, dh), written in place at each lane's slot; pos: the
    absolute position of this token, a 0-d tensor (the wave engine's
    lockstep lanes) or one per lane (B,), on x's device.  A full,
    unquantized cache runs ``DECODE_PLAN``, with ``lengths = pos + 1``
    handed to K9 as a device tensor; ring and int8 caches run the grouped
    contractions.  Returns (B, 1, d)."""
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
        cache[name][rows, slot_b] = val[:, 0].to(cache[name].dtype)

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
