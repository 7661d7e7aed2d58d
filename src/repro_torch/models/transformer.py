"""Decoder assembly (the port's twin of the JAX package's
``models/transformer.py``), with the attention, RWKV6 and Mamba paths
ported.

A model is a periodic stack of blocks; each block = (mix, mlp) chosen per
slot by the config.  The port has the dense attention blocks (GQA
attention + dense MLP: Qwen2, Yi, StableLM, Command-R), the rwkv6 blocks
(time-mix + channel-mix) and the mamba blocks (Mamba + dense MLP); a
config with MoE layers, vision tokens or audio codebooks raises
``NotImplementedError`` naming the ROADMAP item that ports it, by its
title.  As in JAX, the block parameters are a list over the period's slots
whose leaves are stacked over layer groups (a leading layer axis); the
layers run in a Python loop over the groups.

Three entry points share the block code:
  * forward      — full sequence from zero state (reference logits, and
                   the training forward: differentiable, ``remat=``,
                   except through attention, whose training is not ported)
  * prefill      — full sequence, fills the decode cache IN PLACE
  * decode_step  — one token against the preallocated cache, in place

``forward`` carries each layer's recurrent states as values, as the JAX
package's does: writing them into a scratch cache would modify tensors
autograd has saved.  prefill and decode write the cache in place: the
recurrent states are copied (``copy_``) into the checked-out buffers, and
an attention layer writes its k and v straight into its slot (positions
[0, S) in a prefill, slot ``pos`` in a decode step), so a step never copies
a whole KV cache.  The JAX package donates its caches to its jits for the
same effect, so a serve never allocates a cache (core/state.StatePool).
The sequence-parallel time-mix and ``prefill_chunk`` (chunked admission)
wait for their slices (ROADMAP Queue 1, "Distributed, launch and
checkpoint" and "The serving stack").
"""
from __future__ import annotations

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mamba, mlp, rwkv
from repro_torch.optim.adamw import tree_leaves, tree_map

F32 = torch.float32


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _roadmap(title: str) -> str:
    return f'(ROADMAP Queue 1, "{title}")'


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for what the port cannot run yet, naming its ROADMAP item by
    its title."""
    todo = []
    if cfg.n_codebooks or cfg.n_vis_tokens:
        todo.append("audio and vision fronts "
                    + _roadmap("The vision and audio fronts"))
    if cfg.moe is not None:
        todo.append("MoE layers " + _roadmap("MoE and the full Jamba hybrid"))
    if todo:
        raise NotImplementedError(
            f"{cfg.name}: not ported yet: {'; '.join(todo)}")
    if cfg.ssm is not None and cfg.ssm.kind not in ("rwkv6", "mamba"):
        raise NotImplementedError(
            f"{cfg.name}: only the rwkv6 and mamba mixes are ported")


def _has_attention(cfg: ModelConfig) -> bool:
    return any(cfg.layer_kind(s) == "attn" for s in range(cfg.period))


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a config the port cannot differentiate: one with
    attention layers (K8 has no backward; JAX trains through its jnp
    blocked attention)."""
    _check_ported(cfg)
    if _has_attention(cfg):
        raise NotImplementedError(
            f"{cfg.name}: training through attention layers is not ported "
            f"yet {_roadmap('Attention training')}")


def _n_groups(cfg: ModelConfig) -> int:
    return cfg.n_layers // cfg.period


def _layer(tree, g: int):
    """Group ``g``'s slice (views) of a tree whose leaves are stacked over
    groups."""
    return tree_map(lambda t: t[g], tree)


def _groups(tree, n: int) -> list:
    """The ``n`` group slices of a tree whose leaves are stacked over
    groups, with ONE ``unbind(0)`` per leaf: its backward stacks the
    groups' gradients into one leaf-sized tensor, where ``t[g]`` per layer
    would allocate and zero a whole leaf-sized gradient for every group."""
    parts = [leaf.unbind(0) for leaf in tree_leaves(tree)]
    out = []
    for g in range(n):
        it = iter([p[g] for p in parts])
        out.append(tree_map(lambda _: next(it), tree))
    return out


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------
def _rwkv(cfg: ModelConfig) -> bool:
    return cfg.ssm is not None and cfg.ssm.kind == "rwkv6"


def _init_slot(gen: torch.Generator, cfg: ModelConfig, slot: int, dtype,
               device) -> dict:
    """Slot ``slot``'s block, as the JAX package chooses it: attention, an
    rwkv6 time-mix or a Mamba mix, then the rwkv6 channel-mix or a dense
    MLP."""
    if cfg.layer_kind(slot) == "attn":
        mix = attention.init_attention(gen, cfg, dtype, device)
    elif _rwkv(cfg):
        mix = rwkv.init_tmix(gen, cfg, dtype, device)
    else:
        mix = mamba.init_mamba(gen, cfg, dtype, device)
    mlp_p = (rwkv.init_cmix if _rwkv(cfg) else mlp.init_mlp)(gen, cfg, dtype,
                                                              device)
    return {"ln1": common.init_norm(cfg.d_model, cfg.norm, F32, device),
            "mix": mix,
            "ln2": common.init_norm(cfg.d_model, cfg.norm, F32, device),
            "mlp": mlp_p}


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: str | torch.device = "cpu") -> dict:
    """Parameter tree with weights drawn from ``gen`` (a generator on
    ``device``): ``embed``, ``blocks`` (a list over the period's slots,
    leaves stacked over layer groups), ``final_norm`` and ``lm_head``, in
    the JAX package's layouts."""
    _check_ported(cfg)
    dtype = _dtype(cfg)
    p: dict = {"embed": common.init_embedding(gen, cfg.vocab, cfg.d_model,
                                              dtype, device)}
    p["blocks"] = []
    for slot in range(cfg.period):
        groups = [_init_slot(gen, cfg, slot, dtype, device)
                  for _ in range(_n_groups(cfg))]
        p["blocks"].append(tree_map(lambda *ts: torch.stack(ts), *groups))
    p["final_norm"] = common.init_norm(cfg.d_model, cfg.norm, F32, device)
    if not cfg.tie_embeddings:
        p["lm_head"] = common.init_linear(gen, cfg.d_model, cfg.vocab, dtype,
                                          device)
    return p


# ---------------------------------------------------------------------------
# Cache
# ---------------------------------------------------------------------------
def _zero_slot(cfg: ModelConfig, slot: int, batch: int, device) -> dict:
    """Slot ``slot``'s zero states (the JAX package's
    ``_dummy_cache_slot``): what ``forward`` starts every layer from; none
    for attention, which ``forward`` runs without a cache."""
    dtype, d = _dtype(cfg), cfg.d_model
    if cfg.layer_kind(slot) == "attn":
        return {}
    if not _rwkv(cfg):
        di, ds, dc = mamba.d_inner(cfg), cfg.ssm.d_state, cfg.ssm.d_conv
        return {"conv": torch.zeros(batch, dc - 1, di, dtype=dtype,
                                    device=device),
                "h": torch.zeros(batch, di, ds, dtype=F32, device=device)}
    H, dh = rwkv.n_heads(cfg), cfg.ssm.head_dim
    return {"shift_t": torch.zeros(batch, d, dtype=dtype, device=device),
            "wkv": torch.zeros(batch, H, dh, dh, dtype=F32, device=device),
            "shift_c": torch.zeros(batch, d, dtype=dtype, device=device)}


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: str | torch.device = "cpu") -> dict:
    """Zero decode cache: ``pos`` (a 0-d int32 tensor) and per slot, for
    attention, ``k``/``v`` (groups, B, S_c, Hkv, dh) in the model dtype
    with S_c = ``max_seq`` (the window, for a ring; int8 values and f32
    scales with ``kv_quant``: ``attention.init_cache_slot``); for rwkv6,
    the token-shift states ``shift_t``/``shift_c`` (groups, B, d) in the
    model dtype and the wkv state (groups, B, H, dh, dh) f32; for mamba
    the conv window ``conv`` (groups, B, dc-1, di) in the model dtype and
    the ssm state ``h`` (groups, B, di, ds) f32.  A recurrent state does
    not grow with ``max_seq``.  On the ``meta`` device it is the
    shape-and-dtype spec a StatePool builds its buffers from."""
    _check_ported(cfg)
    n = _n_groups(cfg)
    slots = []
    for s in range(cfg.period):
        if cfg.layer_kind(s) == "attn":
            slots.append(attention.init_cache_slot(cfg, n, batch, max_seq,
                                                   _dtype(cfg), device))
        else:
            slots.append({k: v.expand(n, *v.shape).clone() for k, v in
                          _zero_slot(cfg, s, batch, device).items()})
    return {"pos": torch.zeros((), dtype=torch.int32, device=device),
            "slots": slots}


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _apply_mlp_slot(slot_p: dict, cfg: ModelConfig, x: torch.Tensor,
                    cache: dict) -> tuple[torch.Tensor, dict]:
    """Second half-block (the rwkv6 channel-mix, or the dense MLP) with
    residual."""
    h = common.apply_norm(slot_p["ln2"], x, cfg.norm)
    if not _rwkv(cfg):
        return x + mlp.apply_mlp(slot_p["mlp"], h), cache
    out, shift = rwkv.apply_cmix(slot_p["mlp"], h, cache["shift_c"])
    return x + out, dict(cache, shift_c=shift)


def _apply_block(slot_p: dict, cfg: ModelConfig, slot: int,
                 x: torch.Tensor, cache_slot: dict, positions, pos,
                 mode: str) -> tuple[torch.Tensor, dict]:
    """One block (mix + mlp).  ``cache_slot`` has NO group dim.  mode:
    'full' | 'prefill' | 'decode'; ``positions`` (B, S) are the sequence's
    (full and prefill), ``pos`` the decode token's (a 0-d tensor).
    Returns the new activations and the block's new recurrent states (new
    tensors); an attention block writes its cache slot in place and
    returns none."""
    h = common.apply_norm(slot_p["ln1"], x, cfg.norm)
    if cfg.layer_kind(slot) == "attn":
        if mode == "decode":
            out = attention.decode_attention(slot_p["mix"], h, cache_slot,
                                             pos, cfg)
        else:
            out = attention.apply_attention(
                slot_p["mix"], h, cfg, positions,
                cache=cache_slot if mode == "prefill" else None)
        new = {}
    elif _rwkv(cfg):
        fn = rwkv.step_tmix if mode == "decode" else rwkv.apply_tmix
        out, shift, state = fn(slot_p["mix"], cfg, h, cache_slot["shift_t"],
                               cache_slot["wkv"])
        new = dict(cache_slot, shift_t=shift, wkv=state)
    else:
        fn = mamba.step_mamba if mode == "decode" else mamba.apply_mamba
        out, conv, hst = fn(slot_p["mix"], cfg, h, cache_slot["conv"],
                            cache_slot["h"])
        new = dict(cache_slot, conv=conv, h=hst)
    return _apply_mlp_slot(slot_p, cfg, x + out, new)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def embed_inputs(params: dict, cfg: ModelConfig, batch: dict
                 ) -> torch.Tensor:
    del cfg
    return params["embed"][batch["tokens"].long()]


def lm_logits(params: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    if cfg.tie_embeddings:
        logits = x @ params["embed"].T
    else:
        logits = common.apply_linear(params["lm_head"], x)
    return common.softcap(logits.to(F32), cfg.logit_softcap)


def _run_stack(params: dict, cfg: ModelConfig, x: torch.Tensor,
               cache: dict, mode: str, positions=None, pos=None
               ) -> torch.Tensor:
    """All layers in order, each starting from its slice of the cache and
    copying its new recurrent states into it (an attention layer has
    written its slot itself); prefill and decode, never under autograd."""
    for g in range(_n_groups(cfg)):
        for s in range(cfg.period):
            slot_p = _layer(params["blocks"][s], g)
            slot_c = _layer(cache["slots"][s], g)
            x, new = _apply_block(slot_p, cfg, s, x, slot_c, positions, pos,
                                  mode)
            for name, state in new.items():
                slot_c[name].copy_(state)
    return common.apply_norm(params["final_norm"], x, cfg.norm)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = False, inference: bool = False
            ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward, every layer from zero states, the states
    carried as values (differentiable).  Returns (logits (B,S,V) f32,
    aux).  ``remat`` recomputes each layer group in the backward
    (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint`` of
    its group function): only the groups' inputs are kept, and a group's
    forward runs twice per gradient.  ``inference`` is the JAX signature's
    (it switches MoE dispatch, which the ported paths do not have).  A
    config with attention layers raises when autograd would record the
    call (``check_trainable``)."""
    del inference
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tree_leaves(params)):
        check_trainable(cfg)
    x = embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    zeros = [_zero_slot(cfg, s, B, x.device) for s in range(cfg.period)]

    def group_fn(x, group_p):
        for s, slot_p in enumerate(group_p):
            x, _ = _apply_block(slot_p, cfg, s, x, zeros[s], positions, None,
                                "full")
        return x

    slots = [_groups(p, _n_groups(cfg)) for p in params["blocks"]]
    for group_p in zip(*slots):
        x = (checkpoint(group_fn, x, group_p, use_reentrant=False) if remat
             else group_fn(x, group_p))
    x = common.apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params, cfg, x), {}


def prefill(params: dict, cfg: ModelConfig, cache: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that fills the decode cache in place.

    Returns (logits of the LAST position (B,1,V) f32, the same cache)."""
    x = embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = _run_stack(params, cfg, x, cache, "prefill", positions=positions)
    cache["pos"].fill_(S)
    return lm_logits(params, cfg, x[:, -1:]), cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict, batch: dict
                ) -> tuple[torch.Tensor, dict]:
    """One decode step, in place.  batch['tokens']: (B,).  Returns
    (logits (B,V) f32, the same cache)."""
    x = embed_inputs(params, cfg, {"tokens": batch["tokens"][:, None]})
    x = _run_stack(params, cfg, x, cache, "decode", pos=cache["pos"])
    cache["pos"].add_(1)
    return lm_logits(params, cfg, x)[:, 0], cache
