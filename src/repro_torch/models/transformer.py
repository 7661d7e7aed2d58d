"""Decoder assembly (the port's twin of the JAX package's
``models/transformer.py``), with the attention, RWKV6, Mamba and MoE paths
and the vision and audio fronts ported.

A model is a periodic stack of blocks; each block = (mix, mlp) chosen per
slot by the config: mix ∈ {GQA attention, rwkv6 time-mix, Mamba}, mlp ∈
{dense MLP, MoE, rwkv6 channel-mix} (Qwen2, Yi, StableLM, Command-R;
OLMoE, Qwen3-MoE; RWKV6; Jamba, whose period mixes attention, Mamba, MLP
and MoE).  As in JAX, the block parameters are a list over the period's
slots whose leaves are stacked over layer groups (a leading layer axis);
the layers run in a Python loop over the groups.

The modality fronts, as in the JAX package (their encoders are stubs):
  * vlm    — precomputed patch embeddings ``batch['vis_embeds']`` (B, n_vis,
             vis_dim) -> a learned 2-layer projector (``vis_proj``: in,
             tanh GELU, out), prepended to the text sequence; only where
             the batch holds them (a decode step embeds its token alone)
  * audio  — K parallel EnCodec codebook ids ``tokens`` (B, K, S), embedded
             (``audio_embed`` (K, V, d)) and summed; K output heads
             (``audio_heads`` (K, d, V)) predict the next token of every
             codebook: logits (B, K, S, V), a decode step's (B, K, V)

Four entry points share the block code:
  * forward        — full sequence from zero state (reference logits, and
                     the training forward: differentiable, ``remat=``;
                     attention trains through K8t and K8b,
                     kernels/flash_prefill.py); returns the MoE aux
                     losses summed over the MoE layers
  * prefill        — full sequence, fills the decode cache IN PLACE
  * prefill_chunk  — one prompt segment continuing at ``cache['pos']``
                     (the slot engine's chunked admission), in place
  * decode_step    — one token against the preallocated cache, in place;
                     with ``batch['active']`` an inactive lane's cache and
                     ``pos`` stay bit for bit as they were

``forward`` carries each layer's recurrent states as values, as the JAX
package's does: writing them into a scratch cache would modify tensors
autograd has saved.  prefill and decode write the cache in place: the
recurrent states are copied (``copy_``) into the checked-out buffers, and
an attention layer writes its k and v straight into its slot (positions
[0, S) in a prefill, slot ``pos`` in a decode step), so a step never copies
a whole KV cache.  The JAX package donates its caches to its jits for the
same effect, so a serve never allocates a cache (core/state.StatePool).
``decode_step`` neither reads a device value on the host nor makes a
tensor of data-dependent shape, so the slot engine captures it in a CUDA
graph (serving/tick.py), MoE layers included (``models/moe.py``).  An MoE
layer dispatches drop-free on every path but the training forward
(``forward(inference=False)``), so decode equals the forward.

The residual stream and the logits pass through ``partitioning.constrain``
at the JAX package's places (the activation sequence axis is "seq_model"
for a ``seq_shard`` config): under ``use_rules`` on one device that is the
identity, no copy and no launch, also inside a captured tick.
``init_params_annot``/``init_cache_annot`` give the trees with their
logical axes and ``abstract_params``/``abstract_cache`` the same as meta
tensors.  On a mesh of more than one device (over a process group) the
parameters, the batch and the caches are DTensors
(``partitioning.device_put``): the zero states and the aux sums are placed
beside them (``partitioning.place``), ``constrain`` redistributes, and
every block runs a ``shard_map`` body on rank-local tensors, the kernels
inside: attention (batch over 'data', heads over 'model'; the cache's
sequence over 'model' in prefill and decode), Mamba (channels over
'model'), the MLP, the MoE (expert-parallel, or dense on each batch
shard), the time-mix (sequence-parallel or on each batch shard), the
embedding and the head (vocabulary over 'model'); the norms, the residual
stream and the rwkv6 channel-mix are DTensor ops.  A remat group's
recompute runs under the rules of its forward.  Every arch x input shape
runs so on the production mesh in the dry run (``launch/dryrun.py``).
"""
from __future__ import annotations

import contextlib

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import partitioning as pt
from repro_torch.configs.base import ModelConfig
from repro_torch.models import attention, common, mamba, mlp, moe, rwkv
from repro_torch.optim.adamw import tree_leaves, tree_map
from repro_torch.partitioning import (Annot, constrain, dense_init, place,
                                      split, stack_axes, zeros_init)

F32 = torch.float32
#: the aux losses an MoE layer returns, which ``forward`` sums over layers
MOE_AUX = ("moe_load_balance", "moe_z_loss", "moe_drop_frac")


def _dtype(cfg: ModelConfig) -> torch.dtype:
    return getattr(torch, cfg.dtype)


def _check_ported(cfg: ModelConfig) -> None:
    """Raise for a mix the port has no path for: an ``ssm.kind`` other
    than rwkv6 and mamba (the JAX package builds a Mamba mix for any other
    kind; the port refuses it rather than guess)."""
    if cfg.ssm is not None and cfg.ssm.kind not in ("rwkv6", "mamba"):
        raise NotImplementedError(
            f"{cfg.name}: only the rwkv6 and mamba mixes are ported")


def check_trainable(cfg: ModelConfig) -> None:
    """Raise for a config the port cannot differentiate: one with an
    unported mix.  Every ported mix trains, under either front: attention
    through K8t and K8b (``ops.flash_prefill`` under autograd), rwkv6
    through K6t and K6b, Mamba through K7t and K7b."""
    _check_ported(cfg)


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


def _init_slot_annot(gen: torch.Generator, cfg: ModelConfig, slot: int,
                     dtype, device) -> dict:
    """Slot ``slot``'s annotated block, as the JAX package chooses it:
    attention, an rwkv6 time-mix or a Mamba mix, then the rwkv6
    channel-mix, MoE (where ``cfg.layer_is_moe(slot)``) or a dense MLP."""
    if cfg.layer_kind(slot) == "attn":
        mix = attention.init_attention_annot(gen, cfg, dtype, device)
    elif _rwkv(cfg):
        mix = rwkv.init_tmix_annot(gen, cfg, dtype, device)
    else:
        mix = mamba.init_mamba_annot(gen, cfg, dtype, device)
    if _rwkv(cfg):
        init_mlp = rwkv.init_cmix_annot
    elif cfg.layer_is_moe(slot):
        init_mlp = moe.init_moe_annot
    else:
        init_mlp = mlp.init_mlp_annot
    mlp_p = init_mlp(gen, cfg, dtype, device)
    return {"ln1": common.init_norm_annot(cfg.d_model, cfg.norm, F32, device),
            "mix": mix,
            "ln2": common.init_norm_annot(cfg.d_model, cfg.norm, F32, device),
            "mlp": mlp_p}


def _init_slot(gen: torch.Generator, cfg: ModelConfig, slot: int, dtype,
               device) -> dict:
    """One group of slot ``slot``: ``_init_slot_annot``'s tensors."""
    return split(_init_slot_annot(gen, cfg, slot, dtype, device))[0]


def init_params_annot(cfg: ModelConfig, gen: torch.Generator | None,
                      device: str | torch.device = "cpu") -> dict:
    """Annotated parameter tree (``partitioning.Annot`` leaves: the tensor
    and the JAX package's logical axes; ``init_params`` describes the
    tensors).  On the ``meta`` device nothing is drawn or allocated and
    ``gen`` may be None (``abstract_params``)."""
    _check_ported(cfg)
    dtype = _dtype(cfg)
    d, K = cfg.d_model, cfg.n_codebooks
    p: dict = {}
    if K:
        p["audio_embed"] = dense_init(gen, (K, cfg.vocab, d),
                                      (None, "vocab", "embed"), dtype, device,
                                      scale=d ** -0.5)
    else:
        p["embed"] = common.init_embedding_annot(gen, cfg.vocab, d, dtype,
                                                 device)
    if cfg.n_vis_tokens:
        p["vis_proj"] = {
            "in": common.init_linear_annot(gen, cfg.vis_dim, d,
                                           ("embed_nofsdp", "embed"), dtype,
                                           device, bias=True),
            "out": common.init_linear_annot(gen, d, d,
                                            ("embed", "embed_nofsdp"), dtype,
                                            device, bias=True)}
    p["blocks"] = []
    n = _n_groups(cfg)
    for slot in range(cfg.period):
        stacked = None
        for g in range(n):
            group = _init_slot_annot(gen, cfg, slot, dtype, device)
            if stacked is None:
                stacked = tree_map(lambda a: Annot(
                    a.value.new_empty((n, *a.value.shape)),
                    stack_axes(a.axes)), group)
            tree_map(lambda dst, src: dst.value[g].copy_(src.value),
                     stacked, group)
            del group                 # freed before the next group's draw
        p["blocks"].append(stacked)
    p["final_norm"] = common.init_norm_annot(d, cfg.norm, F32, device)
    if K:
        p["audio_heads"] = dense_init(gen, (K, d, cfg.vocab),
                                      (None, "embed", "vocab"), dtype, device,
                                      scale=d ** -0.5)
    elif not cfg.tie_embeddings:
        p["lm_head"] = common.init_linear_annot(gen, d, cfg.vocab,
                                                ("embed", "vocab"), dtype,
                                                device)
    return p


def init_params(cfg: ModelConfig, gen: torch.Generator,
                device: str | torch.device = "cpu") -> dict:
    """Parameter tree with weights drawn from ``gen`` (a generator on
    ``device``), in the JAX package's layouts and scales: ``embed`` (V, d)
    or, with audio codebooks, ``audio_embed`` (K, V, d); with vision tokens
    ``vis_proj`` ``{"in": {"w": (vis_dim, d), "b"}, "out": {"w": (d, d),
    "b"}}``; ``blocks`` (a list over the period's slots, leaves stacked
    over layer groups); ``final_norm``; then ``audio_heads`` (K, d, V)
    with codebooks, else ``lm_head`` unless the embeddings are tied.  Each
    stacked leaf is allocated once and filled group by group, so the draw
    holds one group's tensors beside the stack, not a second copy of the
    slot.  The tensors of ``init_params_annot``: one draw."""
    return split(init_params_annot(cfg, gen, device))[0]


def abstract_params(cfg: ModelConfig) -> tuple[dict, dict]:
    """(meta-tensor tree, axes tree) of ``init_params``: shapes and dtypes
    at any width with nothing allocated or drawn."""
    return split(init_params_annot(cfg, None, "meta"))


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


#: the logical axes of each recurrent state of a slot (the JAX package's
#: ``init_cache``), before the leading "layers"
STATE_AXES = {"shift_t": ("batch", "embed_nofsdp"),
              "wkv": ("batch", "heads", None, None),
              "shift_c": ("batch", "embed_nofsdp"),
              "conv": ("batch", None, "mlp"),
              "h": ("batch", "mlp", None)}


def init_cache_annot(cfg: ModelConfig, batch: int, max_seq: int,
                     device: str | torch.device = "cpu", *,
                     per_lane_pos: bool = False) -> dict:
    """Annotated zero decode cache (``init_cache`` describes the tensors;
    the axes are the JAX package's).  The per-lane ``pos`` (B,), which the
    JAX package's cache lacks, takes the axes its shape implies:
    ("batch",)."""
    _check_ported(cfg)
    n = _n_groups(cfg)
    slots = []
    for s in range(cfg.period):
        if cfg.layer_kind(s) == "attn":
            slots.append(attention.init_cache_slot_annot(
                cfg, n, batch, max_seq, _dtype(cfg), device))
        else:
            slots.append({k: Annot(v.expand(n, *v.shape).clone(),
                                   stack_axes(STATE_AXES[k])) for k, v in
                          _zero_slot(cfg, s, batch, device).items()})
    pos_shape, pos_axes = ((batch,), ("batch",)) if per_lane_pos \
        else ((), ())
    return {"pos": zeros_init(pos_shape, pos_axes, torch.int32, device),
            "slots": slots}


def abstract_cache(cfg: ModelConfig, batch: int, max_seq: int
                   ) -> tuple[dict, dict]:
    """(meta-tensor tree, axes tree) of ``init_cache``, nothing
    allocated."""
    return split(init_cache_annot(cfg, batch, max_seq, "meta"))


def init_cache(cfg: ModelConfig, batch: int, max_seq: int,
               device: str | torch.device = "cpu", *,
               per_lane_pos: bool = False) -> dict:
    """Zero decode cache: ``pos`` (a 0-d int32 tensor; with
    ``per_lane_pos`` one per lane, (B,) int32, the form the slot engine's
    continuous batching decodes with) and per slot, for
    attention, ``k``/``v`` (groups, B, S_c, Hkv, dh) in the model dtype
    with S_c = ``max_seq`` (the window, for a ring; int8 values and f32
    scales with ``kv_quant``: ``attention.init_cache_slot_annot``); for rwkv6,
    the token-shift states ``shift_t``/``shift_c`` (groups, B, d) in the
    model dtype and the wkv state (groups, B, H, dh, dh) f32; for mamba
    the conv window ``conv`` (groups, B, dc-1, di) in the model dtype and
    the ssm state ``h`` (groups, B, di, ds) f32.  A recurrent state does
    not grow with ``max_seq``.  On the ``meta`` device it is the
    shape-and-dtype spec a StatePool builds its buffers from.  The
    tensors of ``init_cache_annot``."""
    return split(init_cache_annot(cfg, batch, max_seq, device,
                                  per_lane_pos=per_lane_pos))[0]


# ---------------------------------------------------------------------------
# Block application
# ---------------------------------------------------------------------------
def _apply_mlp_slot(slot_p: dict, cfg: ModelConfig, slot: int,
                    x: torch.Tensor, mix_out: torch.Tensor, cache: dict,
                    mode: str) -> tuple[torch.Tensor, dict, dict | None]:
    """Second half-block (the rwkv6 channel-mix, MoE or the dense MLP) with
    residual, after the first half-block's output ``mix_out``.  Returns
    (x, cache, the MoE layer's aux or None); MoE dispatches drop-free in
    every mode but 'full' (the training forward), as in the JAX package.

    The residual ``x + mix_out`` rounds to the model dtype, but the norm
    reads the sum unrounded, in f32: the JAX package's compiled layer does
    so (XLA, which may keep excess precision, drops the bf16 round trip
    between the add and the norm's f32 cast, in every family).  Rounding
    the norm's input there left the bf16 RWKV6 gradients up to 3x further
    from f32 than JAX's (tests/test_torch_lm_train.py)."""
    h = common.apply_norm(slot_p["ln2"], x.to(F32) + mix_out.to(F32),
                          cfg.norm).to(x.dtype)
    x = x + mix_out
    if _rwkv(cfg):
        out, shift = rwkv.apply_cmix(slot_p["mlp"], h, cache["shift_c"])
        return x + out, dict(cache, shift_c=shift), None
    if cfg.layer_is_moe(slot):
        out, aux = moe.apply_moe(slot_p["mlp"], h, cfg,
                                 no_drop=(mode != "full"))
        return x + out, cache, aux
    return x + mlp.apply_mlp(slot_p["mlp"], h), cache, None


def _apply_block(slot_p: dict, cfg: ModelConfig, slot: int,
                 x: torch.Tensor, cache_slot: dict, positions, pos,
                 mode: str, active: torch.Tensor | None = None
                 ) -> tuple[torch.Tensor, dict, dict | None]:
    """One block (mix + mlp).  ``cache_slot`` has NO group dim.  mode:
    'full' | 'infer' (the forward, training and drop-free) | 'prefill' |
    'prefill_chunk' | 'decode'; ``positions`` (B, S) are the sequence's
    (full, prefill and a chunk's absolute ones), ``pos`` the decode
    token's (a 0-d tensor, or (B,) per lane), and ``active`` the decode's
    lane mask (or None).  Returns the new activations, the block's new
    recurrent states (new tensors; an attention block writes its cache
    slot in place and returns none) and an MoE block's aux (else None)."""
    x = constrain(x, ("batch", _sax(cfg), None))
    h = common.apply_norm(slot_p["ln1"], x, cfg.norm)
    if cfg.layer_kind(slot) == "attn":
        if mode == "decode":
            out = attention.decode_attention(slot_p["mix"], h, cache_slot,
                                             pos, cfg, active=active)
        elif mode == "prefill_chunk":
            out = attention.chunk_prefill_attention(slot_p["mix"], h,
                                                    cache_slot, cfg,
                                                    positions)
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
    return _apply_mlp_slot(slot_p, cfg, slot, x, out, new, mode)


# ---------------------------------------------------------------------------
# Embedding / head
# ---------------------------------------------------------------------------
def _sax(cfg: ModelConfig) -> str:
    """Logical name of the activation sequence axis (sequence parallelism
    shards it over 'model' for cfg.seq_shard archs)."""
    return "seq_model" if cfg.seq_shard else "seq"


def embed_inputs(params: dict, cfg: ModelConfig, batch: dict
                 ) -> torch.Tensor:
    """(B, S, d) in the model dtype.  Audio: ``tokens`` (B, K, S), the K
    codebooks' embeddings summed onto zeros in the model dtype, codebook 0
    first (the JAX package's order, so bf16 rounds alike).  Vision, where
    the batch holds ``vis_embeds`` (B, n_vis, vis_dim): the projected
    patches, then the text's embeddings, ``[vis | text]``."""
    rules = pt.active_rules()
    if rules is not None:
        return _embed_sharded(params, cfg, batch, rules)
    toks = batch["tokens"].long()
    if cfg.n_codebooks:
        x = torch.zeros(toks.shape[:1] + toks.shape[2:] + (cfg.d_model,),
                        dtype=_dtype(cfg), device=toks.device)
        for k in range(cfg.n_codebooks):
            x = x + params["audio_embed"][k][toks[:, k]]
        return x
    x = constrain(params["embed"][toks], ("batch", _sax(cfg), None))
    if cfg.n_vis_tokens and "vis_embeds" in batch:
        vp = params["vis_proj"]
        v = common.apply_linear(vp["in"], batch["vis_embeds"].to(x.dtype))
        v = common.apply_linear(vp["out"], common.gelu(v))
        x = torch.cat([v, x], dim=1)
    return x


def lm_logits(params: dict, cfg: ModelConfig, x: torch.Tensor
              ) -> torch.Tensor:
    """f32 logits of x (B, S, d), softcapped: (B, S, V), or with audio
    codebooks each head's, (B, K, S, V)."""
    sax = _sax(cfg)
    x = constrain(x, ("batch", sax, None))
    rules = pt.active_rules()
    if rules is not None:
        return _logits_sharded(params, cfg, x, rules)
    if cfg.n_codebooks:
        logits = torch.einsum("bsd,kdv->bksv", x, params["audio_heads"])
        logits = constrain(logits, ("batch", None, sax, "vocab"))
    elif cfg.tie_embeddings:
        logits = constrain(x @ params["embed"].T, ("batch", sax, "vocab"))
    else:
        logits = constrain(common.apply_linear(params["lm_head"], x),
                           ("batch", sax, "vocab"))
    return common.softcap(logits.to(F32), cfg.logit_softcap)


# ---------------------------------------------------------------------------
# Embedding and head on a mesh of more than one device
#
# ``shard_map`` bodies, as the blocks: the tokens' batch over ('pod',
# 'data') (their sequence over 'model' for a ``seq_shard`` config), the
# vocabulary of each table over 'model' where the specs split it (gathered
# over 'data' on entry).  A lookup in a split table takes the rows this
# rank holds and zeros elsewhere, and one psum over 'model' (a codebook at
# a time, so every sum has one non-zero term: exact) assembles the
# embeddings; the head writes each rank's vocabulary slice of the logits.
# ---------------------------------------------------------------------------
def _lookup(table: torch.Tensor, toks: torch.Tensor, split: bool
            ) -> torch.Tensor:
    """Rows ``toks`` of ``table`` (this rank's vocabulary slice when
    ``split``, the psum over 'model' assembling them)."""
    if not split:
        return table[toks]
    n = table.shape[0]
    i = toks - pt.axis_index("model") * n
    mine = (i >= 0) & (i < n)
    rows = table[i.clamp(0, n - 1)] * mine[..., None].to(table.dtype)
    return pt.psum(rows, "model")


def _embed_sharded(params: dict, cfg: ModelConfig, batch: dict, rules
                   ) -> torch.Tensor:
    """``embed_inputs`` on DTensors (the section comment); where the
    tokens' sequence takes 'model' the table enters whole."""
    sax = _sax(cfg)
    toks = batch["tokens"]
    name = "audio_embed" if cfg.n_codebooks else "embed"
    tok_axes = ("batch", None, sax) if cfg.n_codebooks else ("batch", sax)
    tok_spec = rules.spec_for(tok_axes, toks.shape)
    # a sequence split over 'model' leaves the table whole: each rank
    # looks up its own tokens
    t_spec = pt.PartitionSpec() if pt.sharded_over(
        tok_spec, toks.dim() - 1, rules.mesh) else pt.only_axes(
        pt.spec_of(params[name]))
    split = pt.sharded_over(t_spec, 1 if cfg.n_codebooks else 0,
                            rules.mesh)
    args = [toks, params[name]]
    specs = [tok_spec, t_spec]
    vision = bool(cfg.n_vis_tokens and "vis_embeds" in batch)
    if vision:
        args += [batch["vis_embeds"], params["vis_proj"]]
        specs += [rules.spec_for(("batch", None, None),
                                 batch["vis_embeds"].shape),
                  pt.PartitionSpec()]
    B, S = toks.shape[0], toks.shape[-1]
    S_out = S + (cfg.n_vis_tokens if vision else 0)
    x_spec = rules.spec_for(("batch", sax, None), (B, S_out, cfg.d_model))

    def local_fn(toks_l, table_l, vis_l=None, vp_l=None):
        toks_l = toks_l.long()
        if cfg.n_codebooks:
            x = torch.zeros(toks_l.shape[:1] + toks_l.shape[2:]
                            + (cfg.d_model,), dtype=_dtype(cfg),
                            device=toks_l.device)
            for k in range(cfg.n_codebooks):
                x = x + _lookup(table_l[k], toks_l[:, k], split)
            return x
        x = _lookup(table_l, toks_l, split)
        if vision:
            v = common.apply_linear(vp_l["in"], vis_l.to(x.dtype))
            v = common.apply_linear(vp_l["out"], common.gelu(v))
            x = torch.cat([v, x], dim=1)
        return x

    return pt.shard_map(local_fn, rules.mesh, in_specs=tuple(specs),
                        out_specs=x_spec)(*args)


def _logits_sharded(params: dict, cfg: ModelConfig, x: torch.Tensor,
                    rules) -> torch.Tensor:
    """``lm_logits`` on DTensors (the section comment).  Where the
    logits' vocabulary cannot take 'model' (a ``seq_shard`` config's
    sequence holds it) the head enters whole."""
    sax = _sax(cfg)
    B, S = x.shape[:2]
    if cfg.n_codebooks:
        name, out_axes = "audio_heads", ("batch", None, sax, "vocab")
        out_shape = (B, cfg.n_codebooks, S, cfg.vocab)
    else:
        name = "embed" if cfg.tie_embeddings else "lm_head"
        out_axes, out_shape = ("batch", sax, "vocab"), (B, S, cfg.vocab)
    w = params[name]["w"] if name == "lm_head" else params[name]
    out_spec = rules.spec_for(out_axes, out_shape)
    w_spec = (pt.only_axes(pt.spec_of(w))
              if pt.sharded_over(out_spec, len(out_shape) - 1, rules.mesh)
              else pt.PartitionSpec())
    x_spec = rules.spec_for(("batch", sax, None), x.shape)

    def local_fn(x_l, w_l):
        if cfg.n_codebooks:
            logits = torch.einsum("bsd,kdv->bksv", x_l, w_l)
        elif cfg.tie_embeddings:
            logits = x_l @ w_l.T
        else:
            logits = common.apply_linear({"w": w_l}, x_l)
        return common.softcap(logits.to(F32), cfg.logit_softcap)

    return pt.shard_map(local_fn, rules.mesh, in_specs=(x_spec, w_spec),
                        out_specs=out_spec)(x, w)


def _run_stack(params: dict, cfg: ModelConfig, x: torch.Tensor,
               cache: dict, mode: str, positions=None, pos=None,
               active: torch.Tensor | None = None) -> torch.Tensor:
    """All layers in order, each starting from its slice of the cache and
    copying its new recurrent states into it (an attention layer has
    written its slot itself); prefill and decode, never under autograd.
    With ``active`` (B,) bool, a lane where it is False gets its old
    states copied back (``torch.where`` against the old row)."""
    for g in range(_n_groups(cfg)):
        for s in range(cfg.period):
            slot_p = _layer(params["blocks"][s], g)
            slot_c = _layer(cache["slots"][s], g)
            x, new, _ = _apply_block(slot_p, cfg, s, x, slot_c, positions,
                                     pos, mode, active)
            for name, state in new.items():
                if active is not None:
                    keep = active.reshape((-1,) + (1,) * (state.dim() - 1))
                    state = torch.where(keep, state, slot_c[name])
                slot_c[name].copy_(state)
    return common.apply_norm(params["final_norm"], x, cfg.norm)


# ---------------------------------------------------------------------------
# Entry points
# ---------------------------------------------------------------------------
def forward(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = False, inference: bool = False
            ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward, every layer from zero states, the states carried
    as values (differentiable).  ``batch`` as ``embed_inputs`` takes it (S
    counts the vision prefix).  Returns (logits (B,S,V) f32, with codebooks
    (B,K,S,V), aux): for a config with MoE layers ``moe_load_balance``,
    ``moe_z_loss`` and ``moe_drop_frac``, 0-d f32 tensors summed over the MoE
    layers, else an empty dict.  ``remat`` recomputes each layer group in the
    backward (``torch.utils.checkpoint``, the JAX package's ``jax.checkpoint``
    of its group function): only the groups' inputs are kept, and a group's
    forward runs twice per gradient. ``inference`` switches MoE layers to
    drop-free dispatch, so the logits are those the prefill and decode paths
    give.  Under autograd an attention layer's prefill plan ``flash_prefill``
    runs K8t forward and K8b backward (twice K8t with ``remat``: the
    recompute); a config the port cannot differentiate raises when autograd
    would record the call (``check_trainable``)."""
    mode = "infer" if inference else "full"
    if torch.is_grad_enabled() and any(
            t.requires_grad for t in tree_leaves(params)):
        check_trainable(cfg)
    x = embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    # the zero states and the aux sums, placed on a mesh of more than one
    # device (DTensors meet only DTensors)
    zeros = [{k: place(v, STATE_AXES[k]) for k, v in
              _zero_slot(cfg, s, B, x.device).items()}
             for s in range(cfg.period)]
    aux = {} if cfg.moe is None else {
        k: place(torch.zeros((), dtype=F32, device=x.device), ())
        for k in MOE_AUX}

    def group_fn(x, aux, group_p):
        for s, slot_p in enumerate(group_p):
            x, _, layer_aux = _apply_block(slot_p, cfg, s, x, zeros[s],
                                           positions, None, mode)
            if layer_aux is not None:
                aux = {k: aux[k] + layer_aux[k] for k in MOE_AUX}
        return x, aux

    # the backward's recompute runs under the rules of the forward
    rules = pt.active_rules()

    def recompute_context():
        return contextlib.nullcontext(), (pt.use_rules(rules) if rules
                                          else contextlib.nullcontext())

    slots = [_groups(p, _n_groups(cfg)) for p in params["blocks"]]
    for group_p in zip(*slots):
        x, aux = (checkpoint(group_fn, x, aux, group_p, use_reentrant=False,
                             context_fn=recompute_context)
                  if remat else group_fn(x, aux, group_p))
    x = common.apply_norm(params["final_norm"], x, cfg.norm)
    return lm_logits(params, cfg, x), aux


def prefill(params: dict, cfg: ModelConfig, cache: dict, batch: dict
            ) -> tuple[torch.Tensor, dict]:
    """Full-sequence forward that fills the decode cache in place; a vision
    prefix takes the first n_vis positions, so ``pos`` ends at n_vis + S.

    Returns (logits of the LAST position (B,1,V) f32, with codebooks
    (B,K,1,V), the same cache)."""
    x = embed_inputs(params, cfg, batch)
    B, S = x.shape[:2]
    positions = torch.arange(S, device=x.device).expand(B, S)
    x = _run_stack(params, cfg, x, cache, "prefill", positions=positions)
    cache["pos"].fill_(S)
    # a sequence split over 'model' is gathered before the last token is
    # taken (the identity on one device and for an unsplit sequence)
    x = constrain(x, ("batch", None, None))
    return lm_logits(params, cfg, x[:, -1:]), cache


def prefill_chunk(params: dict, cfg: ModelConfig, cache: dict,
                  batch: dict) -> tuple[torch.Tensor, dict]:
    """One prefill chunk, in place: a (B, L) prompt slice continuing at
    absolute position ``cache['pos']`` (a 0-d device tensor, read on the
    device: one code path serves every chunk of every prompt).

    Attention writes the chunk's k/v into the cache and attends the full
    cache under a content-position mask
    (attention.chunk_prefill_attention); rwkv/mamba consume the cache as
    their incoming recurrent state — for them a chunk is just a shorter
    ``prefill`` starting from carried state, with positions ``pos +
    arange(L)``.  Returns (logits of the chunk's LAST position (B,1,V)
    f32, with codebooks (B,K,1,V), the same cache with ``pos += L``).
    Not for vision prompts, as in the JAX package: the vision prefix is
    prepended whole at embed time and cannot be sliced into chunks (the
    slot engine refuses chunked admission for them)."""
    x = embed_inputs(params, cfg, batch)
    B, L = x.shape[:2]
    base = cache["pos"]
    positions = base + torch.arange(L, device=x.device).expand(B, L)
    x = _run_stack(params, cfg, x, cache, "prefill_chunk",
                   positions=positions)
    cache["pos"].add_(L)
    return lm_logits(params, cfg, x[:, -1:]), cache


def decode_step(params: dict, cfg: ModelConfig, cache: dict, batch: dict
                ) -> tuple[torch.Tensor, dict]:
    """One decode step, in place.  batch['tokens']: (B,), with codebooks (B,
    K).  ``cache['pos']`` is a 0-d tensor (the wave engine's lockstep lanes) or
    (B,) per lane (the slot engine's).  With ``batch['active']`` (B,) bool
    (per-lane pos only), a lane where it is False is a no-op: its recurrent
    states, its attention rows and its ``pos`` stay bit for bit what they were,
    and its logits are garbage the caller ignores.  Returns (logits (B,V) f32,
    with codebooks (B,K,V), the same cache)."""
    active = batch.get("active")
    x = embed_inputs(params, cfg, {"tokens": batch["tokens"][..., None]})
    x = _run_stack(params, cfg, x, cache, "decode", pos=cache["pos"],
                   active=active)
    if active is None:
        cache["pos"].add_(1)
    else:
        cache["pos"].copy_(torch.where(active, cache["pos"] + 1,
                                       cache["pos"]))
    return lm_logits(params, cfg, x)[..., 0, :], cache
