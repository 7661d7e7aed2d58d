"""Top-k mixture-of-experts with capacity-based dense dispatch (the port's
twin of the JAX package's ``models/moe.py``, its single-device path).

Dispatch, as the JAX package's ``_apply_moe_dense`` does it, with fixed
shapes only:
  1. router: softmax(x @ Wr) -> top-k (expert ids, weights) per token,
     renormalised
  2. position-in-expert by a cumsum of one-hot rows over the flattened
     token-major (T*K,) slots
  3. scatter token vectors into a zeroed (E+1, C, d) buffer; row E is the
     drop bin (C = capacity; slots past it are dropped, the GShard rule)
  4. batched expert products (E, C, d) x (E, d, ff) (``torch.bmm``: plain
     large products, which the JAX package leaves to XLA outside Pallas)
  5. gather each slot's row back by index and combine with its weight

No step reads a device value on the host or makes a tensor whose shape
depends on the data (no ``nonzero``, boolean indexing, ``.item()`` or
``repeat_interleave``): the one-hot is a comparison with ``arange(E)``, the
scatter an ``index_put`` on integer indices, the combine a gather by index,
so a decode step with MoE layers can be captured in a CUDA graph
(serving/tick.py).  The combine gathers rows rather than multiplying a
one-hot dispatch mask into the expert outputs: NaN x 0 is NaN, so a mask
product would spread one lane's NaN to every lane, where a gather leaves
each token's output a function of its own rows.

``no_drop`` (C = T) is the inference paths' setting: a token takes at most
one slot of an expert, nothing drops and every kept (expert, slot) pair is
distinct, so the scatter is deterministic and decode equals the forward.
Training keeps the capacity bound; its dropped slots all land in row E,
whose contents are discarded.

On a mesh of more than one device whose 'model' axis divides the experts
(``partitioning.use_rules`` over a process group), a (B, S, d) input takes
the JAX package's expert-parallel path (``_apply_moe_ep``, a
``partitioning.shard_map``): each rank routes its batch shard's tokens
into its own E/m experts in the same fixed-shape forms, and the partial
outputs are combined with one ``psum`` over 'model', taken in the model
dtype.  The dense path marks the expert buffer and the output with
``partitioning.constrain``, as the JAX package does; on one device that
is the identity.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import partitioning as pt
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.partitioning import constrain, dense_init, split

F32 = torch.float32


def init_moe_annot(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, device="cpu") -> dict:
    """``{"router": (d, E), "wd": (E, ff, d)}`` plus ``"wg", "wu": (E, d,
    ff)`` for SwiGLU or ``"wi": (E, d, ff)`` for GELU, in the JAX layouts,
    scales (truncated normal times d^-1/2, ff^-1/2 for ``wd``) and logical
    axes, drawn in the order router, wg (wi), wu, wd."""
    moe = cfg.moe
    d, e, ff = cfg.d_model, moe.n_experts, moe.d_ff

    def w(shape, axes, scale):
        return dense_init(gen, shape, axes, dtype, device, scale)

    # router is tiny and every shard routes locally: keep it replicated
    p = {"router": w((d, e), ("embed_nofsdp", None), d ** -0.5)}
    if cfg.mlp_act == "swiglu":
        p["wg"] = w((e, d, ff), ("experts", None, "mlp"), d ** -0.5)
        p["wu"] = w((e, d, ff), ("experts", None, "mlp"), d ** -0.5)
    else:
        p["wi"] = w((e, d, ff), ("experts", None, "mlp"), d ** -0.5)
    p["wd"] = w((e, ff, d), ("experts", "mlp", None), ff ** -0.5)
    return p


def init_moe(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device="cpu") -> dict:
    """``init_moe_annot``'s plain tensors."""
    return split(init_moe_annot(gen, cfg, dtype, device))[0]


def capacity(n_tokens: int, cfg: ModelConfig) -> int:
    """Slots an expert holds for ``n_tokens`` tokens: capacity_factor x
    T x K / E, at least K."""
    moe = cfg.moe
    c = int(moe.capacity_factor * n_tokens * moe.top_k / moe.n_experts)
    return max(c, moe.top_k)


def route(router: torch.Tensor, xt: torch.Tensor, cfg: ModelConfig
          ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The router on tokens ``xt`` (T, d): (logits (T, E) f32, probs,
    top_p (T, K) renormalised, top_e (T, K) int64), as the JAX package
    routes.  The product runs in the model dtype and is widened after (in
    bf16 a product in f32 would flip near-tied experts); the top k are
    taken by a stable sort, so tied probabilities go to the lower expert
    index, as ``lax.top_k`` breaks ties."""
    logits = (xt @ router).to(F32)
    probs = torch.softmax(logits, dim=-1)
    ranked, order = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = ranked[:, :cfg.moe.top_k], order[:, :cfg.moe.top_k]
    return logits, probs, top_p / top_p.sum(-1, keepdim=True), top_e


def apply_moe(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
              no_drop: bool = False) -> tuple[torch.Tensor, dict]:
    """x: (..., d) -> (the same shape and dtype, aux).  ``aux`` holds 0-d
    f32 tensors: ``moe_load_balance`` (switch style, E x sum of mean router
    probability times top-1 share), ``moe_z_loss`` (mean squared
    logsumexp of the router logits) and ``moe_drop_frac`` (the share of
    the T x K slots dropped).  Tokens are routed by ``route``.

    As in the JAX package, under ``use_rules`` with a 'model' axis m > 1
    that divides the experts, a (B, S, d) input takes the expert-parallel
    path (``_apply_moe_ep``); otherwise the dense dispatch
    (``_apply_moe_dense``)."""
    rules = pt.active_rules()
    if rules is not None:
        m = rules.mesh.shape.get("model", 1)
        if m > 1 and cfg.moe.n_experts % m == 0 and x.ndim == 3:
            return _apply_moe_ep(p, x, cfg, rules, no_drop)
        return _apply_moe_dense_sharded(p, x, cfg, rules, no_drop)
    return _apply_moe_dense(p, x, cfg, no_drop)


def _apply_moe_dense_sharded(p: dict, x: torch.Tensor, cfg: ModelConfig,
                             rules, no_drop: bool
                             ) -> tuple[torch.Tensor, dict]:
    """The dense dispatch on DTensors, where 'model' does not split the
    experts: a ``shard_map`` body on each rank's batch shard with every
    weight whole (gathered on entry), capacity per data shard as on the
    expert-parallel path, the aux losses averaged over the batch axes."""
    batch_axes = tuple(a for a in ("pod", "data") if a in rules.mesh.shape)
    x_spec = rules.spec_for(("batch",) + (None,) * (x.dim() - 1), x.shape)
    p_specs = {k: pt.PartitionSpec() for k in p}
    aux_spec = {k: pt.PartitionSpec() for k in
                ("moe_load_balance", "moe_z_loss", "moe_drop_frac")}

    def local_fn(x_l, p_l):
        out, aux = _apply_moe_dense(p_l, x_l, cfg, no_drop)
        vals = torch.stack([aux[k] for k in aux_spec])
        if batch_axes:
            vals = pt.pmean(vals, batch_axes)
        return out, dict(zip(aux_spec, vals.unbind(0)))

    fn = pt.shard_map(local_fn, rules.mesh, in_specs=(x_spec, p_specs),
                      out_specs=(x_spec, aux_spec))
    return tuple(fn(x, p))


def _experts(p: dict, expert_in: torch.Tensor) -> torch.Tensor:
    """The batched expert MLPs: (E, C, d) -> (E, C, d)."""
    if "wg" in p:
        h = F.silu(torch.bmm(expert_in, p["wg"])) * torch.bmm(expert_in,
                                                              p["wu"])
    else:
        h = common.gelu(torch.bmm(expert_in, p["wi"]))
    return torch.bmm(h, p["wd"])


def _apply_moe_dense(p: dict, x: torch.Tensor, cfg: ModelConfig,
                     no_drop: bool) -> tuple[torch.Tensor, dict]:
    """The JAX package's dense dispatch on one device."""
    moe = cfg.moe
    shape = x.shape
    d = shape[-1]
    xt = x.reshape(-1, d)                       # batch-major tokens (T, d)
    T = xt.shape[0]
    E, K = moe.n_experts, moe.top_k
    C = T if no_drop else capacity(T, cfg)

    logits, probs, top_p, top_e = route(p["router"], xt, cfg)

    # --- position-in-expert over the token-major (T*K,) slots -------------
    flat_e = top_e.reshape(-1)
    onehot = (flat_e[:, None] == torch.arange(E, device=x.device)).long()
    before = torch.cumsum(onehot, dim=0) - onehot               # before me
    pos = torch.gather(before, 1, flat_e[:, None])[:, 0]        # (T*K,)
    keep = pos < C
    dst_e = torch.where(keep, flat_e, E)                        # drop -> row E
    dst_c = torch.where(keep, pos, 0)

    # --- scatter to (E+1, C, d) -------------------------------------------
    xk = xt[:, None, :].expand(T, K, d).reshape(T * K, d)
    buf = xt.new_zeros(E + 1, C, d).index_put((dst_e, dst_c), xk)
    expert_in = constrain(buf[:E], ("experts", None, None))     # (E, C, d)

    # --- the experts, batched ---------------------------------------------
    expert_out = _experts(p, expert_in)                         # (E, C, d)

    # --- gather back and combine ------------------------------------------
    out_k = expert_out[dst_e % E, dst_c]                        # (T*K, d)
    out_k = out_k * keep[:, None].to(out_k.dtype)
    out_k = out_k * top_p.reshape(-1)[:, None].to(out_k.dtype)
    out = out_k.reshape(T, K, d).sum(1)
    if len(shape) == 3:
        out = constrain(out.reshape(shape), ("batch", "seq", None)
                        ).reshape(T, d)

    # --- aux losses (switch-transformer style) ----------------------------
    me = probs.mean(0)                                          # (E,)
    ce = (top_e[:, :1] == torch.arange(E, device=x.device)).to(F32).mean(0)
    aux = {"moe_load_balance": E * torch.sum(me * ce),
           "moe_z_loss": torch.square(torch.logsumexp(logits, -1)).mean(),
           "moe_drop_frac": 1.0 - keep.to(F32).mean()}
    return out.reshape(shape).to(x.dtype), aux


# ---------------------------------------------------------------------------
# Expert-parallel shard_map path (the JAX package's ``_apply_moe_ep``).
#
# Layout: token activations are batch-sharded over ('pod', 'data') and
# REPLICATED over 'model'; the expert weights are sharded over 'model'
# (E_loc = E / m experts a rank).  Every rank routes its local tokens,
# scatters the slots bound for ITS experts into a local (E_loc + 1, C, d)
# buffer (no traffic for the dispatch: the tokens are already there), runs
# its expert products, and the partial outputs are combined with ONE psum
# over 'model' a layer, in the model dtype (the JAX package pins it there
# with ``_dtype_pin``: an f32 combine would send twice the bytes).
# Capacity is enforced per data shard (C = cf x T_loc x K / E).
# ---------------------------------------------------------------------------
def _apply_moe_ep(p: dict, x: torch.Tensor, cfg: ModelConfig, rules,
                  no_drop: bool) -> tuple[torch.Tensor, dict]:
    mesh = rules.mesh
    moe = cfg.moe
    E, K = moe.n_experts, moe.top_k
    E_loc = E // mesh.shape["model"]
    batch_axes = tuple(a for a in ("pod", "data") if a in mesh.shape)

    x_spec = rules.spec_for(("batch", "seq", None), x.shape)
    p_specs = {k: pt.PartitionSpec() if k == "router"
               else pt.PartitionSpec("model", None, None) for k in p}
    aux_spec = {k: pt.PartitionSpec() for k in
                ("moe_load_balance", "moe_z_loss", "moe_drop_frac")}

    def local_fn(x_loc, p_loc):
        B, S, d = x_loc.shape
        xt = x_loc.reshape(-1, d)
        T = xt.shape[0]
        C = T if no_drop else capacity(T, cfg)
        logits, probs, top_p, top_e = route(p_loc["router"], xt, cfg)

        # --- the slots bound for this rank's experts ----------------------
        lo = pt.axis_index("model") * E_loc
        flat_e = top_e.reshape(-1)
        is_local = (flat_e >= lo) & (flat_e < lo + E_loc)
        local_e = torch.where(is_local, flat_e - lo, E_loc)
        onehot = (local_e[:, None]
                  == torch.arange(E_loc, device=x_loc.device)).long()
        pos = ((torch.cumsum(onehot, dim=0) - onehot) * onehot).sum(-1)
        kept = is_local & (pos < C)
        dst_e = torch.where(kept, local_e, E_loc)               # else drop bin
        dst_c = torch.where(kept, pos, 0)

        xk = xt[:, None, :].expand(T, K, d).reshape(T * K, d)
        buf = xt.new_zeros(E_loc + 1, C, d).index_put((dst_e, dst_c), xk)
        expert_out = _experts(p_loc, buf[:E_loc])

        out_k = expert_out[torch.clamp(dst_e, max=E_loc - 1), dst_c]
        out_k = out_k * kept[:, None].to(out_k.dtype)
        out_k = out_k * top_p.reshape(-1)[:, None].to(out_k.dtype)
        partial = out_k.reshape(T, K, d).sum(1).to(x_loc.dtype)
        out = pt.psum(partial, "model")                 # combine experts

        me = probs.mean(0)
        ce = (top_e[:, :1] == torch.arange(E, device=x_loc.device)
              ).to(F32).mean(0)
        dropped = pt.psum((is_local & ~kept).sum().to(F32), "model")
        aux = torch.stack([
            E * torch.sum(me * ce),
            torch.square(torch.logsumexp(logits, -1)).mean(),
            dropped / (T * K)])
        if batch_axes:
            aux = pt.pmean(aux, batch_axes)
        return out.reshape(B, S, d), dict(zip(aux_spec, aux.unbind(0)))

    fn = pt.shard_map(local_fn, mesh, in_specs=(x_spec, p_specs),
                      out_specs=(x_spec, aux_spec))
    return tuple(fn(x, p))
