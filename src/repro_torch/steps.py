"""Step functions shared by training, serving and the smoke runs (the
port's twin of the JAX package's ``steps.py``, for the dense attention,
rwkv6, mamba and MoE paths and the vision and audio fronts; ``loss_fn``
differentiates every config ``models/transformer`` builds, attention
through the kernels K8t and K8b).  All take
the plain parameter and cache trees; the cache is updated in place, and
``train_step`` updates the parameters and the optimizer state in place
(the JAX package donates them to its jits for the same effect).

The serving steps of the slot engine keep the JAX contract: after
``masked_decode_step`` an inactive lane's cache and ``pos`` are bit for
bit what they were.  Because the port writes in place (recurrent states
by ``copy_``, attention rows at each lane's slot), the lane select runs
inside ``transformer.decode_step``, on every in-place write, with
``torch.where`` against the old row: no boolean indexing and no host
read, so the whole guarded tick can be captured in a CUDA graph
(serving/tick.py)."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch import partitioning as pt
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) f32, targets (...) int."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0].mean()


def _targets(toks: torch.Tensor, cfg: ModelConfig, seq_len: int
             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Each logits position's target token and whether it has one
    (``loss_fn``'s pairing) over a whole sequence of ``seq_len``
    positions: the next token (audio: of each codebook), or with a vision
    prefix text token i at position n_vis - 1 + i."""
    if cfg.n_vis_tokens and not cfg.n_codebooks:
        nv = cfg.n_vis_tokens
        tgt = F.pad(toks, (nv - 1, seq_len - nv + 1 - toks.shape[-1]))
        pos = torch.arange(seq_len, device=toks.device)
        return tgt, (pos >= nv - 1) & (pos < nv - 1 + toks.shape[-1])
    tgt = F.pad(toks[..., 1:], (0, 1))
    return tgt, torch.arange(seq_len, device=toks.device) < seq_len - 1


def _xent_sharded(logits: torch.Tensor, toks: torch.Tensor,
                  cfg: ModelConfig, rules) -> torch.Tensor:
    """``_xent`` of ``loss_fn``'s pairs on DTensors, a ``shard_map`` body:
    the tokens enter with their sequence whole (each rank pairs its own
    logits positions), a vocabulary split over 'model' takes its
    log-sum-exp and target logit by psums over 'model' (the maximum by
    pmax), and the sum of the losses over every rank's positions, divided
    by their count, is the mean."""
    sax = transformer._sax(cfg)
    audio = bool(cfg.n_codebooks)
    l_axes = ("batch", None, sax, "vocab") if audio else ("batch", sax,
                                                          "vocab")
    l_spec = rules.spec_for(l_axes, logits.shape)
    t_spec = rules.spec_for(("batch",) + (None,) * (toks.dim() - 1),
                            toks.shape)
    vocab_split = pt.sharded_over(l_spec, logits.dim() - 1, rules.mesh)
    seq_split = pt.sharded_over(l_spec, logits.dim() - 2, rules.mesh)
    S = logits.shape[-2]
    count = math.prod(logits.shape[:-2]) * (
        toks.shape[-1] if cfg.n_vis_tokens and not audio else S - 1)
    batch_axes = tuple(a for a in ("pod", "data") if a in rules.mesh.shape)

    def local_fn(l_l, toks_l):
        tgt, has = _targets(toks_l.long(), cfg, S)
        if seq_split:
            n = l_l.shape[-2]
            lo = pt.axis_index("model") * n
            tgt, has = tgt[..., lo:lo + n], has[lo:lo + n]
        if vocab_split:
            n = l_l.shape[-1]
            mx = pt.pmax(l_l.amax(-1), "model")
            lse = torch.log(pt.psum(torch.exp(l_l - mx[..., None]).sum(-1),
                                    "model")) + mx
            i = tgt - pt.axis_index("model") * n
            mine = (i >= 0) & (i < n)
            picked = torch.gather(l_l, -1,
                                  i.clamp(0, n - 1)[..., None])[..., 0]
            nll = lse - pt.psum(torch.where(mine, picked, 0.0), "model")
        else:
            logp = F.log_softmax(l_l, dim=-1)
            nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        total = torch.where(has, nll, 0.0).sum()
        axes = batch_axes + (("model",) if seq_split else ())
        return (pt.psum(total, axes) if axes else total) / count

    return pt.shard_map(local_fn, rules.mesh, in_specs=(l_spec, t_spec),
                        out_specs=pt.PartitionSpec())(logits, toks)


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy of ``transformer.forward`` (``remat`` as there;
    on by default, as in the JAX package), with the JAX package's targets:
    audio codebooks, logits (B, K, S, V), each codebook's next token
    (``logits[:, :, :-1]`` against ``tokens[:, :, 1:]``); vision, the layout
    ``[vis | text]``, position n_vis - 1 + i predicting text token i
    (``logits[:, n_vis-1:-1]`` against ``tokens``); text, the next token.  Plus
    for a config with MoE layers ``router_aux_weight`` x (load balance + 0.1 x
    z loss), each aux averaged over the MoE layers.  Returns (loss, metrics):
    ``xent``, ``loss`` and for MoE the three averaged aux values."""
    transformer.check_trainable(cfg)
    logits, aux = transformer.forward(params, cfg, batch, remat=remat)
    toks = batch["tokens"]
    rules = pt.active_rules()
    if rules is not None:
        loss = _xent_sharded(logits, toks, cfg, rules)
    elif cfg.n_codebooks:
        loss = _xent(logits[:, :, :-1], toks[:, :, 1:])
    elif cfg.n_vis_tokens:
        nv = cfg.n_vis_tokens
        loss = _xent(logits[:, nv - 1:-1], toks)
    else:
        loss = _xent(logits[:, :-1], toks[:, 1:])
    metrics = {"xent": loss}
    if cfg.moe is not None:
        n_moe = max(sum(cfg.layer_is_moe(i) for i in range(cfg.n_layers)), 1)
        lb = aux["moe_load_balance"] / n_moe
        zl = aux["moe_z_loss"] / n_moe
        loss = loss + cfg.moe.router_aux_weight * (lb + 0.1 * zl)
        metrics.update(moe_load_balance=lb, moe_z_loss=zl,
                       moe_drop_frac=aux["moe_drop_frac"] / n_moe)
    metrics["loss"] = loss
    return loss, metrics


def train_step(optimizer: AdamW, cfg: ModelConfig, params: dict,
               opt_state: dict, batch: dict) -> tuple[dict, dict, dict]:
    """One AdamW step: the loss, the gradients of every parameter by
    autograd (the parameter leaves must require grad) and the update,
    written into ``params`` and ``opt_state`` in place.  Returns (params,
    opt_state, metrics), the same trees."""
    loss, metrics = loss_fn(params, cfg, batch)
    leaves = tree_leaves(params)
    flat = iter(torch.autograd.grad(loss, leaves))
    grads = tree_map(lambda _: next(flat), params)
    metrics = {k: v.detach() for k, v in metrics.items()}
    # a named span for torch.profiler: the optimizer's kernels on the device
    with torch.profiler.record_function("adamw.update_"):
        metrics.update(optimizer.update_(grads, opt_state, params))
    return params, opt_state, metrics


def eval_step(cfg: ModelConfig, params: dict, batch: dict) -> dict:
    """The metrics of ``loss_fn`` with no gradient (no remat)."""
    with torch.no_grad():
        _, metrics = loss_fn(params, cfg, batch, remat=False)
    return metrics


def prefill_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict
                 ) -> tuple[torch.Tensor, dict]:
    return transformer.prefill(params, cfg, cache, batch)


def chunked_prefill_step(cfg: ModelConfig, params: dict, cache: dict,
                         batch: dict) -> tuple[torch.Tensor, dict]:
    """One admission-prefill chunk (transformer.prefill_chunk):
    ``batch['tokens']`` is a (B, L) prompt slice whose absolute start is
    the device tensor ``cache['pos']``."""
    return transformer.prefill_chunk(params, cfg, cache, batch)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict
                ) -> tuple[torch.Tensor, dict]:
    return transformer.decode_step(params, cfg, cache, batch)


def masked_decode_step(cfg: ModelConfig, params: dict, cache: dict,
                       batch: dict, step_fn=None
                       ) -> tuple[torch.Tensor, dict]:
    """One fused decode tick across B slots honouring a per-slot active
    mask.

    ``batch['active']`` is a (B,) bool mask; ``cache['pos']`` must be the
    per-lane (B,) vector form.  Inactive lanes (free slots, finished
    requests) still ride through the fixed-shape computation — ONE step
    per tick regardless of occupancy — but their cache rows and position
    counters are written back unchanged, so a dead lane is a no-op and its
    logits are garbage the caller must ignore.  ``step_fn`` (default
    ``decode_step``) receives the batch WITH its ``active`` mask and must
    honour it as ``transformer.decode_step`` does: in the port the select
    guards the in-place writes themselves, so it cannot be applied to a
    step's results afterwards.  Returns (logits, the same cache)."""
    if batch["active"].shape != cache["pos"].shape:
        raise ValueError(f"masked_decode_step takes the per-lane (B,) pos; "
                         f"got pos {tuple(cache['pos'].shape)}, active "
                         f"{tuple(batch['active'].shape)}")
    step = step_fn or decode_step
    return step(cfg, params, cache, batch)


def guarded_decode_step(cfg: ModelConfig, params: dict, cache: dict,
                        batch: dict, step_fn=None
                        ) -> tuple[torch.Tensor, torch.Tensor, dict]:
    """``masked_decode_step`` plus the per-lane finite guard — the serving
    fault path's device half, inside the same tick (one extra reduction,
    no extra launch of the model, no shape change, nothing read on the
    host).

    ``batch['poison']`` is an optional (B,) bool fault-injection hook
    (serving/faults.FaultPlan): poisoned lanes' logits are overwritten with
    NaN inside the tick, exercising exactly the guard a genuinely
    non-finite lane would trip.  Returns ``(logits, lane_ok, cache)``
    where ``lane_ok`` is (B,) bool — False iff an ACTIVE lane produced
    non-finite logits this tick.  With an all-False poison mask the logits
    are bit-identical to the unguarded tick."""
    active = batch["active"]
    poison = batch.get("poison")
    logits, cache = masked_decode_step(
        cfg, params, cache, {k: v for k, v in batch.items() if k != "poison"},
        step_fn=step_fn)
    if poison is not None:
        m = poison.reshape((-1,) + (1,) * (logits.dim() - 1))
        logits = torch.where(m, float("nan"), logits)
    finite = torch.isfinite(logits).flatten(1).all(dim=1)
    return logits, finite | ~active, cache


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
