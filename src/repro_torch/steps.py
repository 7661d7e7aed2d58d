"""Step functions shared by training, serving and the smoke runs (the
port's twin of the JAX package's ``steps.py``, for the dense attention,
rwkv6 and mamba paths: a config with MoE layers, audio codebooks or vision
tokens raises, as ``models/transformer`` does, and ``loss_fn`` raises for
a config with attention layers, whose training is not ported).  All take the plain parameter and cache
trees; the cache is updated in place, and ``train_step`` updates the
parameters and the optimizer state in place (the JAX package donates them
to its jits for the same effect)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer
from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map


def _xent(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy; logits (..., V) f32, targets (...) int."""
    logp = F.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0].mean()


def loss_fn(params: dict, cfg: ModelConfig, batch: dict, *,
            remat: bool = True) -> tuple[torch.Tensor, dict]:
    """Next-token cross-entropy of ``transformer.forward`` (``remat`` as
    there; on by default, as in the JAX package).  Returns (loss,
    metrics)."""
    transformer.check_trainable(cfg)
    logits, _ = transformer.forward(params, cfg, batch, remat=remat)
    toks = batch["tokens"]
    loss = _xent(logits[:, :-1], toks[:, 1:])
    return loss, {"xent": loss, "loss": loss}


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


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict
                ) -> tuple[torch.Tensor, dict]:
    return transformer.decode_step(params, cfg, cache, batch)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
