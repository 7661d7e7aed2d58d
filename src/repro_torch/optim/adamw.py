"""AdamW with decoupled weight decay, f32 moments and global-norm gradient
clipping — the JAX package's ``optim/adamw.py``, as plain functions on
tensors.

Not ``torch.optim.AdamW``: its defaults (b2 0.999, decay 0.01 coupled to
the learning rate differently) and the absence of clipping would change the
trajectory the port is held to.  Parameters and gradients are plain
parameter trees (dicts and lists of tensors: ``core/lstm``'s, the language
models'); moments are f32 whatever the parameter dtype, the update is
computed in f32 and cast back.  ``update_`` writes the JAX package's
numbers into the parameters and moments in place, one leaf at a time
(the JAX package returns new trees and donates the old ones to its jit),
so that a step of a model of billions of parameters holds one leaf's f32
temporaries at a time and no second copy of the moments.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch import partitioning as pt

F32 = torch.float32


def tree_map(fn: Callable, tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` (and the same leaves of
    ``rest``), keeping its dicts and lists; leaves are visited in
    ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    if isinstance(tree, (list, tuple)):
        return [tree_map(fn, t, *(r[i] for r in rest))
                for i, t in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The leaves in the JAX package's order (dict keys sorted)."""
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [leaf for t in tree for leaf in tree_leaves(t)]
    return [tree]


@dataclasses.dataclass(frozen=True)
class AdamW:
    lr: Callable[[torch.Tensor], torch.Tensor] | float = 1e-3
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0

    def init(self, params: Any) -> dict:
        """Zero f32 moments shaped and placed as the parameters (a DTensor
        parameter's moments are DTensors of its placements: JAX's
        ``{"mu": p_shard, "nu": p_shard}``), and ``step`` 0."""
        zeros = lambda p: torch.zeros_like(p, dtype=F32,
                                           requires_grad=False)
        return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
                "step": 0}

    def _lr(self, step: torch.Tensor) -> torch.Tensor:
        if callable(self.lr):
            return self.lr(step)
        return torch.tensor(self.lr, dtype=F32)

    @torch.no_grad()
    def update_(self, grads: Any, state: dict, params: Any) -> dict:
        """One step, in place: each parameter and its moments are
        overwritten leaf by leaf, and ``state["step"]`` advances.  Returns
        the metrics: the global gradient norm before clipping
        (``grad_norm``) and ``lr``."""
        step_f = torch.tensor(state["step"] + 1, dtype=F32)
        leaves = tree_leaves(params)
        gleaves = [pt.match_placements(g, p)
                   for g, p in zip(tree_leaves(grads), leaves)]
        gnorm = global_norm(gleaves)
        scale = torch.clamp(self.grad_clip / (gnorm + 1e-9), max=1.0)
        bc1 = 1 - torch.pow(torch.tensor(self.b1, dtype=F32), step_f)
        bc2 = 1 - torch.pow(torch.tensor(self.b2, dtype=F32), step_f)
        lr = self._lr(step_f)
        for p, g, m, n in zip(leaves, gleaves, tree_leaves(state["mu"]),
                              tree_leaves(state["nu"])):
            # a DTensor leaf's four tensors share its placements: the
            # update is elementwise on this rank's shards
            p, g, m, n = (_local(t) for t in (p, g, m, n))
            # m = b1 m + (1 - b1) g, n = b2 n + (1 - b2) g g,
            # u = m / bc1 / (sqrt(n / bc2) + eps) + wd p, p = p - lr u:
            # each product and sum rounded as written out of place, but in
            # place, so that at most two f32 temporaries of the leaf live at
            # once (a 256,000 x 8,192 embedding's are 8.4 GB each)
            g32 = g.to(F32, copy=True)
            if self.grad_clip:
                g32.mul_(scale)
            m.mul_(self.b1).add_(g32 * (1 - self.b1))
            n.mul_(self.b2).add_((g32 * (1 - self.b2)).mul_(g32))
            del g32
            den = (n / bc2).sqrt_().add_(self.eps)
            u = (m / bc1).div_(den)
            del den
            u.add_(p.to(F32, copy=True).mul_(self.weight_decay))
            p.copy_(p.to(F32, copy=True).sub_(u.mul_(lr)))
        state["step"] += 1
        return {"grad_norm": gnorm, "lr": lr}


def _local(t: torch.Tensor) -> torch.Tensor:
    """A DTensor's rank-local shard (written in place, it is the
    DTensor's); a plain tensor itself."""
    return t.to_local() if hasattr(t, "to_local") else t


def global_norm(leaves: list[torch.Tensor]) -> torch.Tensor:
    """The f32 norm of all the leaves together.  Plain tensors: the square
    root of the sum of their squared sums.  DTensors (a mesh of more than
    one device): each rank's local sums, each divided by the ranks that
    hold a copy of its leaf, summed over every rank by one all-reduce, so
    every element counts once; the result is this rank's plain 0-d
    tensor, the same on every rank."""
    from torch.distributed.tensor import DTensor

    if not any(isinstance(g, DTensor) for g in leaves):
        return torch.sqrt(sum(torch.sum(torch.square(g.to(F32)))
                              for g in leaves))
    local = sum(torch.sum(torch.square(g.to_local().to(F32)))
                / pt.replicas(g) for g in leaves)
    return torch.sqrt(pt.world_sum(local))


def warmup_cosine(peak_lr: float, warmup: int, total: int,
                  floor: float = 0.1) -> Callable[[torch.Tensor],
                                                  torch.Tensor]:
    """Linear warmup to ``peak_lr`` over ``warmup`` steps, then a cosine
    decay to ``floor * peak_lr`` at ``total``; f32 in, f32 out."""
    def fn(step: torch.Tensor) -> torch.Tensor:
        step = step.to(F32)
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1),
                           0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5
                         * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)
    return fn
