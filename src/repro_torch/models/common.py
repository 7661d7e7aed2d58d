"""Shared model components: norms, linear and embedding initializers and
rotary position embeddings (the port's twin of the JAX package's
``models/common.py``).

Initializers draw from an explicit ``torch.Generator`` on an explicit
device.  Each ``*_annot`` initializer returns ``partitioning.Annot`` leaves
(tensor + logical sharding axes, the JAX package's axes); its plain twin
is ``partitioning.split`` of it, the same draw.  On the ``meta`` device
nothing is drawn or allocated (abstract trees).  Apply functions take
plain tensors and compute numerically sensitive ops (norms) in float32 and
cast back to the input dtype, as the JAX package does.
"""
from __future__ import annotations

import torch

from repro_torch.partitioning import (dense_init, ones_init, split,
                                      zeros_init)

F32 = torch.float32


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm_annot(d: int, kind: str, dtype: torch.dtype,
                    device="cpu") -> dict:
    p = {"scale": ones_init((d,), ("embed_nofsdp",), dtype, device)}
    if kind == "ln":
        p["bias"] = zeros_init((d,), ("embed_nofsdp",), dtype, device)
    return p


def init_norm(d: int, kind: str, dtype: torch.dtype, device="cpu") -> dict:
    return split(init_norm_annot(d, kind, dtype, device))[0]


def apply_norm(p: dict, x: torch.Tensor, kind: str, eps: float = 1e-5
               ) -> torch.Tensor:
    x32 = x.to(F32)
    if kind == "rms":
        x32 = x32 * torch.rsqrt(torch.mean(x32 * x32, -1, keepdim=True) + eps)
        out = x32 * p["scale"].to(F32)
    elif kind == "ln":
        mu = torch.mean(x32, -1, keepdim=True)
        var = torch.mean(torch.square(x32 - mu), -1, keepdim=True)
        out = (x32 - mu) * torch.rsqrt(var + eps)
        out = out * p["scale"].to(F32) + p["bias"].to(F32)
    else:
        raise ValueError(kind)
    return out.to(x.dtype)


def init_groupnorm_annot(n_groups: int, d: int, dtype: torch.dtype,
                         device="cpu") -> dict:
    del n_groups
    return {"scale": ones_init((d,), ("embed_nofsdp",), dtype, device),
            "bias": zeros_init((d,), ("embed_nofsdp",), dtype, device)}


def apply_groupnorm(p: dict, x: torch.Tensor, n_groups: int,
                    eps: float = 1e-5) -> torch.Tensor:
    """GroupNorm over the last dim split into n_groups (RWKV head-norm)."""
    *lead, d = x.shape
    x32 = x.to(F32).reshape(*lead, n_groups, d // n_groups)
    mu = torch.mean(x32, -1, keepdim=True)
    var = torch.mean(torch.square(x32 - mu), -1, keepdim=True)
    x32 = ((x32 - mu) * torch.rsqrt(var + eps)).reshape(*lead, d)
    out = x32 * p["scale"].to(F32) + p["bias"].to(F32)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Gates
# ---------------------------------------------------------------------------
class _Sigmoid(torch.autograd.Function):
    """The bf16 ``jax.nn.sigmoid`` with its own backward: autograd through
    1 / (1 + exp(-x)) would give inf x 0 = NaN where exp(-x) overflows."""

    @staticmethod
    def forward(ctx, x):
        y = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(y)
        return y

    @staticmethod
    def backward(ctx, g):
        # JAX's logistic JVP, g * (y * (1 - y)), each step in y's dtype
        (y,) = ctx.saved_tensors
        return g * (y * (1 - y))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid`` as the JAX package's compiled graph rounds it.  In
    bf16, XLA expands it to 1 / (1 + exp(-x)) and rounds each of the four
    steps to bf16; ``torch.sigmoid`` would round once.  Its gradient is
    JAX's, g * (y * (1 - y)), finite where exp(-x) overflows.  In f32 the
    fused op."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.sigmoid(x)
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``, x * ``sigmoid`` (x), each step rounded as there."""
    if x.dtype in (torch.float32, torch.float64):
        return torch.nn.functional.silu(x)
    return x * sigmoid(x)


# ---------------------------------------------------------------------------
# Linear / embedding
# ---------------------------------------------------------------------------
def init_linear_annot(gen: torch.Generator, d_in: int, d_out: int,
                      axes: tuple, dtype: torch.dtype, device="cpu",
                      bias: bool = False) -> dict:
    """``{"w": (d_in, d_out)}`` (JAX layout: ``y = x @ w``) on ``axes``,
    scale d_in^-1/2, and with ``bias`` a zero ``"b": (d_out,)`` on the
    last of them."""
    p = {"w": dense_init(gen, (d_in, d_out), axes, dtype, device)}
    if bias:
        p["b"] = zeros_init((d_out,), (axes[-1],), dtype, device)
    return p


def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, device="cpu", bias: bool = False) -> dict:
    return split(init_linear_annot(gen, d_in, d_out, (None, None), dtype,
                                   device, bias))[0]


def apply_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_embedding_annot(gen: torch.Generator, vocab: int, d: int,
                         dtype: torch.dtype, device="cpu"):
    return dense_init(gen, (vocab, d), ("vocab", "embed"), dtype, device,
                      scale=d ** -0.5)


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype, device="cpu") -> torch.Tensor:
    return init_embedding_annot(gen, vocab, d, dtype, device).value


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device="cpu") -> torch.Tensor:
    """The (head_dim / 2,) f32 rotation frequencies theta^(-2i / head_dim)."""
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=F32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float
               ) -> torch.Tensor:
    """Rotate the halves of x: (..., S, H, dh) by the f32 angles of
    ``positions`` (broadcastable to (..., S)), in f32, cast back to x's
    dtype."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, x.device)                  # (dh/2,)
    angles = positions[..., None].to(F32) * freqs            # (..., S, dh/2)
    cos = torch.cos(angles)[..., None, :]                    # (..., S, 1, dh/2)
    sin = torch.sin(angles)[..., None, :]
    x32 = x.to(F32)
    x1, x2 = x32[..., : dh // 2], x32[..., dh // 2:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], -1)
    return out.to(x.dtype)


def softcap(logits: torch.Tensor, cap: float) -> torch.Tensor:
    if not cap:
        return logits
    return cap * torch.tanh(logits / cap)


def gelu(x: torch.Tensor) -> torch.Tensor:
    """GELU, tanh approximation (JAX's ``jax.nn.gelu(approximate=True)``)."""
    return torch.nn.functional.gelu(x, approximate="tanh")
