"""Shared model components: norms, linear and embedding initializers and
rotary position embeddings (the port's twin of the JAX package's
``models/common.py``).

Initializers return plain tensors drawn from an explicit
``torch.Generator`` on an explicit device (the JAX package returns
partitioning annotations; the port has no partitioning yet).  Apply
functions compute numerically sensitive ops (norms) in float32 and cast
back to the input dtype, as the JAX package does.
"""
from __future__ import annotations

import torch

F32 = torch.float32


def truncated_normal(gen: torch.Generator, shape: tuple, scale: float,
                     dtype: torch.dtype, device) -> torch.Tensor:
    """N(0, 1) truncated to [-2, 2], times ``scale``, drawn in f32 and cast
    to ``dtype`` (JAX's ``truncated_normal(key, -2, 2, shape) * scale``)."""
    w = torch.empty(shape, dtype=F32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (w * scale).to(dtype)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------
def init_norm(d: int, kind: str, dtype: torch.dtype, device="cpu") -> dict:
    p = {"scale": torch.ones(d, dtype=dtype, device=device)}
    if kind == "ln":
        p["bias"] = torch.zeros(d, dtype=dtype, device=device)
    return p


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


def init_groupnorm(n_groups: int, d: int, dtype: torch.dtype,
                   device="cpu") -> dict:
    del n_groups
    return {"scale": torch.ones(d, dtype=dtype, device=device),
            "bias": torch.zeros(d, dtype=dtype, device=device)}


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
# Linear / embedding
# ---------------------------------------------------------------------------
def init_linear(gen: torch.Generator, d_in: int, d_out: int,
                dtype: torch.dtype, device="cpu", bias: bool = False) -> dict:
    """``{"w": (d_in, d_out)}`` (JAX layout: ``y = x @ w``), scale
    d_in^-1/2, and with ``bias`` a zero ``"b": (d_out,)``."""
    p = {"w": truncated_normal(gen, (d_in, d_out), d_in ** -0.5, dtype,
                               device)}
    if bias:
        p["b"] = torch.zeros(d_out, dtype=dtype, device=device)
    return p


def apply_linear(p: dict, x: torch.Tensor) -> torch.Tensor:
    y = x @ p["w"]
    if "b" in p:
        y = y + p["b"]
    return y


def init_embedding(gen: torch.Generator, vocab: int, d: int,
                   dtype: torch.dtype, device="cpu") -> torch.Tensor:
    return truncated_normal(gen, (vocab, d), d ** -0.5, dtype, device)


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
