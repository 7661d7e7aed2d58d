"""Mamba (S6 selective SSM) block — the port's twin of the JAX package's
``models/mamba.py``, the SSM half of the Jamba hybrid.

The full-sequence path runs the ``core/plans.MAMBA_PLANS`` plan named by
the module-level ``SCAN_PLAN``: ``fused_scan``, the hand-written CUDA
kernel (kernels/mamba_scan.py: K7, and K7t with K7b under autograd), so
that on the card the scan runs the kernel; ``scan`` (the per-step
recurrence in plain PyTorch, what the JAX model's own ``lax.scan``
computes) takes its place for comparisons.  The JAX model never reaches
its Pallas kernel: its ``_scan`` is a ``lax.scan``.  Decode goes through
``apply_mamba`` as in JAX, so a decode step runs the scan at T = 1: one K7
launch a layer on the card.

Dtypes follow the JAX package's casts: the projections run in the model
dtype; dt, B and C are f32; the scan takes the conv output in f32 (what the
JAX ``_scan`` computes with) and returns y in f32, so in bf16 nothing is
rounded twice, and the skip term ``xc * d_skip`` is added outside the
kernel in f32 before one cast.  The (conv window, ssm state) of each layer
are the recurrent state buffers of the preallocated decode cache
(core/state.py); every entry point returns new states and writes none in
place.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common

F32 = torch.float32

#: ``core/plans.MAMBA_PLANS`` plan of the scan.  The JAX model runs its own
#: ``lax.scan`` (the registry's ``scan``); the port runs ``fused_scan``, the
#: registry's kernel plan, so that the scan on the card runs the hand
#: kernel.  Comparisons swap it for ``scan``.
SCAN_PLAN = "fused_scan"


def d_inner(cfg: ModelConfig) -> int:
    return cfg.ssm.expand * cfg.d_model


def dt_rank(cfg: ModelConfig) -> int:
    return math.ceil(cfg.d_model / 16)


def init_mamba(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
               device="cpu") -> dict:
    """The JAX package's tree and initialisation: S4D-real A (``a_log`` =
    log 1..d_state per channel), dt bias the inverse softplus of dt drawn
    log-uniform in [1e-3, 1e-1], zero conv bias, unit skip."""
    d = cfg.d_model
    di, ds, dc, dr = d_inner(cfg), cfg.ssm.d_state, cfg.ssm.d_conv, \
        dt_rank(cfg)

    def w(shape, scale, dt_):
        return common.truncated_normal(gen, shape, scale, dt_, device)

    a = torch.arange(1, ds + 1, dtype=F32, device=device).repeat(di, 1)
    u = torch.rand(di, generator=gen, dtype=F32, device=device)
    dt_init = torch.exp(u * (math.log(0.1) - math.log(1e-3))
                        + math.log(1e-3))
    dt_bias = dt_init + torch.log1p(-torch.exp(-dt_init))  # inverse softplus
    return {
        "in_proj": w((d, 2 * di), d ** -0.5, dtype),
        "conv_w": w((dc, di), dc ** -0.5, dtype),
        "conv_b": torch.zeros(di, dtype=dtype, device=device),
        "x_proj": w((di, dr + 2 * ds), di ** -0.5, dtype),
        "dt_proj": w((dr, di), dr ** -0.5, F32),
        "dt_bias": dt_bias,
        "a_log": torch.log(a),
        "d_skip": torch.ones(di, dtype=F32, device=device),
        "out_proj": w((di, d), di ** -0.5, dtype),
    }


def _conv_causal(p: dict, x: torch.Tensor, x_prev: torch.Tensor
                 ) -> torch.Tensor:
    """Depthwise causal conv over the sequence.  x: (B, S, di); x_prev:
    (B, dc-1, di) the window carried from the previous segment.  Tap i
    reads position t - (dc-1-i)."""
    dc = p["conv_w"].shape[0]
    S = x.shape[1]
    xp = torch.cat([x_prev.to(x.dtype), x], dim=1)
    out = torch.zeros_like(x)
    for i in range(dc):
        out = out + xp[:, i:i + S] * p["conv_w"][i]
    return out + p["conv_b"]


def _ssm_params(p: dict, cfg: ModelConfig, xc: torch.Tensor):
    """dt (B, S, di) f32 and the B, C matrices (B, S, ds) f32 from the conv
    output."""
    dr, ds = dt_rank(cfg), cfg.ssm.d_state
    proj = xc @ p["x_proj"]
    dt = F.softplus(proj[..., :dr].to(F32) @ p["dt_proj"] + p["dt_bias"])
    return dt, proj[..., dr:dr + ds].to(F32), proj[..., dr + ds:].to(F32)


def _scan(p: dict, xc: torch.Tensor, dt, b_mat, c_mat, h0: torch.Tensor, *,
          chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """Selective scan through the ``SCAN_PLAN`` plan, plus the skip term.
    xc: (B, S, di); h0: (B, di, ds) f32.  Returns (y (B, S, di) f32, h'
    f32)."""
    from repro_torch.core import plans as plans_lib

    a = -torch.exp(p["a_log"])                          # (di, ds)
    x32 = xc.to(F32)
    y, h = plans_lib.MAMBA_PLANS[SCAN_PLAN](
        x32, dt, b_mat, c_mat, a, h0, chunk=chunk, block_b=None)
    return y + x32 * p["d_skip"], h


def scan_summary(p: dict, dt: torch.Tensor, b_mat: torch.Tensor
                 ) -> torch.Tensor:
    """Affine summary of a scan segment: the update h' = exp(dt A) h +
    dt x B is affine in h, so a segment composes as (D_seg, A_seg) with
    D_seg = exp(sum_t dt_t A) (returned here, (B, di, ds)) and A_seg the
    scan-from-zero final state.  ``b_mat`` is the JAX signature's."""
    del b_mat
    a = -torch.exp(p["a_log"])
    return torch.exp(torch.sum(dt, dim=1)[..., None] * a)


def compose_affine(d1, a1, d2, a2):
    """(D2, A2) after (D1, A1): segment 1, then segment 2."""
    return d2 * d1, d2 * a1 + a2


def apply_mamba(p: dict, cfg: ModelConfig, x: torch.Tensor,
                conv_state: torch.Tensor, h_state: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Full-sequence mamba.  x: (B, S, d).  Returns (out, conv', h'): the
    new conv window holds the last dc-1 inputs before activation."""
    di = d_inner(cfg)
    xz = x @ p["in_proj"]
    x_in, z = xz[..., :di], xz[..., di:]
    xc = F.silu(_conv_causal(p, x_in, conv_state))
    dt, b_mat, c_mat = _ssm_params(p, cfg, xc)
    y, h = _scan(p, xc, dt, b_mat, c_mat, h_state.to(F32),
                 chunk=cfg.ssm.chunk)
    out = (y.to(x.dtype) * F.silu(z)) @ p["out_proj"]
    dc = cfg.ssm.d_conv
    conv_new = torch.cat([conv_state.to(x_in.dtype), x_in],
                         dim=1)[:, -(dc - 1):]
    return out, conv_new, h


def step_mamba(p: dict, cfg: ModelConfig, x: torch.Tensor,
               conv_state: torch.Tensor, h_state: torch.Tensor
               ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One-token mamba.  x: (B, 1, d); conv_state: (B, dc-1, di); h_state:
    (B, di, ds)."""
    return apply_mamba(p, cfg, x, conv_state, h_state)
