"""Dense MLP blocks, SwiGLU and GELU (the port's twin of the JAX package's
``models/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.models import common


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device="cpu") -> dict:
    """SwiGLU ``{"wg", "wu": (d, ff), "wd": (ff, d)}``, or for another
    ``cfg.mlp_act`` GELU ``{"wi": (d, ff), "wd": (ff, d)}``, in the JAX
    layouts (``x @ w``)."""
    d = cfg.d_model
    ff = cfg.d_ff

    def w(shape, scale):
        return common.truncated_normal(gen, shape, scale, dtype, device)

    if cfg.mlp_act == "swiglu":
        return {"wg": w((d, ff), d ** -0.5), "wu": w((d, ff), d ** -0.5),
                "wd": w((ff, d), ff ** -0.5)}
    return {"wi": w((d, ff), d ** -0.5), "wd": w((ff, d), ff ** -0.5)}


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The block of ``init_mlp``'s tree: SwiGLU when it holds a gate."""
    if "wg" in p:
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = common.gelu(x @ p["wi"])
    return h @ p["wd"]
