"""Dense MLP blocks, SwiGLU and GELU (the port's twin of the JAX package's
``models/mlp.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch import partitioning as pt
from repro_torch.configs.base import ModelConfig
from repro_torch.models import common
from repro_torch.partitioning import dense_init, split


def init_mlp_annot(gen: torch.Generator, cfg: ModelConfig,
                   dtype: torch.dtype, device="cpu") -> dict:
    """SwiGLU ``{"wg", "wu": (d, ff), "wd": (ff, d)}``, or for another
    ``cfg.mlp_act`` GELU ``{"wi": (d, ff), "wd": (ff, d)}``, in the JAX
    layouts (``x @ w``) and logical axes."""
    d = cfg.d_model
    ff = cfg.d_ff

    def w(shape, axes, scale):
        return dense_init(gen, shape, axes, dtype, device, scale)

    if cfg.mlp_act == "swiglu":
        return {"wg": w((d, ff), ("embed", "mlp"), d ** -0.5),
                "wu": w((d, ff), ("embed", "mlp"), d ** -0.5),
                "wd": w((ff, d), ("mlp", "embed"), ff ** -0.5)}
    return {"wi": w((d, ff), ("embed", "mlp"), d ** -0.5),
            "wd": w((ff, d), ("mlp", "embed"), ff ** -0.5)}


def init_mlp(gen: torch.Generator, cfg: ModelConfig, dtype: torch.dtype,
             device="cpu") -> dict:
    """``init_mlp_annot``'s plain tensors."""
    return split(init_mlp_annot(gen, cfg, dtype, device))[0]


def apply_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """The block of ``init_mlp``'s tree: SwiGLU when it holds a gate.  On a
    mesh of more than one device (DTensors) a ``shard_map`` body: the
    batch over ('pod', 'data'), the hidden units over 'model' where the
    specs split them (the weights gathered over 'data' on entry), the down
    projection's partial sums meeting in one psum over 'model'."""
    rules = pt.active_rules()
    if rules is not None:
        p_specs = pt.body_specs(p)
        split = pt.sharded_over(p_specs["wd"], 0, rules.mesh)
        x_spec = rules.spec_for(("batch",) + (None,) * (x.dim() - 1),
                                x.shape)

        def local_fn(x_l, p_l):
            out = apply_mlp(p_l, x_l)
            return pt.psum(out, "model") if split else out
        return pt.shard_map(local_fn, rules.mesh, in_specs=(x_spec, p_specs),
                            out_specs=x_spec)(x, p)
    if "wg" in p:
        h = F.silu(x @ p["wg"]) * (x @ p["wu"])
    else:
        h = common.gelu(x @ p["wi"])
    return h @ p["wd"]
