"""Model registry: build models and input specs from an architecture name
(the port's twin of the JAX package's ``models/registry.py``).

``input_specs`` is the single description of what every (arch x shape)
combination consumes: tensors on the ``meta`` device, shapes and dtypes
that are never allocated (where the JAX package gives
``jax.ShapeDtypeStruct``s), and ``make_batch``
materialises a random batch of them from a ``torch.Generator``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig, ShapeConfig
from repro_torch.models import transformer

# dense archs get a ring-buffer sliding window for the 500k decode shape
LONG_CONTEXT_WINDOW = 8192


def config_for_shape(cfg: ModelConfig, shape: ShapeConfig) -> ModelConfig:
    """Shape-specific config adjustments, as in the JAX package: full
    attention at a 524288-token decode is replaced by the sliding-window
    variant for archs with no sub-quadratic path of their own
    (dense/vlm/audio/moe); ssm/hybrid run natively."""
    needs_window = (shape.seq_len >= 262_144 and not cfg.attention_free
                    and cfg.attn_every == 0)
    if needs_window and not cfg.sliding_window:
        return dataclasses.replace(cfg, sliding_window=LONG_CONTEXT_WINDOW)
    return cfg


def input_specs(cfg: ModelConfig, shape: ShapeConfig
                ) -> dict[str, torch.Tensor]:
    """Every model input of this shape, as a ``meta`` tensor: ``tokens`` int32 ((B,) or (B, K)
    for a decode step; (B, S), (B, K, S) with audio codebooks, or (B, S -
    n_vis) beside ``vis_embeds`` (B, n_vis, vis_dim) in the model dtype
    with vision tokens), and for training ``labels`` shaped as ``tokens``."""
    B, S = shape.global_batch, shape.seq_len

    def spec(*dims: int, dtype: torch.dtype = torch.int32) -> torch.Tensor:
        return torch.empty(dims, dtype=dtype, device="meta")

    if shape.kind == "decode":
        if cfg.n_codebooks:
            return {"tokens": spec(B, cfg.n_codebooks)}
        return {"tokens": spec(B)}

    specs: dict[str, torch.Tensor] = {}
    if cfg.n_codebooks:
        specs["tokens"] = spec(B, cfg.n_codebooks, S)
    elif cfg.n_vis_tokens:
        specs["tokens"] = spec(B, S - cfg.n_vis_tokens)
        specs["vis_embeds"] = spec(B, cfg.n_vis_tokens, cfg.vis_dim,
                                   dtype=getattr(torch, cfg.dtype))
    else:
        specs["tokens"] = spec(B, S)
    if shape.kind == "train":
        specs["labels"] = spec(*specs["tokens"].shape)
    return specs


def make_batch(cfg: ModelConfig, shape: ShapeConfig, gen: torch.Generator
               ) -> dict[str, torch.Tensor]:
    """A random batch matching ``input_specs``, drawn from ``gen`` on its
    device in the specs' order: integer inputs uniform in [0, vocab), the
    others standard normal drawn in f32 and cast to their dtype."""
    out = {}
    for name, s in input_specs(cfg, shape).items():
        if s.dtype.is_floating_point:
            out[name] = torch.randn(s.shape, generator=gen,
                                    device=gen.device).to(s.dtype)
        else:
            out[name] = torch.randint(0, cfg.vocab, s.shape, generator=gen,
                                      device=gen.device, dtype=s.dtype)
    return out


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, gen: torch.Generator,
             device: str | torch.device = "cpu") -> dict:
        return transformer.init_params(self.cfg, gen, device)

    def init_annot(self, gen: torch.Generator,
                   device: str | torch.device = "cpu") -> dict:
        """``init``'s draw with ``partitioning.Annot`` leaves (the logical
        axes beside each tensor); ``split`` gives (params, axes)."""
        return transformer.init_params_annot(self.cfg, gen, device)

    def abstract_params(self) -> tuple[dict, dict]:
        return transformer.abstract_params(self.cfg)

    def init_cache(self, batch: int, max_seq: int,
                   device: str | torch.device = "cpu", *,
                   per_lane_pos: bool = False) -> dict:
        return transformer.init_cache(self.cfg, batch, max_seq, device,
                                      per_lane_pos=per_lane_pos)

    def abstract_cache(self, batch: int, max_seq: int) -> tuple[dict, dict]:
        return transformer.abstract_cache(self.cfg, batch, max_seq)

    def forward(self, params, batch, remat: bool = False,
                inference: bool = False):
        return transformer.forward(params, self.cfg, batch, remat=remat,
                                   inference=inference)

    def prefill(self, params, cache, batch):
        return transformer.prefill(params, self.cfg, cache, batch)

    def prefill_chunk(self, params, cache, batch):
        return transformer.prefill_chunk(params, self.cfg, cache, batch)

    def decode_step(self, params, cache, batch):
        return transformer.decode_step(params, self.cfg, cache, batch)


def build(arch: str | ModelConfig, shape: ShapeConfig | None = None
          ) -> Model:
    cfg = get_arch(arch) if isinstance(arch, str) else arch
    if shape is not None:
        cfg = config_for_shape(cfg, shape)
    return Model(cfg)
