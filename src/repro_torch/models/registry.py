"""Model registry: build a model from an architecture name (the port's twin
of the JAX package's ``models/registry.py``, without the dry-run's input
specs)."""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


@dataclasses.dataclass(frozen=True)
class Model:
    cfg: ModelConfig

    def init(self, gen: torch.Generator,
             device: str | torch.device = "cpu") -> dict:
        return transformer.init_params(self.cfg, gen, device)

    def init_cache(self, batch: int, max_seq: int,
                   device: str | torch.device = "cpu", *,
                   per_lane_pos: bool = False) -> dict:
        return transformer.init_cache(self.cfg, batch, max_seq, device,
                                      per_lane_pos=per_lane_pos)

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


def build(arch: str | ModelConfig) -> Model:
    return Model(get_arch(arch) if isinstance(arch, str) else arch)
