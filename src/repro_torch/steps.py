"""Step functions shared by serving and the smoke runs (the port's twin of
the JAX package's ``steps.py``; the training steps come with the RWKV6
training slice).  All take the plain parameter and cache trees; the cache
is updated in place."""
from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer


def prefill_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict
                 ) -> tuple[torch.Tensor, dict]:
    return transformer.prefill(params, cfg, cache, batch)


def decode_step(cfg: ModelConfig, params: dict, cache: dict, batch: dict
                ) -> tuple[torch.Tensor, dict]:
    return transformer.decode_step(params, cfg, cache, batch)


def greedy_sample(logits: torch.Tensor) -> torch.Tensor:
    return torch.argmax(logits, dim=-1).to(torch.int32)
