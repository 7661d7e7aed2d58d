"""The wave serving engine with MobiRNN-style runtime policies (the port's
twin of the JAX package's ``serving/engine.py`` ``Engine``).

The paper's mechanisms are first-class here:
  * a preallocated state pool (core/state.StatePool) — decode caches are
    built once and zeroed in place; no state is allocated on the serving
    path, and pool exhaustion is explicit backpressure;
  * fixed-shape batching — every wave has ``batch_size`` lanes.
The wave engine has one decode plan, ``decode/base`` (steps.decode_step),
and runs it directly: load-aware dispatch between decode plans (the
scheduler of paper Fig 7) comes with the slot engine and its second plan.

``Engine`` packs requests into lockstep waves of ``batch_size``: every
request is left-padded to the longest prompt of its wave and decodes for
the longest ``max_new_tokens``; short waves are filled with zero-length
dummy requests (inactive lanes).  Timings are host clock around work that
ends in ``torch.cuda.synchronize()`` when the outputs are on the card.
The slot engine (continuous batching) comes with the serving slice.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any

import numpy as np
import torch

from repro_torch import steps as steps_lib
from repro_torch.core.scheduler import block_until_ready
from repro_torch.core.state import StatePool
from repro_torch.models.registry import Model
from repro_torch.obs import trace as trace_lib
from repro_torch.serving.slots import Request, Result


@dataclasses.dataclass
class EngineConfig:
    """Construction surface of the engines (the fields the wave engine
    reads; the slot engine's queue, retry, ladder, fault and chunk knobs
    come with it).  ``n_slots`` is the wave's batch size."""
    n_slots: int = 4
    max_seq: int = 128
    pool_capacity: int = 2


class Engine:
    """Lockstep wave engine — the coarse-batching baseline.  The pool's
    buffers live on the parameters' device."""

    def __init__(self, model: Model, params: Any, *,
                 config: EngineConfig | None = None):
        self.config = config if config is not None else EngineConfig()
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.batch_size = self.config.n_slots
        self.device = params["embed"].device
        spec = model.init_cache(self.batch_size, self.config.max_seq,
                                device="meta")
        self.pool = StatePool(spec, capacity=self.config.pool_capacity,
                              device=self.device)

    def _prefill(self, params, cache, batch):
        return steps_lib.prefill_step(self.cfg, params, cache, batch)

    def _dummy_request(self) -> Request:
        """Zero-length, zero-token filler for ragged wave tails — an
        inactive lane, NOT a duplicate of a real request."""
        return Request(uid=-1, prompt=np.zeros((0,), np.int32),
                       max_new_tokens=0)

    def _pad_prompts(self, reqs: list[Request]) -> np.ndarray:
        s = max(r.prompt.shape[-1] for r in reqs)
        toks = np.zeros((self.batch_size, s), np.int32)
        for i, r in enumerate(reqs):
            toks[i, s - r.prompt.shape[-1]:] = r.prompt       # left-pad
        return toks

    def serve(self, requests: list[Request]) -> list[Result]:
        """Serve all requests in fixed-shape waves of ``batch_size``."""
        results: list[Result] = []
        with torch.no_grad():
            for i in range(0, len(requests), self.batch_size):
                wave = requests[i:i + self.batch_size]
                pad = self.batch_size - len(wave)
                wave_padded = wave + [self._dummy_request()] * pad
                results.extend(self._serve_wave(wave_padded)[: len(wave)])
        return results

    def _serve_wave(self, reqs: list[Request]) -> list[Result]:
        cache = self.pool.checkout()
        toks = self._pad_prompts(reqs)
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}

        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, cache, batch)
        block_until_ready(logits)
        t_prefill = time.perf_counter() - t0

        max_new = max(r.max_new_tokens for r in reqs)
        outs = []
        tracer = trace_lib.get_tracer()
        wave_span = (tracer.span("serve/wave", n_reqs=len(reqs),
                                 max_new=max_new, prefill_s=t_prefill)
                     if tracer.enabled else trace_lib.NULL_SPAN)
        # prefill logits keep a singleton seq axis before the vocab dim
        tok = steps_lib.greedy_sample(logits)[..., 0]
        t0 = time.perf_counter()
        with wave_span:
            for _ in range(max_new):
                outs.append(tok.cpu().numpy())
                logits, cache = steps_lib.decode_step(
                    self.cfg, self.params, cache, {"tokens": tok})
                tok = steps_lib.greedy_sample(logits)
            block_until_ready(logits)
            t_decode = time.perf_counter() - t0
            wave_span.set(decode_s=t_decode)
        self.pool.give_back(cache)

        # (B, max_new); toks[:, :0] covers an all-zero-budget wave
        gen = np.stack(outs, axis=-1) if outs else toks[:, :0]
        return [Result(r.uid, gen[j, :r.max_new_tokens], t_prefill,
                       t_decode, ["decode/base"] * max_new)
                for j, r in enumerate(reqs)]
