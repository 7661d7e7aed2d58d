"""Serving entry point: batched requests through the MobiRNN-policy
engines (the port's twin of the JAX package's ``launch/serve.py``).

Builds the model of ``--arch`` (weights drawn from ``--seed`` on the
device), makes ``--requests`` random prompts of ``--prompt-len`` tokens
(for an audio model ``(K, --prompt-len)`` codebook ids; a vision model's
prefills carry the engine's zero patch embeddings ahead of them) and
serves them, ``--max-new`` greedy tokens each, through ``--engine``:
``slot`` (the default, as in the JAX package: continuous batching over
``--batch-size`` slots, the decode tick captured in a CUDA graph on the
card) or ``wave`` (lockstep waves of ``--batch-size``).  ``--load`` is the
injected accelerator load in [0, 1] the Fig 7 scheduler reads
(``SyntheticLoadSensor``).  It prints what the JAX entry point prints,
plus each wave's prefill ms and decode ms per token, or the slot engine's
TTFT and time-between-tokens p50/p99, ticks and plan decisions (host
clock, ending in a read of the result on the card).

  PYTHONPATH=src python -m repro_torch.launch.serve [--arch qwen2-0.5b |
      rwkv6-3b | yi-9b | stablelm-12b | command-r-35b | olmoe-1b-7b |
      qwen3-moe-30b-a3b | jamba-1.5-large-398b | internvl2-1b |
      musicgen-large] [--reduced]
      [--device cuda|cpu] [--engine slot|wave] [--load L] [--requests N]
      [--prompt-len S] [--max-new K] [--batch-size B]

The default device is ``cuda``; without a card that raises rather than
running on the CPU.  On the card every prefill's RWKV6 time-mix runs the
K6 kernel (``models/rwkv.WKV_PLAN``); for a dense model every prefill's
attention runs the K8 kernel and every decode step's the K9 kernel
(``models/attention.PREFILL_PLAN`` and ``DECODE_PLAN``), one launch a
layer each; a Mamba layer runs K7 in both; an MoE layer dispatches
drop-free with torch ops (``models/moe.py``).  In the slot engine's captured
tick the kernels launch at every replay while their wrappers count only
the capture (serving/tick.py).
"""
from __future__ import annotations

import argparse
import collections
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.core.scheduler import SyntheticLoadSensor
from repro_torch.launch.classify import resolve_device
from repro_torch.models import registry
from repro_torch.serving import (Engine, EngineConfig, Request, Result,
                                 SlotEngine)


def build_engine(cfg: ModelConfig, device: torch.device, *, seed: int = 0,
                 batch_size: int = 4, max_seq: int = 128,
                 engine: str = "slot", queue_capacity: int = 16,
                 load: float = 0.0) -> Engine | SlotEngine:
    """The model with weights drawn from ``seed`` on ``device``, behind a
    slot engine of ``batch_size`` slots (``engine="slot"``) or a wave
    engine of ``batch_size`` lanes (``"wave"``), its scheduler reading
    ``load``."""
    model = registry.build(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device)
    sensor = SyntheticLoadSensor(load)
    if engine == "wave":
        return Engine(model, params, sensor=sensor, config=EngineConfig(
            n_slots=batch_size, max_seq=max_seq))
    if engine != "slot":
        raise ValueError(f"unknown engine {engine!r}: slot or wave")
    return SlotEngine(model, params, sensor=sensor, config=EngineConfig(
        n_slots=batch_size, max_seq=max_seq, queue_capacity=queue_capacity))


def serve(engine: Engine | SlotEngine, reqs: list[Request]) -> dict:
    """Serve ``reqs`` and print the report.  Returns the results, the wall
    time and the pool's stats; for the wave engine each wave's prefill ms
    and decode ms per token, for the slot engine its metrics snapshot."""
    t0 = time.time()
    results = engine.serve(reqs)
    wall = time.time() - t0
    n_tok = sum(r.tokens.shape[-1] for r in results)
    print(f"arch={engine.cfg.name} served={len(results)} new_tokens={n_tok} "
          f"wall={wall:.2f}s tok/s={n_tok / wall:.1f}")
    for r in results[:4]:
        print(f"  req {r.uid}: prefill={r.prefill_s * 1e3:.1f}ms "
              f"decode={r.decode_s * 1e3:.1f}ms plans={set(r.plan_decisions)}")
    out = {"results": results, "wall_s": wall, "pool": engine.pool.stats}
    if isinstance(engine, SlotEngine):
        snap = engine.metrics.snapshot()
        for name in ("serving/ttft_s", "serving/tbt_s"):
            h = snap["histograms"][name]
            print(f"  {name}: p50 {h['p50'] * 1e3:.3f} ms, p99 "
                  f"{h['p99'] * 1e3:.3f} ms over {h['count']}")
        plans = collections.Counter(
            d.plan for d in engine.scheduler.decisions)
        tick = engine.ticks["decode/base"]
        print(f"  ticks {snap['counters']['serving/ticks']}, plans "
              f"{dict(plans)}, CUDA graph "
              f"{'captured' if tick.graph is not None else 'off (eager)'}"
              + (f", kernel launches a replayed tick "
                 f"{tick.captured_launches}" if tick.graph is not None
                 else ""))
        print("pool:", engine.pool.stats, "scratch:",
              engine._scratch_pool.stats)
        out["metrics"] = snap
        return out
    waves = _waves(results, engine.batch_size)
    for i, w in enumerate(waves):
        print(f"  wave {i}: prefill {w['prefill_ms']:.3f} ms, decode "
              f"{w['decode_ms_per_token']:.3f} ms/token over "
              f"{w['tokens']} steps")
    print("pool:", engine.pool.stats)
    out["waves"] = waves
    return out


def _waves(results: list[Result], batch_size: int) -> list[dict]:
    """Per-wave timings (every request of a wave carries its wave's)."""
    waves = []
    for i in range(0, len(results), batch_size):
        r = results[i]
        steps = len(r.plan_decisions)
        waves.append({"prefill_ms": r.prefill_s * 1e3, "tokens": steps,
                      "decode_ms_per_token":
                          r.decode_s * 1e3 / max(steps, 1)})
    return waves


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--engine", choices=("wave", "slot"), default="slot",
                    help="wave = lockstep batches; slot = slot-resident "
                         "continuous batching (default)")
    ap.add_argument("--load", type=float, default=0.0,
                    help="injected accelerator load in [0,1] (paper Fig 7)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = get_arch(args.arch + ("-reduced" if args.reduced else ""))
    # the cache also holds a vision prefix (the JAX driver sizes it by the
    # text alone, and its decode then writes past the cache)
    engine = build_engine(cfg, device, seed=args.seed,
                          batch_size=args.batch_size,
                          max_seq=(cfg.n_vis_tokens + args.prompt_len
                                   + args.max_new + 1),
                          engine=args.engine,
                          queue_capacity=max(args.requests, 1),
                          load=args.load)
    rng = np.random.default_rng(args.seed)
    shape = ((cfg.n_codebooks, args.prompt_len) if cfg.n_codebooks
             else (args.prompt_len,))
    reqs = [Request(i, rng.integers(0, cfg.vocab, shape).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    return serve(engine, reqs)


if __name__ == "__main__":
    main()
