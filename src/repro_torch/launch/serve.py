"""Serving entry point: batched requests through the MobiRNN-policy wave
engine (the port's twin of the JAX package's ``launch/serve.py --engine
wave``).

Builds the model of ``--arch`` (weights drawn from ``--seed`` on the
device), makes ``--requests`` random prompts of ``--prompt-len`` tokens and
serves them in waves of ``--batch-size``, ``--max-new`` greedy tokens each.
It prints what the JAX entry point prints, plus each wave's prefill ms and
decode ms per token (host clock, ending in a synchronize on the card).

  PYTHONPATH=src python -m repro_torch.launch.serve [--arch rwkv6-3b |
      qwen2-0.5b | yi-9b | stablelm-12b | command-r-35b] [--reduced]
      [--device cuda|cpu] [--requests N] [--prompt-len S] [--max-new K]
      [--batch-size B]

The default device is ``cuda``; without a card that raises rather than
running on the CPU.  ``--engine slot`` (the JAX default, continuous
batching) raises until the slot engine is ported, so the port's default is
``wave``.  On the card every prefill's RWKV6 time-mix runs the K6 kernel
(``models/rwkv.WKV_PLAN``); for a dense model every prefill's attention
runs the K8 kernel and every decode step's the K9 kernel
(``models/attention.PREFILL_PLAN`` and ``DECODE_PLAN``), one launch a
layer each.
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.launch.classify import resolve_device
from repro_torch.models import registry
from repro_torch.serving import Engine, EngineConfig, Request, Result


def build_engine(cfg: ModelConfig, device: torch.device, *, seed: int = 0,
                 batch_size: int = 4, max_seq: int = 128) -> Engine:
    """The model with weights drawn from ``seed`` on ``device``, behind a
    wave engine of ``batch_size`` lanes."""
    model = registry.build(cfg)
    gen = torch.Generator(device=device).manual_seed(seed)
    params = model.init(gen, device)
    return Engine(model, params,
                  config=EngineConfig(n_slots=batch_size, max_seq=max_seq))


def serve(engine: Engine, reqs: list[Request]) -> dict:
    """Serve ``reqs`` and print the report.  Returns the results, the wall
    time, each wave's prefill ms and decode ms per token, and the pool's
    stats."""
    t0 = time.time()
    results = engine.serve(reqs)
    wall = time.time() - t0
    n_tok = sum(r.tokens.shape[-1] for r in results)
    print(f"arch={engine.cfg.name} served={len(results)} new_tokens={n_tok} "
          f"wall={wall:.2f}s tok/s={n_tok / wall:.1f}")
    for r in results[:4]:
        print(f"  req {r.uid}: prefill={r.prefill_s * 1e3:.1f}ms "
              f"decode={r.decode_s * 1e3:.1f}ms plans={set(r.plan_decisions)}")
    waves = _waves(results, engine.batch_size)
    for i, w in enumerate(waves):
        print(f"  wave {i}: prefill {w['prefill_ms']:.3f} ms, decode "
              f"{w['decode_ms_per_token']:.3f} ms/token over "
              f"{w['tokens']} steps")
    print("pool:", engine.pool.stats)
    return {"results": results, "wall_s": wall, "waves": waves,
            "pool": engine.pool.stats}


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
    ap.add_argument("--arch", default="rwkv6-3b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--batch-size", type=int, default=4)
    ap.add_argument("--engine", choices=("wave", "slot"), default="wave",
                    help="wave = lockstep batches; slot = continuous "
                         "batching (not ported yet)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)

    if args.engine == "slot":
        raise NotImplementedError("the slot engine (continuous batching) "
                                  "is not ported yet; use --engine wave")
    device = resolve_device(args.device)
    cfg = get_arch(args.arch + ("-reduced" if args.reduced else ""))
    engine = build_engine(cfg, device, seed=args.seed,
                          batch_size=args.batch_size,
                          max_seq=args.prompt_len + args.max_new + 1)
    rng = np.random.default_rng(args.seed)
    reqs = [Request(i, rng.integers(0, cfg.vocab, (args.prompt_len,)
                                    ).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    return serve(engine, reqs)


if __name__ == "__main__":
    main()
