"""Training entry point (the port's twin of the JAX package's
``launch/train.py``).

Trains an architecture of the port (``rwkv6-3b``, or its ``--reduced``
variant) on the synthetic LM pipeline (``data/lm.py``, the same tokens as
the JAX trainer's for a seed) with AdamW under a warmup-cosine schedule,
weights drawn from ``--seed`` on the device.  Every layer's time-mix runs
the plan of ``models/rwkv.WKV_PLAN``: on the card ``chunked_scan``, whose
training step is two kernel launches a layer (the trajectory forward K6t
and the reverse sweep K6b), plus one more K6t a layer for the recompute of
``remat`` (on, as in the JAX trainer).  A Mamba stack (``train(cfg,
...)`` with an attention-free Jamba config) runs ``models/mamba.SCAN_PLAN``
the same way: K7t and K7b, plus one more K7t a layer for the recompute.
It prints the JAX trainer's per-step JSON lines and closing ``loss a ->
b`` line, and before that the median and minimum step time (host clock
around a step, ending in the loss's copy to the host).

  PYTHONPATH=src python -m repro_torch.launch.train [--arch rwkv6-3b]
      [--reduced] [--device cuda|cpu] [--steps N] [--batch B] [--seq S]
      [--lr LR] [--log-every N] [--seed N]

The default device is ``cuda``; without a card that raises rather than
running on the CPU.  ``--ckpt-dir`` raises: checkpointing comes with the
distributed slice (ROADMAP Queue 1, "Distributed, launch and checkpoint").
"""
from __future__ import annotations

import argparse
import json
import statistics
import time

import torch

from repro_torch import steps as steps_lib
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.data.lm import SyntheticLM
from repro_torch.launch.classify import resolve_device
from repro_torch.models import registry
from repro_torch.optim.adamw import AdamW, tree_leaves, warmup_cosine


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="rwkv6-3b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="not ported yet: raises (ROADMAP Queue 1, "
                         "\"Distributed, launch and checkpoint\")")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None:
        raise NotImplementedError("--ckpt-dir: checkpointing comes with the "
                                  "distributed slice (ROADMAP Queue 1, "
                                  "\"Distributed, launch and checkpoint\")")
    return train(get_arch(args.arch + ("-reduced" if args.reduced else "")),
                 steps=args.steps, batch=args.batch, seq=args.seq,
                 lr=args.lr, seed=args.seed, device=args.device,
                 log_every=args.log_every)


def train(cfg: ModelConfig, *, steps: int = 50, batch: int = 8,
          seq: int = 64, lr: float = 3e-3, seed: int = 0,
          device: str = "cuda", log_every: int = 10) -> dict:
    """Train ``cfg`` for ``steps`` AdamW steps of ``batch`` x ``seq``
    tokens and print the report; ``main``'s flags as keywords.  Returns
    the logged history, every loss, ``grad_norm`` and step time, the
    parameter count and the tokens of a step."""
    device = resolve_device(device)
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(seed),
                        device)
    for p in tree_leaves(params):
        p.requires_grad_()
    n_params = sum(p.numel() for p in tree_leaves(params))
    print(f"arch={cfg.name} params={n_params:,} device={device}")

    optimizer = AdamW(lr=warmup_cosine(lr, steps // 10, steps))
    opt_state = optimizer.init(params)
    it = SyntheticLM(cfg.vocab, seed=seed).batches(batch, seq)

    history, losses, grad_norms, step_ms = [], [], [], []
    log_every = max(log_every, 1)        # --log-every 0 means "every step"
    t0 = time.time()
    for step in range(1, steps + 1):
        tokens = {k: torch.from_numpy(v).to(device)
                  for k, v in next(it).items()}
        ts = time.perf_counter()
        params, opt_state, metrics = steps_lib.train_step(
            optimizer, cfg, params, opt_state, tokens)
        losses.append(float(metrics["loss"]))
        step_ms.append((time.perf_counter() - ts) * 1e3)
        grad_norms.append(float(metrics["grad_norm"]))
        if step % log_every == 0 or step == 1:
            m = {k: float(v) for k, v in metrics.items()}
            m["step"] = step
            m["wall_s"] = round(time.time() - t0, 1)
            history.append(m)
            print(json.dumps({k: (round(v, 4) if isinstance(v, float)
                                  else v) for k, v in m.items()}))
    report = {"history": history, "losses": losses,
              "grad_norms": grad_norms, "step_ms": step_ms,
              "n_params": n_params, "tokens_per_step": batch * seq}
    if not history:                      # --steps 0: nothing ran, no summary
        print("no training steps run")
        return report
    print(f"step ms: median {statistics.median(step_ms):.3f}, min "
          f"{min(step_ms):.3f} over {len(step_ms)} steps (host clock, "
          "ending in the loss's copy to the host)")
    first, last = history[0]["loss"], history[-1]["loss"]
    print(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return report


if __name__ == "__main__":
    main()
