"""Training entry point (the port's twin of the JAX package's
``launch/train.py``).

Trains an architecture of ``ARCHS`` that ``transformer.check_trainable``
admits (``--arch``, default ``qwen2-0.5b`` as in the JAX package, or its
``--reduced`` variant; not the audio and vision fronts, whose inputs the
text pipeline lacks) on
the synthetic LM pipeline (``data/lm.py``, the same tokens as the JAX
trainer's for a seed) with AdamW under a warmup-cosine schedule, weights
drawn from ``--seed`` on the device.  As in the JAX trainer, the
parameters are drawn with their logical axes (``Model.init_annot``),
placed by the default rules on the host mesh (``launch/mesh.py``:
(data=1, model=1) on the one device it trains on, where every placement
is the identity) and the steps run inside ``use_rules``, so the models'
``constrain`` calls resolve against that mesh.  On the card each layer's
mix runs its kernels, with ``remat`` on as in the JAX trainer: an RWKV6
time-mix (``models/rwkv.WKV_PLAN`` ``chunked_scan``) the trajectory
forward K6t and the reverse sweep K6b, plus one more K6t for the
recompute; a Mamba layer (``models/mamba.SCAN_PLAN``) K7t and K7b the same
way; an attention layer (``models/attention.PREFILL_PLAN``
``flash_prefill``: Qwen2, Yi, StableLM, Command-R, the MoE decoders OLMoE
and Qwen3-MoE, the Jamba hybrid) K8t twice and the backward K8b once.  MoE layers train at the
config's capacity factor.  It prints the JAX trainer's ``arch= params=
mesh=`` line (and the device), its per-step JSON lines and closing ``loss
a -> b`` line, and before that the median and minimum step time (host
clock around a step, ending in the loss's copy to the host).  With
``--ckpt-dir`` it saves the parameters every ``--ckpt-every`` steps as the
JAX trainer does (``checkpoint/ckpt.py``: ``ckpt_%08d.npz`` and ``.json``
with the arch's name), files either package's ``restore`` reads.

On several ranks (``torchrun --nproc-per-node N``, or a caller's process
group: the JAX trainer's host mesh of several devices) the mesh is (data
= N // ``--model-axis``, model = ``--model-axis``) over the ranks, the
parameters and the AdamW moments are DTensors placed FSDP-style by the
default rules, every rank cuts its batch shard from the same stream, and
the checkpoints hold the whole tensors, gathered from the shards.

  PYTHONPATH=src python -m repro_torch.launch.train [--arch qwen2-0.5b]
      [--reduced] [--device cuda|cpu] [--steps N] [--batch B] [--seq S]
      [--lr LR] [--log-every N] [--seed N] [--ckpt-dir D]
      [--ckpt-every N] [--model-axis M]
  torchrun --nproc-per-node 4 -m repro_torch.launch.train --device cpu
      --reduced --model-axis 2

The default device is ``cuda``; without a card that raises rather than
running on the CPU.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import time

import torch
import torch.distributed as dist

from repro_torch import partitioning as pt
from repro_torch import steps as steps_lib
from repro_torch.checkpoint import ckpt
from repro_torch.configs import ARCHS, get_arch
from repro_torch.configs.base import ModelConfig
from repro_torch.data.lm import SyntheticLM
from repro_torch.launch.classify import resolve_device
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import registry
from repro_torch.optim.adamw import (AdamW, tree_leaves, tree_map,
                                     warmup_cosine)
from repro_torch.partitioning import (device_put, make_rules, param_count,
                                      split, tree_shardings, use_rules)


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="qwen2-0.5b", choices=sorted(ARCHS))
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save the parameters here every --ckpt-every steps")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--model-axis", type=int, default=1,
                    help="the host mesh's 'model' size over a process group "
                         "of several ranks (data = ranks // model-axis)")
    args = ap.parse_args(argv)
    joined = _join_group(args.device)
    cfg = get_arch(args.arch + ("-reduced" if args.reduced else ""))
    if cfg.n_codebooks or cfg.n_vis_tokens:
        ap.error(f"--arch {args.arch}: the synthetic LM pipeline gives text "
                 "alone; train an audio or vision front through "
                 "steps.train_step on registry.make_batch batches")
    try:
        return train(cfg, steps=args.steps, batch=args.batch, seq=args.seq,
                     lr=args.lr, seed=args.seed, device=args.device,
                     log_every=args.log_every, ckpt_dir=args.ckpt_dir,
                     ckpt_every=args.ckpt_every, model_axis=args.model_axis)
    finally:
        if joined:
            dist.destroy_process_group()


def _join_group(device: str) -> bool:
    """Under ``torchrun`` (``WORLD_SIZE`` > 1 in the environment) join its
    process group: NCCL when every rank has a card of its own, else gloo
    (the CPU, or several ranks sharing one card; gloo stages CUDA tensors
    through host memory).  Nothing outside one, or when a group runs.
    Returns whether it joined."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world == 1 or dist.is_initialized():
        return False
    own_cards = device == "cuda" and torch.cuda.device_count() >= world
    if own_cards:
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
    dist.init_process_group("nccl" if own_cards else "gloo",
                            init_method="env://")
    return True


def _host_float(t: torch.Tensor) -> float:
    """A replicated 0-d value (a DTensor's: its local copy) on the host."""
    return float(t.to_local() if hasattr(t, "to_local") else t)


def train(cfg: ModelConfig, *, steps: int = 50, batch: int = 8,
          seq: int = 64, lr: float = 3e-3, seed: int = 0,
          device: str = "cuda", log_every: int = 10,
          ckpt_dir: str | None = None, ckpt_every: int = 100,
          model_axis: int = 1) -> dict:
    """Train ``cfg`` for ``steps`` AdamW steps of ``batch`` x ``seq``
    tokens and print the report; ``main``'s flags as keywords.  Returns
    the logged history, every loss, ``grad_norm`` and step time, the
    parameter count, the tokens of a step and the trained ``params``
    (DTensors on a mesh of several ranks).

    Inside a process group of several ranks the host mesh is (data =
    ranks // ``model_axis``, model = ``model_axis``) over them: every rank
    draws the same weights from ``seed``, and the parameters and the AdamW
    moments are DTensors placed by the default rules (``embed`` over
    'data': FSDP-style); each rank cuts its batch shard from the same
    synthetic stream (the global batch of ``batch`` rows, as JAX's
    ``device_put`` slices one host array).  Every rank prints the ``arch=
    params= mesh=`` line, only rank 0 the step lines and the summary."""
    device = resolve_device(device)
    model = registry.build(cfg)
    if dist.is_initialized() and dist.get_world_size() > 1:
        mesh = make_host_mesh(model_axis, device=device)
    else:
        # one device: the host mesh is that device alone
        mesh = make_host_mesh(device=device if device.type == "cpu" or
                              device.index is not None else
                              torch.device("cuda",
                                           torch.cuda.current_device()))
    lead = not dist.is_initialized() or dist.get_rank() == 0
    log = print if lead else (lambda *a, **k: None)
    rules = make_rules(mesh)
    params, axes = split(model.init_annot(
        torch.Generator(device=device).manual_seed(seed), device))
    n_params = param_count(params)
    print(f"arch={cfg.name} params={n_params:,} mesh={dict(mesh.shape)} "
          f"device={device}")
    params = device_put(params, tree_shardings(axes, params, rules))
    for p in tree_leaves(params):
        p.requires_grad_()

    optimizer = AdamW(lr=warmup_cosine(lr, steps // 10, steps))
    opt_state = optimizer.init(params)
    it = SyntheticLM(cfg.vocab, seed=seed).batches(batch, seq)
    batch_shardings = None

    history, losses, grad_norms, step_ms = [], [], [], []
    log_every = max(log_every, 1)        # --log-every 0 means "every step"
    t0 = time.time()
    with use_rules(rules):
        for step in range(1, steps + 1):
            tokens = {k: torch.from_numpy(v).to(device)
                      for k, v in next(it).items()}
            if batch_shardings is None:
                batch_shardings = {k: rules.sharding_for(
                    ("batch",) + (None,) * (v.dim() - 1), v.shape)
                    for k, v in tokens.items()}
            tokens = device_put(tokens, batch_shardings)
            ts = time.perf_counter()
            params, opt_state, metrics = steps_lib.train_step(
                optimizer, cfg, params, opt_state, tokens)
            losses.append(_host_float(metrics["loss"]))
            step_ms.append((time.perf_counter() - ts) * 1e3)
            grad_norms.append(_host_float(metrics["grad_norm"]))
            if step % log_every == 0 or step == 1:
                m = {k: _host_float(v) for k, v in metrics.items()}
                m["step"] = step
                m["wall_s"] = round(time.time() - t0, 1)
                history.append(m)
                log(json.dumps({k: (round(v, 4) if isinstance(v, float)
                                    else v) for k, v in m.items()}))
            if ckpt_dir and step % ckpt_every == 0:
                full = tree_map(pt.full_tensor, params)
                if lead:
                    ckpt.save(ckpt_dir, step, full, {"arch": cfg.name})
    report = {"history": history, "losses": losses,
              "grad_norms": grad_norms, "step_ms": step_ms,
              "n_params": n_params, "tokens_per_step": batch * seq,
              "params": params, "mesh": dict(mesh.shape)}
    if not history:                      # --steps 0: nothing ran, no summary
        log("no training steps run")
        return report
    log(f"step ms: median {statistics.median(step_ms):.3f}, min "
        f"{min(step_ms):.3f} over {len(step_ms)} steps (host clock, "
        "ending in the loss's copy to the host)")
    first, last = history[0]["loss"], history[-1]["loss"]
    log(f"loss {first:.3f} -> {last:.3f} "
          f"({'improved' if last < first else 'NO IMPROVEMENT'})")
    return report


if __name__ == "__main__":
    main()
