"""Train the paper's HAR classifier, then time every plan per window.

The port's twin of the JAX package's ``examples/train_har.py``, with the
same flags: builds the MobiRNN stacked LSTM (2 layers x 32 hidden by
default, weights drawn from ``--seed``), makes synthetic UCI-HAR-shaped
windows (repro_torch.data.har) and trains with AdamW (b2 0.95, global-norm
clip 1.0, a warmup-cosine schedule, no weight decay) through the plan named
by ``--plan``.  Under ``fused_seq`` a training step is two kernel launches
at any T: the trajectory-writing forward and the reverse-time BPTT sweep.
``fused_seq_q8`` trains quantization-aware: f32 master weights, quantized
to int8 inside every forward, straight-through gradients, and the same
two launches (their int8 instances).
Then the paper's §4.1 protocol: per-window latency over ``--latency-cases``
test windows for every plan (0 skips it).  ``train`` does the same for any
``LSTMConfig``, a bf16 one included (weights and windows in
``cfg.dtype``).

  PYTHONPATH=src python -m repro_torch.launch.train_har [--device cuda|cpu]
      [--steps N] [--plan fused_seq] [--batch 64] [--hidden H --layers L]

The default device is ``cuda``; without a card that raises rather than
running on the CPU.
"""
from __future__ import annotations

import argparse
import statistics
import time

import numpy as np
import torch

from repro_torch.configs.mobirnn_lstm import LSTMConfig
from repro_torch.core import lstm
from repro_torch.data import har
from repro_torch.launch.classify import latencies_ms, resolve_device
from repro_torch.optim.adamw import AdamW, tree_leaves, tree_map, warmup_cosine


def train_step(params: dict, state: dict, x: torch.Tensor, y: torch.Tensor,
               cfg: LSTMConfig, forward, opt: AdamW
               ) -> tuple[dict, torch.Tensor, torch.Tensor]:
    """One AdamW step on the batch (x, y) through ``forward``: the loss at
    the current parameters, their gradients by ``torch.autograd``, and the
    update, written into the parameter tensors and ``state`` in place.
    Returns the optimizer state, the loss and the gradient norm before
    clipping."""
    loss = lstm.loss_fn(params, x, y, cfg, forward=forward)
    flat = iter(torch.autograd.grad(loss, tree_leaves(params)))
    grads = tree_map(lambda _: next(flat), params)
    metrics = opt.update_(grads, state, params)
    return state, loss.detach(), metrics["grad_norm"]


def train(cfg: LSTMConfig, device: torch.device, *, plan: str = "sequential",
          steps: int = 300, batch: int = 64, lr: float = 3e-3,
          latency_cases: int = 100, n_train: int = 7352, n_test: int = 2947,
          seed: int = 0) -> dict:
    """Train ``cfg``'s classifier through ``plan`` for ``steps`` AdamW steps
    on batches of ``batch`` windows, then time every plan per window over
    ``latency_cases`` test windows (0 skips it).  The weights are drawn in
    ``cfg.dtype`` and the windows reach the plans in it.  Returns the
    losses, gradient norms and step times (ms) of every step, the final
    test accuracy, the per-plan latency (ms a window) and the trained
    parameters."""
    forward = lstm.FORWARD_PLANS[plan]
    dtype = getattr(torch, cfg.dtype)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"config: {cfg.name} ({cfg.n_layers}L x {cfg.hidden}H, "
          f"{cfg.dtype}) plan={plan} on {where}")
    train_set, test = har.make_har(n_train, n_test, seed=seed)
    print(f"data: {len(train_set.y)} train / {len(test.y)} test windows "
          "(UCI HAR protocol)")
    test_x = torch.tensor(test.x, device=device).to(dtype)
    test_y = torch.tensor(test.y, device=device, dtype=torch.long)

    model = lstm.LSTMClassifier(
        cfg, generator=torch.Generator().manual_seed(seed)).to(device)
    params = model.params()
    opt = AdamW(lr=warmup_cosine(lr, steps // 10, steps), weight_decay=0.0)
    state = opt.init(params)

    def accuracy(n: int) -> float:
        with torch.inference_mode():
            return float(lstm.accuracy(params, test_x[:n], test_y[:n], cfg,
                                       forward=forward))

    # a batch larger than the train set would make har.batches yield nothing
    it = har.batches(train_set, min(batch, len(train_set.y)), seed=seed)
    losses, norms, step_ms = [], [], []
    t_start = time.perf_counter()
    for i in range(1, steps + 1):
        bx, by = next(it)
        x = torch.from_numpy(bx).to(device=device, dtype=dtype)
        y = torch.from_numpy(by).to(device=device, dtype=torch.long)
        t0 = time.perf_counter()
        state, loss, gnorm = train_step(params, state, x, y, cfg, forward,
                                        opt)
        losses.append(float(loss))         # waits for the step's last kernel
        step_ms.append((time.perf_counter() - t0) * 1e3)
        norms.append(float(gnorm))
        if i % 50 == 0 or i == 1:
            print(f"step {i:4d} loss {losses[-1]:.4f} test_acc "
                  f"{accuracy(min(512, len(test.y))):.1%} "
                  f"({time.perf_counter() - t_start:.0f}s)")
    acc = accuracy(len(test.y))
    print(f"\nfinal test accuracy: {acc:.2%}; median step "
          f"{statistics.median(step_ms):.3f} ms")

    latency: dict[str, float] = {}
    n_cases = min(latency_cases, len(test.y))
    if n_cases > 0:
        idx = np.random.default_rng(0).choice(len(test.y), n_cases,
                                              replace=False)
        cases = test_x[torch.from_numpy(idx).to(device)]
        print(f"\nlatency for {n_cases} test cases (paper Fig 4 protocol):")
        with torch.inference_mode():
            for name, fwd in lstm.FORWARD_PLANS.items():
                times, _ = latencies_ms(fwd, params, cases, cfg)
                latency[name] = statistics.fmean(times)
                print(f"  {name:12s} {sum(times):8.1f} ms total "
                      f"({latency[name]:.2f} ms/case)")
    return {"losses": losses, "grad_norms": norms, "step_ms": step_ms,
            "accuracy": acc, "latency": latency, "params": params}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--batch", type=int, default=64)
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--plan", default="sequential",
                    choices=sorted(lstm.FORWARD_PLANS),
                    help="execution plan of the training step; fused_seq "
                         "and fused_seq_q8 are two kernel launches a step "
                         "at any T")
    ap.add_argument("--latency-cases", type=int, default=100,
                    help="test windows for the paper §4.1 latency protocol "
                         "(0 skips it)")
    ap.add_argument("--n-train", type=int, default=7352,
                    help="synthetic train windows (UCI HAR protocol size)")
    ap.add_argument("--n-test", type=int, default=2947)
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights, the windows and the batches")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = LSTMConfig().with_complexity(args.hidden, args.layers)
    return train(cfg, device, plan=args.plan, steps=args.steps,
                 batch=args.batch, lr=args.lr,
                 latency_cases=args.latency_cases, n_train=args.n_train,
                 n_test=args.n_test, seed=args.seed)


if __name__ == "__main__":
    main()
