"""Serve the paper's HAR classifier: one sensor window per request.

Builds the MobiRNN stacked LSTM (2 layers x 32 hidden by default, weights
drawn from ``--seed``), makes synthetic HAR test windows
(repro_torch.data.har) and answers ``--requests`` single-window requests —
the paper's §4.1 latency protocol.  For every plan it serves (all five with
``--plan auto``, else the one named; ``fused_seq_q8`` holds the weights as
int8 with f32 per-column scales) it prints the per-request latency, host
clock around a call that ends in ``torch.cuda.synchronize()``.  With
``--plan auto`` the Fig 7 scheduler calibrates every viable plan on one
window (``core/lstm.plan_viability``: the f32 and int8 budget tables),
chooses, and answers the requests through its choice.  ``serve`` takes any
``LSTMConfig``: a bf16 one serves its windows and weights in bf16, its
budget table priced at 2 bytes an element.

  PYTHONPATH=src python -m repro_torch.launch.classify [--device cuda|cpu]
      [--requests N] [--plan auto|<name>] [--hidden H --layers L]

The default device is ``cuda``; without a card that raises rather than
running on the CPU.
"""
from __future__ import annotations

import argparse
import statistics
import time

import torch

from repro_torch.configs.mobirnn_lstm import LSTMConfig
from repro_torch.core import lstm
from repro_torch.core.scheduler import (Plan, Scheduler, SyntheticLoadSensor,
                                        block_until_ready)
from repro_torch.data import har


def resolve_device(name: str) -> torch.device:
    """``cpu`` or ``cuda``; asking for ``cuda`` without a card raises."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda needs a CUDA device and none is "
                           "available; pass --device cpu to run on the CPU")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"--device must be cpu or cuda, not {name!r}")
    return device


def latencies_ms(fn, params: dict, windows: torch.Tensor,
                  cfg: LSTMConfig) -> tuple[list[float], torch.Tensor]:
    """Answer each window as its own request; per-request ms and logits."""
    block_until_ready(fn(params, windows[:1], cfg))          # untimed warmup
    times, outs = [], []
    for j in range(windows.shape[0]):
        t0 = time.perf_counter()
        out = fn(params, windows[j:j + 1], cfg)
        block_until_ready(out)
        times.append((time.perf_counter() - t0) * 1e3)
        outs.append(out)
    return times, torch.cat(outs)


def serve(cfg: LSTMConfig, device: torch.device, *, requests: int = 32,
          plan: str = "auto", seed: int = 0) -> dict:
    """Answer ``requests`` single-window requests; returns the per-plan
    latency table (ms), the plan that answered (``served``), the chosen
    plan under ``auto`` (else None) and the served logits (requests, C).
    The windows reach the plans in ``cfg.dtype``, the weights' dtype; the
    scheduler's budget table is priced at that width."""
    if plan != "auto" and plan not in lstm.FORWARD_PLANS:
        raise ValueError(f"unknown plan {plan!r}")
    dtype = getattr(torch, cfg.dtype)
    where = torch.cuda.get_device_name(device) if device.type == "cuda" \
        else "cpu"
    print(f"config: {cfg.name} ({cfg.n_layers}L x {cfg.hidden}H, "
          f"T={cfg.seq_len}, {cfg.input_dim} sensors, {cfg.dtype}) on {where}")
    _, test = har.make_har(n_train=1, n_test=requests, seed=seed)
    windows = torch.tensor(test.x, device=device).to(dtype)
    labels = torch.tensor(test.y, device=device, dtype=torch.long)
    model = lstm.LSTMClassifier(
        cfg, generator=torch.Generator().manual_seed(seed)).to(device)
    params = model.params()
    names = list(lstm.FORWARD_PLANS) if plan == "auto" else [plan]
    table: dict[str, dict] = {}
    with torch.inference_mode():
        for name in names:
            times, _ = latencies_ms(lstm.FORWARD_PLANS[name], params,
                                     windows, cfg)
            table[name] = {"mean_ms": statistics.fmean(times),
                           "p50_ms": statistics.median(times),
                           "max_ms": max(times)}
        chosen = None
        if plan == "auto":
            width = windows.element_size()
            sched = Scheduler(SyntheticLoadSensor(0.0),
                              viable=lstm.plan_viability(
                                  cfg, 1, cfg.seq_len, dtype_bytes=width,
                                  w_dtype_bytes=width))
            for name in names:
                sched.register(Plan(name, lstm.FORWARD_PLANS[name]))
            sched.calibrate(params, windows[:1], cfg)
            chosen = sched.choose().plan
        served = chosen or plan
        _, logits = latencies_ms(lstm.FORWARD_PLANS[served], params,
                                  windows, cfg)
        acc = float((logits.argmax(-1) == labels).float().mean())
    return {"table": table, "chosen": chosen, "served": served,
            "logits": logits, "accuracy": acc}


def main(argv: list[str] | None = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--requests", type=int, default=32)
    ap.add_argument("--plan", default="auto",
                    choices=("auto", *lstm.FORWARD_PLANS))
    ap.add_argument("--hidden", type=int, default=32)
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the weights and the request windows")
    args = ap.parse_args(argv)

    device = resolve_device(args.device)
    cfg = LSTMConfig().with_complexity(args.hidden, args.layers)
    out = serve(cfg, device, requests=args.requests, plan=args.plan,
                seed=args.seed)
    print(f"latency per single-window request over {args.requests} "
          "requests (paper §4.1 protocol):")
    for name, row in out["table"].items():
        print(f"  {name:12s} mean {row['mean_ms']:9.3f} ms  p50 "
              f"{row['p50_ms']:9.3f} ms  max {row['max_ms']:9.3f} ms")
    if out["chosen"] is not None:
        print(f"scheduler chose: {out['chosen']}")
    print(f"answered {args.requests} requests through {out['served']}; "
          f"accuracy {out['accuracy']:.1%} (untrained weights)")
    return out


if __name__ == "__main__":
    main()
