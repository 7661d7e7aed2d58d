"""Serving example of the PyTorch/CUDA port (the twin of
``examples/serve_lm.py``): a reduced qwen2 under the MobiRNN runtime
policies — preallocated cache pools, load-aware plan dispatch (paper Fig 7,
for LLM decode) — comparing the two engines:

  * wave (Engine):       lockstep batches, padded to the slowest request;
  * slot (SlotEngine):   slot-resident continuous batching — per-lane
                         admission/retirement over one preallocated cache,
                         tokens streamed per tick, the decode tick captured
                         in a CUDA graph on the card.

  PYTHONPATH=src python examples/serve_lm_torch.py [--device cuda|cpu]
  PYTHONPATH=src python examples/serve_lm_torch.py --trace serve_trace.jsonl
  PYTHONPATH=src python examples/serve_lm_torch.py --chaos

The default device is ``cuda``; without a card that raises rather than
running on the CPU (``--device cpu`` runs there, the ticks eager).

With ``--trace`` the whole run is recorded and written as JSONL (per-tick
serve/tick spans with the chosen plan, serve/admit events with per-request
TTFT, nested sched/choose decisions, and a final serve/metrics summary —
see ROADMAP §Observability for the schema).

With ``--chaos`` the slot engine runs under a seeded FaultPlan
(ROADMAP §Robustness): the client submits through the bounded queue with
EXPONENTIAL BACKOFF on QueueFull, the engine quarantines poisoned lanes /
retries failed prefills / steps its degradation ladder, and the run ends
with the per-reason retirement breakdown over the closed finish_reason
set.
"""
import argparse
import collections
import time

import numpy as np
import torch

from repro_torch import steps as steps_lib
from repro_torch.configs import get_arch
from repro_torch.core.scheduler import SyntheticLoadSensor
from repro_torch.launch.classify import resolve_device
from repro_torch.models import registry
from repro_torch.obs import trace as trace_lib
from repro_torch.serving import (Engine, EngineConfig, FaultPlan, QueueFull,
                                 Request, SlotEngine)


def make_requests(cfg, rng):
    # ragged on purpose: mixed prompt lengths, 8x max_new spread — the
    # workload where continuous batching beats waves
    lens = [8, 12, 6, 16, 8, 12, 6, 16, 8, 12, 6, 16]
    news = [2, 16, 4, 8, 16, 2, 8, 4, 16, 2, 4, 8]
    return [Request(i, rng.integers(0, cfg.vocab, (n,)).astype(np.int32),
                    max_new_tokens=m)
            for i, (n, m) in enumerate(zip(lens, news))]


def run_chaos(cfg, model, params) -> None:
    rng = np.random.default_rng(1)
    reqs = make_requests(cfg, rng)
    plan = FaultPlan.seeded(
        0, n_slots=2, ticks=16, uids=tuple(r.uid for r in reqs),
        n_poison=2, n_prefill=1, n_slow_burst=1, slow_extra_s=1e6,
        n_flood=1, flood_n=2)
    kinds = collections.Counter(type(f).__name__ for f in plan.faults)
    print(f"chaos: seed={plan.seed} schedule="
          + " ".join(f"{k}x{n}" for k, n in sorted(kinds.items())))

    # small queue ON PURPOSE: the client below must hit QueueFull and
    # back off, which is the intended reaction to engine backpressure
    engine = SlotEngine(
        model, params,
        config=EngineConfig(
            n_slots=2, max_seq=64, queue_capacity=3,
            faults=plan, retry_budget=1, retry_backoff_s=0.005,
            tick_slo_s=50.0, slo_breach_ticks=3, slo_recover_ticks=8,
            ladder=["decode/base"]),
        extra_plans={"decode/fallback":
                     lambda p, c, b: steps_lib.decode_step(cfg, p, c, b)})

    pending = collections.deque(reqs)
    backoff_s, backoffs = 0.005, 0

    def pump() -> None:
        # exponential backoff on QueueFull: sleep, double the delay, and
        # yield control back to the stream so the engine can drain lanes;
        # any accepted submit resets the delay to its floor
        nonlocal backoff_s, backoffs
        while pending:
            try:
                engine.submit(pending[0])
            except QueueFull:
                backoffs += 1
                time.sleep(backoff_s)
                backoff_s = min(backoff_s * 2, 0.08)
                return
            pending.popleft()            # queued (or retired dead-on-arrival)
            backoff_s = 0.005

    n_tokens = 0
    while pending:
        pump()
        for ev in engine.stream():
            n_tokens += ev.token is not None
            if pending:
                pump()

    results = engine.take_finished()
    breakdown = collections.Counter(r.finish_reason for r in results.values())
    print(f"chaos: {len(results)} retired ({n_tokens} tokens streamed), "
          "breakdown: "
          + " ".join(f"{k}={n}" for k, n in sorted(breakdown.items())))
    m = engine.metrics
    print(f"chaos: client QueueFull backoffs={backoffs}; engine "
          f"quarantined={m.counter('serving/quarantined').value} "
          f"retries={m.counter('serving/retries').value} "
          f"shed={m.counter('serving/shed').value} "
          f"deadline_miss={m.counter('serving/deadline_miss').value}")
    print(f"chaos: ladder level={engine.scheduler.level} "
          f"(0 = recovered); resident pool: {engine.pool.stats}")


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--trace", metavar="PATH", default=None,
                    help="write a structured JSONL trace of the run")
    ap.add_argument("--chaos", action="store_true",
                    help="run the slot engine under a seeded FaultPlan "
                         "with client-side backoff on QueueFull")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    args = ap.parse_args()
    device = resolve_device(args.device)
    tracer = trace_lib.configure(args.trace) if args.trace else None

    cfg = get_arch("qwen2-0.5b").reduced()
    model = registry.build(cfg)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device)
    print(f"serving {cfg.name} on {device}: vocab={cfg.vocab} "
          f"layers={cfg.n_layers}")

    if args.chaos:
        run_chaos(cfg, model, params)
    else:
        rng = np.random.default_rng(0)
        reqs = make_requests(cfg, rng)
        n_tok = sum(r.max_new_tokens for r in reqs)

        sensor = SyntheticLoadSensor(0.0)
        wave = Engine(model, params, sensor=sensor, config=EngineConfig(
            n_slots=4, max_seq=64, pool_capacity=2))
        slot = SlotEngine(model, params, sensor=sensor, config=EngineConfig(
            n_slots=4, max_seq=64, queue_capacity=8))

        wave.serve(reqs)               # warm both engines up once so the
        slot.serve(reqs)               # printed rows are steady-state

        for load in (0.0, 0.85):
            sensor.value = load
            for name, engine in (("wave", wave), ("slot", slot)):
                t0 = time.time()
                results = engine.serve(reqs)
                wall = time.time() - t0
                plans = {p for r in results for p in r.plan_decisions}
                print(f"load={load:.0%} {name}: {len(results)} requests, "
                      f"{n_tok} tokens, {n_tok / wall:.1f} tok/s, "
                      f"plans used: {plans}")

        # streaming: tokens surface per tick, not when the whole batch
        # drains; TTFT is measured by the engine itself (admit -> first
        # token on host), per request and as a p50/p99 histogram
        results = slot.serve(reqs)
        for r in sorted(results, key=lambda r: r.ttft_s)[:3]:
            print(f"  uid={r.uid}: ttft={r.ttft_s * 1e3:.1f}ms "
                  f"decode={r.decode_s * 1e3:.1f}ms "
                  f"tokens={r.tokens.shape[-1]}")
        ttft = slot.metrics.histogram("serving/ttft_s").summary()
        tbt = slot.metrics.histogram("serving/tbt_s").summary()
        print(f"slot streaming: ttft p50={ttft['p50'] * 1e3:.1f}ms "
              f"p99={ttft['p99'] * 1e3:.1f}ms; "
              f"tbt p50={tbt['p50'] * 1e3:.2f}ms p99={tbt['p99'] * 1e3:.2f}ms;"
              f" decode tick "
              + ("a replayed CUDA graph" if slot.ticks["decode/base"].graph
                 is not None else "eager"))
        print("resident pool:", slot.pool.stats)
    if tracer is not None:
        tracer.close()
        print(f"wrote the trace to {args.trace}")


if __name__ == "__main__":
    main()
