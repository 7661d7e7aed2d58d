"""Load-aware execution-plan dispatch (paper §4.5, Fig 7).

MobiRNN's finding: the accelerator is shared, so under low load offloading
wins and under high load another path can be faster — the runtime must
sense load and choose.  Each registered ``Plan`` carries a calibrated base
latency and a contention model; a ``LoadSensor`` supplies the current load;
``Scheduler.choose`` picks the predicted-fastest plan and ``Scheduler.run``
folds the observed latency back into the calibration (exponential moving
average), so the crossover point is learned, not assumed.  The sensors are
``SyntheticLoadSensor`` (injected load, for tests and the Fig 7
reproduction) and ``ProcLoadSensor`` (the host's normalised 1-minute load
average); ``Scheduler.decisions`` keeps the last ``MAX_DECISIONS``
choices.

The LSTM plans it schedules are core/lstm.FORWARD_PLANS; wire the
shared-memory budget table in with
``Scheduler(viable=core/lstm.plan_viability(...))`` so that ``fused_seq``
is never calibrated or chosen where it would run ``fused_cell`` instead.
Timing waits for the card: a plan whose output is on CUDA is followed by
``torch.cuda.synchronize()`` inside the timed region.
"""
from __future__ import annotations

import collections
import dataclasses
import os
import time
from typing import Callable, Protocol

import torch

from repro_torch.obs import trace as trace_lib


class LoadSensor(Protocol):
    def load(self) -> float: ...          # in [0, 1]


@dataclasses.dataclass
class SyntheticLoadSensor:
    """Injected load — used by tests and the Fig 7 reproduction."""
    value: float = 0.0

    def load(self) -> float:
        return min(max(self.value, 0.0), 1.0)


class ProcLoadSensor:
    """Real sensor: the 1-minute load average over the CPU count, at most 1
    (the /proc analogue of the paper's ADB / Adreno utilisation scripts);
    0 where the platform has no load average."""

    def __init__(self, n_cpus: int | None = None):
        self.n_cpus = n_cpus or os.cpu_count() or 1

    def load(self) -> float:
        try:
            return min(os.getloadavg()[0] / self.n_cpus, 1.0)
        except OSError:
            return 0.0


@dataclasses.dataclass
class Plan:
    """An executable plan with a latency-vs-load contention model.

    ``shared``: whether the plan contends with the sensed load (the paper's
    GPU is shared with rendering; a dedicated CPU reservation is not).
    predicted(load) = base / max(eps, 1 - sensitivity * load)  when shared.
    """
    name: str
    fn: Callable
    base_latency_s: float = float("inf")
    shared: bool = True
    sensitivity: float = 1.0
    ema: float = 0.3

    def predicted(self, load: float) -> float:
        if not self.shared:
            return self.base_latency_s
        denom = max(1e-3, 1.0 - self.sensitivity * load)
        return self.base_latency_s / denom

    def observe(self, latency_s: float, load: float) -> None:
        # invert the contention model to update the base estimate
        if self.shared:
            latency_s = latency_s * max(1e-3, 1.0 - self.sensitivity * load)
        if self.base_latency_s == float("inf"):
            self.base_latency_s = latency_s
        else:
            self.base_latency_s = ((1 - self.ema) * self.base_latency_s
                                   + self.ema * latency_s)


@dataclasses.dataclass
class Decision:
    plan: str
    load: float
    predicted_s: dict[str, float]


def block_until_ready(out) -> None:
    """Wait for the card when ``out`` (or a tensor in it) lives on CUDA."""
    tensors = out if isinstance(out, (tuple, list)) else (out,)
    for t in tensors:
        if isinstance(t, torch.Tensor) and t.is_cuda:
            torch.cuda.synchronize(t.device)
            return


class Scheduler:
    """``viable`` is an optional predicate ``plan_name -> bool`` filtering
    plans that cannot run on the current shapes (core/lstm.plan_viability).
    Non-viable plans are never calibrated and never chosen.  ``ladder``
    lists plan names most-expensive first; ``degrade``/``recover`` step
    ``level`` rungs of it out of and back into the choice.  ``decisions``
    keeps the last ``MAX_DECISIONS`` choices, oldest first."""

    #: bound of the decision history: a serving loop calls choose() once a
    #: tick for its whole life, so an unbounded list would grow without end
    MAX_DECISIONS = 4096

    def __init__(self, sensor: LoadSensor,
                 viable: Callable[[str], bool] | None = None,
                 ladder: list[str] | None = None):
        self.sensor = sensor
        self.viable = viable
        self.plans: dict[str, Plan] = {}
        self.decisions: collections.deque[Decision] = collections.deque(
            maxlen=self.MAX_DECISIONS)
        self.ladder: list[str] = list(ladder or [])
        self.level: int = 0

    def register(self, plan: Plan) -> None:
        self.plans[plan.name] = plan

    def _demoted(self) -> set[str]:
        return set(self.ladder[:self.level])

    def _viable_plans(self, viable: Callable[[str], bool] | None
                      ) -> dict[str, Plan]:
        pred = self.viable if viable is None else viable
        demoted = self._demoted()
        out = {n: p for n, p in self.plans.items()
               if (pred is None or pred(n)) and n not in demoted}
        if not out:
            raise ValueError(
                f"no viable plan among {sorted(self.plans)} — the viability "
                "predicate (or degradation level "
                f"{self.level}/{self.ladder}) rejected every registered plan")
        return out

    def degrade(self, reason: str = "slo") -> bool:
        """Step one rung down the ladder: exclude the next ladder plan from
        choose()/calibrate().  Refuses — returns False, state unchanged —
        when the ladder is spent or stepping down would leave no viable
        plan."""
        if self.level >= len(self.ladder):
            return False
        self.level += 1
        try:
            self._viable_plans(None)
        except ValueError:
            self.level -= 1
            return False
        tracer = trace_lib.get_tracer()
        if tracer.enabled:
            tracer.event("sched/degrade", level=self.level,
                         excluded=sorted(self._demoted()), reason=reason)
        return True

    def recover(self) -> bool:
        """Step one rung back up.  Returns False at level 0."""
        if self.level == 0:
            return False
        self.level -= 1
        tracer = trace_lib.get_tracer()
        if tracer.enabled:
            tracer.event("sched/recover", level=self.level,
                         excluded=sorted(self._demoted()))
        return True

    @staticmethod
    def _blocked_call(plan: Plan, args, kwargs):
        out = plan.fn(*args, **kwargs)
        block_until_ready(out)
        return out

    def calibrate(self, *args, repeats: int = 3,
                  viable: Callable[[str], bool] | None = None,
                  **kwargs) -> None:
        """Seed base latencies for each viable plan: ONE untimed warmup call
        (first-call costs such as building a kernel), then best of
        ``repeats`` timed calls.  Non-viable plans keep an infinite base."""
        tracer = trace_lib.get_tracer()
        for plan in self._viable_plans(viable).values():
            self._blocked_call(plan, args, kwargs)          # untimed warmup
            best = float("inf")
            for _ in range(repeats):
                t0 = time.perf_counter()
                self._blocked_call(plan, args, kwargs)
                best = min(best, time.perf_counter() - t0)
            plan.base_latency_s = best
            if tracer.enabled:
                tracer.event("sched/calibrate", plan=plan.name,
                             latency_s=best, source="measured")

    def choose(self, load: float | None = None,
               viable: Callable[[str], bool] | None = None) -> Decision:
        load = self.sensor.load() if load is None else load
        preds = {n: p.predicted(load)
                 for n, p in self._viable_plans(viable).items()}
        best = min(preds, key=preds.get)
        d = Decision(plan=best, load=load, predicted_s=preds)
        self.decisions.append(d)
        tracer = trace_lib.get_tracer()
        if tracer.enabled:
            tracer.event("sched/choose", plan=best, load=load,
                         predicted_s=preds[best], n_viable=len(preds))
        return d

    def run(self, *args, **kwargs):
        d = self.choose()
        plan = self.plans[d.plan]
        tracer = trace_lib.get_tracer()
        span = (tracer.span("sched/run", plan=d.plan, load=d.load)
                if tracer.enabled else trace_lib.NULL_SPAN)
        with span:
            t0 = time.perf_counter()
            out = self._blocked_call(plan, args, kwargs)
            latency = time.perf_counter() - t0
            span.set(latency_s=latency)
        plan.observe(latency, d.load)
        return out, d
