"""Measured kernel profiler — the on-device half of MobiRNN's tuning loop
(the twin of the JAX package's ``obs/profile.py``).

The paper's claim is that tiling and plan choices must be tuned per device
and per load; the budget tables (``choose_batch_block``, ``choose_blocks``)
are analytic.  This module closes the loop:

* ``profile_families`` sweeps the tiling surface each family publishes
  through ``Family.profile_hook`` (core/plans.py) — the hand kernels at
  concrete ``(block_b, time_chunk)``, ``(bh_tile, chunk)`` and
  ``(di_tile, chunk)`` points — timing each with ``time_fn``.
* The result persists as a ``DeviceProfile`` keyed on
  ``cuda:<device name>`` and the shared-memory budget it was swept under,
  so a profile measured on one card never silently seeds another.
* ``Scheduler.calibrate(profile=DeviceProfile.best_latencies(...))``
  seeds plan base latencies from the measurement instead of timing every
  plan cold (core/scheduler.py).
* ``model_vs_measured`` joins each point against its analytic roofline
  (``analysis.*_stream_costs``) and flags ratios outside a band.

The JSON is the JAX package's schema, so either package's
``DeviceProfile.from_json`` reads the other's file; its budget field
``vmem_budget`` holds, here, the shared memory a thread block may use
(``DeviceProfile.smem_budget``).  A sweep runs where ``device`` says, by
default the card (``chip_smoke.py`` P2 sweeps the kernel table's shapes).
"""
from __future__ import annotations

import dataclasses
import json
import math
import time
from typing import Any, Callable, Mapping

import torch


def device_kind(device="cuda") -> str:
    """Profile key half 1: ``cuda:<name>`` of a CUDA device, ``cpu:cpu``
    for the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        return f"cuda:{torch.cuda.get_device_name(device)}"
    return "cpu:cpu"


def _sync(out: Any) -> None:
    """Wait for the card when ``out`` (or a tensor in it) lives there."""
    tensors = out if isinstance(out, (tuple, list)) else (out,)
    if any(isinstance(t, torch.Tensor) and t.is_cuda for t in tensors):
        torch.cuda.synchronize()


def time_fn(fn: Callable, *args, repeats: int = 3, warmup: int = 1) -> float:
    """Best-of-``repeats`` wall time in seconds of ``fn(*args)``, after
    ``warmup`` untimed calls (the kernel's build and first launch), with
    ``torch.cuda.synchronize()`` inside the timed region when the result is
    on the card."""
    for _ in range(max(0, warmup)):
        _sync(fn(*args))
    best = float("inf")
    for _ in range(max(1, repeats)):
        t0 = time.perf_counter()
        _sync(fn(*args))
        best = min(best, time.perf_counter() - t0)
    return best


@dataclasses.dataclass
class ProfilePoint:
    """One measured point on a family's viable tiling surface."""
    family: str
    plan: str
    point: dict[str, Any]            # tiling coordinates, JSON-able
    measured_s: float
    model_s: float | None = None     # analytic roofline seconds, if modeled

    @property
    def ratio(self) -> float | None:
        """measured / modeled — the divergence the report flags."""
        if self.model_s is None or self.model_s <= 0:
            return None
        return self.measured_s / self.model_s

    def to_json(self) -> dict:
        return dataclasses.asdict(self)

    @classmethod
    def from_json(cls, obj: dict) -> "ProfilePoint":
        return cls(**obj)


@dataclasses.dataclass
class DeviceProfile:
    """A persisted sweep: every point measured on ONE device under ONE
    shared-memory budget.  ``key`` is the identity ``calibrate`` callers
    should match before trusting the numbers."""
    device_kind: str
    smem_budget: int
    points: list[ProfilePoint]
    meta: dict = dataclasses.field(default_factory=dict)

    @property
    def key(self) -> str:
        return f"{self.device_kind}/smem{self.smem_budget}"

    def families(self) -> list[str]:
        return sorted({p.family for p in self.points})

    def best_latencies(self, rename: Mapping[str, str] | None = None
                       ) -> dict[str, float]:
        """Per-plan best measured seconds — the mapping
        ``Scheduler.calibrate(profile=...)`` consumes.  ``rename`` maps a
        family plan name to the scheduler's registered name."""
        out: dict[str, float] = {}
        for p in self.points:
            name = p.plan if rename is None else rename.get(p.plan, p.plan)
            if name not in out or p.measured_s < out[name]:
                out[name] = p.measured_s
        return out

    def to_json(self) -> dict:
        return {"device_kind": self.device_kind,
                "vmem_budget": self.smem_budget,     # the schema's name
                "meta": self.meta,
                "points": [p.to_json() for p in self.points]}

    @classmethod
    def from_json(cls, obj: dict) -> "DeviceProfile":
        return cls(device_kind=obj["device_kind"],
                   smem_budget=int(obj["vmem_budget"]),
                   points=[ProfilePoint.from_json(p) for p in obj["points"]],
                   meta=obj.get("meta", {}))

    def save(self, path: str) -> str:
        with open(path, "w", encoding="utf-8") as fh:
            json.dump(self.to_json(), fh, indent=2, sort_keys=True)
            fh.write("\n")
        return path

    @classmethod
    def load(cls, path: str) -> "DeviceProfile":
        with open(path, "r", encoding="utf-8") as fh:
            return cls.from_json(json.load(fh))


def candidates(families: tuple[str, ...] = ("lstm", "rwkv6", "mamba"), *,
               smem_budget: int | None = None, max_points: int = 4,
               hook_kwargs: Mapping[str, dict] | None = None,
               device="cuda") -> list:
    """Every family's ``ProfileCandidate``s, in order, on ``device``."""
    from repro_torch.core import factorization
    from repro_torch.core import plans as plans_lib

    budget = factorization.H100_SMEM_PER_BLOCK if smem_budget is None \
        else smem_budget
    out = []
    for name in families:
        fam = plans_lib.get_family(name)
        if fam.profile_hook is None:
            raise ValueError(f"family {name!r} registers no profile_hook")
        kwargs = dict((hook_kwargs or {}).get(name, {}))
        out += fam.profile_hook(smem_budget=budget, max_points=max_points,
                                device=device, **kwargs)
    return out


def profile_families(families: tuple[str, ...] = ("lstm", "rwkv6",
                                                  "mamba"), *,
                     smem_budget: int | None = None, repeats: int = 2,
                     warmup: int = 1, max_points: int = 4,
                     hook_kwargs: Mapping[str, dict] | None = None,
                     device="cuda") -> DeviceProfile:
    """Sweep each family's profile hook and measure every candidate.

    ``hook_kwargs`` passes per-family shape overrides through to the hook
    (e.g. ``{"lstm": {"seq_len": 16}}``).  Emits a ``profile/point`` trace
    event per measurement when tracing is on."""
    from repro_torch.core import factorization
    from repro_torch.obs import trace as trace_lib

    budget = factorization.H100_SMEM_PER_BLOCK if smem_budget is None \
        else smem_budget
    tr = trace_lib.get_tracer()
    points: list[ProfilePoint] = []
    for c in candidates(families, smem_budget=budget, max_points=max_points,
                        hook_kwargs=hook_kwargs, device=device):
        measured = time_fn(c.fn, *c.args, repeats=repeats, warmup=warmup)
        pt = ProfilePoint(c.family, c.plan, dict(c.point), measured,
                          c.model_s)
        points.append(pt)
        if tr.enabled:
            tr.event("profile/point", family=pt.family, plan=pt.plan,
                     measured_s=pt.measured_s, model_s=pt.model_s,
                     **pt.point)
    return DeviceProfile(device_kind(device), int(budget), points)


def model_vs_measured(profile: DeviceProfile,
                      threshold: float | None = None) -> list[dict]:
    """One row per profiled point: measured, modeled, and their ratio.

    ``threshold`` (>1) flags rows whose ratio falls outside
    ``[1/threshold, threshold]`` as ``diverged``.  Rows without an analytic
    model carry ``ratio=None`` and are never flagged."""
    if threshold is not None and threshold <= 1:
        raise ValueError("threshold must be > 1 (a symmetric band)")
    rows = []
    for p in profile.points:
        r = p.ratio
        diverged = (threshold is not None and r is not None
                    and not (1.0 / threshold <= r <= threshold))
        rows.append({"family": p.family, "plan": p.plan, "point": p.point,
                     "measured_s": p.measured_s, "model_s": p.model_s,
                     "ratio": r, "finite": r is not None and math.isfinite(r),
                     "diverged": diverged})
    return rows

