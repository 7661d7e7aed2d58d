"""Family-generic execution-plan registry (the twin of the JAX package's
``core/plans.py``), with the LSTM family registered.

A family registers the same things the JAX package's does:

* named **plans** (``PlanSpec``) — alternative executions of one function,
  each with an **equivalence policy** (``EquivalencePolicy``): exact plans
  must match the family's oracle within per-dtype float tolerance, band
  plans (the int8-weight LSTM plan) within a documented error band — and,
  where fixed, the expected hand-kernel launches forward and per training
  step (the JAX package's ``fwd_dispatches``/``train_dispatches``: the
  O(1)-in-T contract);
* a **viability** factory: the shared-memory budget table behind the Fig 7
  scheduler's ``viable=`` predicate (``core/lstm.plan_viability``);
* **cases** — the family's deliberately awkward shapes; ``value_sweep`` and
  ``grad_sweep`` enumerate plans x cases x dtypes from them.

The ``lstm`` family's plans are ``core/lstm.FORWARD_PLANS`` (the registry
points at the same callables).  Its dtypes are ``("float32",)``: the
kernels raise ``TypeError`` on anything else until the bf16 slice, so the
bf16 entries of the tolerance tables (kept, as the JAX package has them)
are not swept.  ``profile_hook`` is None: the JAX family's hook prices each
candidate tiling with a TPU roofline (``analysis.lstm_seq_stream_costs``),
which says nothing about an H100; it waits for the profiler slice.

The RWKV6 and Mamba families come with their slices.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple

import torch


class EquivalencePolicy(NamedTuple):
    """How close to the family oracle a plan must stay.

    ``kind`` is "exact" (same function, float tolerance) or "band"
    (documented approximation, e.g. the int8 error band).  ``tol`` maps
    dtype name -> ``assert_close`` kwargs (rtol/atol) for values;
    ``grad_tol`` the same for gradients — a dtype absent from ``grad_tol``
    is excluded from the gradient sweep (the q8 plan's gradient contract is
    agreement with the straight-through reference, not with the f32
    oracle's gradients)."""
    kind: str
    tol: dict[str, dict]
    grad_tol: dict[str, dict] | None = None


class PlanSpec(NamedTuple):
    """One named execution plan of a family, with the hand-kernel launches
    of one forward and of one training step (None: not fixed, e.g. the
    per-cell plan's T x L)."""
    name: str
    fn: Callable
    policy: EquivalencePolicy
    fwd_launches: int | None = None
    train_launches: int | None = None


class Case(NamedTuple):
    """One sweep shape.  ``heavy`` cases are the slow ones of the value
    sweep; the gradient sweep also marks ``heavy_grad`` (and every
    non-float32 dtype) heavy."""
    label: str
    shape: tuple
    heavy: bool = False
    heavy_grad: bool = True


@dataclasses.dataclass(frozen=True)
class Family:
    """A recurrence family: plans + oracle + cases + budget model."""
    name: str
    oracle: str
    plans: dict[str, PlanSpec]
    cases: tuple[Case, ...]
    dtypes: tuple[str, ...]
    #: (case, dtype) -> opaque inputs object for apply/grads
    make_inputs: Callable[[Case, str], Any]
    #: (plan_name, inputs) -> tensor (or tree of tensors) to compare
    apply: Callable[[str, Any], Any]
    #: (plan_name, inputs) -> tree of gradient tensors
    grads: Callable[[str, Any], Any]
    #: family-specific keyword signature; returns the Fig 7 ``viable=``
    #: predicate (plan name -> bool) from the shared-memory budget table
    viability: Callable[..., Callable[[str], bool]]
    #: measured-profiler hook; None: the family has none yet
    profile_hook: Callable[..., list] | None = None

    def comparable_plans(self) -> list[str]:
        return [n for n in self.plans if n != self.oracle]

    def tol(self, plan: str, dtype: str) -> dict:
        return self.plans[plan].policy.tol[dtype]

    def grad_tol(self, plan: str, dtype: str) -> dict | None:
        gt = self.plans[plan].policy.grad_tol
        return None if gt is None else gt.get(dtype)


FAMILIES: dict[str, Family] = {}


def register_family(family: Family) -> Family:
    if family.oracle not in family.plans:
        raise ValueError(f"oracle {family.oracle!r} not among plans "
                         f"{list(family.plans)}")
    FAMILIES[family.name] = family
    return family


def get_family(name: str) -> Family:
    return FAMILIES[name]


# ---------------------------------------------------------------------------
# Sweep generation
# ---------------------------------------------------------------------------
class SweepCase(NamedTuple):
    family: str
    plan: str
    case: Case
    dtype: str
    heavy: bool

    @property
    def id(self) -> str:
        return f"{self.family}-{self.plan}-{self.case.label}-{self.dtype}"


def value_sweep() -> list[SweepCase]:
    """plans x cases x dtypes for every registered family (oracle
    excluded — it is the reference, not a claim)."""
    out = []
    for fam in FAMILIES.values():
        for plan in fam.comparable_plans():
            for case in fam.cases:
                for dtype in fam.dtypes:
                    if dtype not in fam.plans[plan].policy.tol:
                        continue
                    out.append(SweepCase(fam.name, plan, case, dtype,
                                         heavy=case.heavy))
    return out


def grad_sweep() -> list[SweepCase]:
    """Gradient sweep: only (plan, dtype) pairs whose policy carries a
    ``grad_tol``."""
    out = []
    for fam in FAMILIES.values():
        for plan in fam.comparable_plans():
            for case in fam.cases:
                for dtype in fam.dtypes:
                    if fam.grad_tol(plan, dtype) is None:
                        continue
                    heavy = case.heavy_grad or dtype != "float32"
                    out.append(SweepCase(fam.name, plan, case, dtype, heavy))
    return out


def scheduler_viability(bindings: dict[str, tuple[str, Callable[[str], bool]]]
                        ) -> Callable[[str], bool]:
    """Combine per-family viability predicates into the single
    ``Scheduler(viable=...)`` callable.  ``bindings`` maps a scheduler plan
    name to ``(family_plan_name, family_predicate)``; names bound to no
    family stay always viable."""
    def viable(plan_name: str) -> bool:
        bound = bindings.get(plan_name)
        if bound is None:
            return True
        family_plan, predicate = bound
        return predicate(family_plan)

    return viable


# ===========================================================================
# lstm family — FORWARD_PLANS served through the registry, names unchanged
# ===========================================================================
#: per-dtype tolerance of the exact LSTM plans vs forward_sequential
LSTM_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
            "bfloat16": dict(rtol=5e-2, atol=5e-2)}
LSTM_GRAD_TOL = {"float32": dict(rtol=2e-4, atol=2e-5),
                 "bfloat16": dict(rtol=8e-2, atol=8e-2)}
#: the documented int8 error band: per-output-channel symmetric int8 keeps
#: each dequantized weight within max|w_col|/254 of f32, and the saturating
#: LSTM nonlinearities keep the recurrence from amplifying it
Q8_BAND = dict(rtol=5e-2, atol=5e-2)

_LSTM_EXACT = EquivalencePolicy("exact", LSTM_TOL, LSTM_GRAD_TOL)
#: the q8 plan: banded values and no oracle gradient contract
_LSTM_Q8 = EquivalencePolicy("band", {d: Q8_BAND for d in ("float32",)},
                             grad_tol=None)

#: (batch, seq_len, hidden, input_dim, n_layers) — none block-aligned
_LSTM_CASES = (
    Case("b3t7h48d9l2", (3, 7, 48, 9, 2), heavy_grad=False),  # canonical
    Case("b1t5h33d9l3", (1, 5, 33, 9, 3)),    # B=1, hidden not lane-aligned
    Case("b5t3h16d40l2", (5, 3, 16, 40, 2)),  # input_dim > hidden: P padding
)


def _lstm_make_inputs(case: Case, dtype: str):
    """(cfg, params, x, labels) on the CPU, drawn from fixed seeds."""
    from repro_torch.configs.mobirnn_lstm import LSTMConfig
    from repro_torch.core import lstm

    b, t, h, d, n_layers = case.shape
    cfg = dataclasses.replace(LSTMConfig(), hidden=h, input_dim=d,
                              n_layers=n_layers, seq_len=t, dtype=dtype)
    params = lstm.init_params(torch.Generator().manual_seed(0), cfg)
    x = torch.randn(b, t, d, generator=torch.Generator().manual_seed(1)).to(
        getattr(torch, dtype))
    labels = torch.arange(b) % cfg.n_classes
    return cfg, params, x, labels


def _lstm_apply(plan: str, inputs):
    from repro_torch.core import lstm

    cfg, params, x, _ = inputs
    return lstm.FORWARD_PLANS[plan](params, x, cfg)


def _lstm_grads(plan: str, inputs):
    """Gradients of ``loss_fn`` through ``plan`` at trainable copies of
    the params, as a tree shaped like them."""
    from repro_torch.core import lstm
    from repro_torch.optim.adamw import tree_leaves, tree_map

    cfg, params, x, labels = inputs
    params = tree_map(lambda p: p.detach().clone().requires_grad_(), params)
    loss = lstm.loss_fn(params, x, labels, cfg,
                        forward=lstm.FORWARD_PLANS[plan])
    flat = iter(torch.autograd.grad(loss, tree_leaves(params)))
    return tree_map(lambda _: next(flat), params)


def _lstm_viability(*args, **kwargs):
    from repro_torch.core import lstm

    return lstm.plan_viability(*args, **kwargs)


def _build_lstm_family() -> Family:
    from repro_torch.core import lstm

    specs: dict[str, PlanSpec] = {}
    for name, fn in lstm.FORWARD_PLANS.items():
        if name == "fused_seq_q8":
            spec = PlanSpec(name, fn, _LSTM_Q8, fwd_launches=1,
                            train_launches=2)
        elif name == "fused_seq":
            spec = PlanSpec(name, fn, _LSTM_EXACT, fwd_launches=1,
                            train_launches=2)
        else:
            spec = PlanSpec(name, fn, _LSTM_EXACT)
        specs[name] = spec
    return Family(
        name="lstm", oracle="sequential", plans=specs, cases=_LSTM_CASES,
        dtypes=("float32",), make_inputs=_lstm_make_inputs,
        apply=_lstm_apply, grads=_lstm_grads, viability=_lstm_viability)


register_family(_build_lstm_family())
