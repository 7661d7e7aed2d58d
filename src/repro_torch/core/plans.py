"""Family-generic execution-plan registry (the twin of the JAX package's
``core/plans.py``), with the LSTM, RWKV6 and Mamba families registered.

A family registers the same things the JAX package's does:

* named **plans** (``PlanSpec``) — alternative executions of one function,
  each with an **equivalence policy** (``EquivalencePolicy``): exact plans
  must match the family's oracle within per-dtype float tolerance, band
  plans (the int8-weight LSTM plan) within a documented error band — and,
  where fixed, the expected hand-kernel launches forward and per training
  step (the JAX package's ``fwd_dispatches``/``train_dispatches``: the
  O(1)-in-T contract);
* a **viability** factory: the shared-memory budget table behind the Fig 7
  scheduler's ``viable=`` predicate;
* **cases** — the family's deliberately awkward shapes; ``value_sweep`` and
  ``grad_sweep`` enumerate plans x cases x dtypes from them.

Families registered here:

* ``lstm`` — the plans are ``core/lstm.FORWARD_PLANS`` (the registry points
  at the same callables).  Dtypes float32 and bfloat16, as the JAX
  package's; the int8 plan's band is float32-only, as there.  Viability is
  ``core/lstm.plan_viability``.
* ``rwkv6`` — ``stepwise`` (the per-timestep oracle, models/rwkv.wkv_step
  over T), ``chunked_xla`` (models/rwkv.wkv_chunked, the plain-PyTorch
  chunked scan, chunk clamped to the largest divisor of T) and
  ``chunked_scan`` (kernels/wkv6, ONE kernel launch forward and TWO per
  gradient — the trajectory forward K6t and the reverse sweep K6b — at any
  T; where ``choose_blocks`` finds no chunk, a CPU call routes to
  ``chunked_xla`` with a ``plan/dispatch fallback=`` event and a CUDA call
  raises).  Dtypes float32 and bfloat16.  Viability is
  ``rwkv_viability``.
* ``mamba`` — ``scan`` (the per-step oracle, kernels/mamba_scan
  ``mamba_scan_ref``) and ``fused_scan`` (kernels/mamba_scan, ONE kernel
  launch forward and TWO per gradient — K7t and K7b — at any T and B;
  where ``choose_blocks`` finds no tiling, a CPU call takes the oracle VJP
  with a ``plan/dispatch fallback=`` event and a CUDA call raises).
  Dtypes float32 and bfloat16.  Viability is ``mamba_viability``.

Each family also registers a ``profile_hook``: the measured profiler's
sweep (obs/profile.py) over the port's own tiling coordinates, coarse to
fine in the JAX package's order, every point admitted by the kernel's
shared-memory table against ``factorization.H100_SMEM_PER_BLOCK`` and
priced by ``analysis.*_stream_costs`` at the H100's rates.
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


class ProfileCandidate(NamedTuple):
    """One measurable point on a family's viable tiling surface — what
    ``Family.profile_hook`` yields and obs/profile.py times.

    ``fn`` is a ready-to-call callable over ``args`` (it launches the hand
    kernel for tensors on the card, the plain version for tensors on the
    CPU); ``point`` holds the JSON-able tiling coordinates; ``model_s`` is
    the analytic roofline the model-vs-measured report divides against;
    ``plain`` is the kernel's plain version over the same ``args``, which
    the card's output is held to."""
    family: str
    plan: str
    point: dict
    fn: Callable
    args: tuple
    model_s: float | None = None
    plain: Callable | None = None


def _model_s(costs: dict) -> float:
    return max(costs["t_compute"], costs["t_memory"])


def _seeded(seed: int, device, *shape, transform=None) -> torch.Tensor:
    """A normal draw of ``shape`` from a CPU generator of ``seed`` (the
    same numbers on every device), moved to ``device``."""
    t = torch.randn(*shape, generator=torch.Generator().manual_seed(seed))
    return (t if transform is None else transform(t)).to(device)


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
    #: measured-profiler hook: keyword shapes, ``smem_budget``,
    #: ``max_points`` and ``device`` -> list of ``ProfileCandidate``
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


def _lstm_profile_candidates(*, smem_budget: int | None = None,
                             max_points: int = 4, batch: int = 4,
                             seq_len: int = 48, device="cuda",
                             hidden: int = 32, n_layers: int = 2
                             ) -> list[ProfileCandidate]:
    """Measured-profiler candidates: ``fused_seq``'s kernel
    (``kernels/lstm_seq.lstm_seq``) at a layer shape (the paper's 2 x 32
    by default; ``hidden`` x ``n_layers`` of its Fig 5 sweep) over
    the ``(block_b, time_chunk)`` surface — batch tiles on the halving walk
    from the tile the budget table takes, each at whole-T residency (K2)
    and then streamed chunks of T/2 and T/4 (K4), admitted where the
    working set fits ``smem_budget`` (a thread block's shared memory by
    default) and the layers' warps fit a block.  Where the table itself
    splits the stack over G co-resident blocks (no one block holds it
    within the budget), the split home's points instead: the table's tile
    over G and over 2G blocks (``n_blocks`` in the point), admitted where
    a block fits the budget and its instance's threads and the card holds
    every block at once, so that the scheduler can calibrate the split
    kernels on the card.  ``model_s`` is the roofline of
    ``analysis.lstm_seq_stream_costs``."""
    import functools

    from repro_torch import analysis
    from repro_torch.configs.mobirnn_lstm import LSTMConfig
    from repro_torch.core import factorization, lstm as lstm_lib, tiling
    from repro_torch.kernels import lstm_seq as seq_lib

    cfg = LSTMConfig().with_complexity(hidden, n_layers)
    budget = factorization.H100_SMEM_PER_BLOCK if smem_budget is None \
        else smem_budget
    p = lstm_lib.init_params(torch.Generator().manual_seed(0), cfg)
    w, b, p_width = seq_lib.stack_params(p["layers"], cfg.hidden)
    L, H = cfg.n_layers, cfg.hidden
    x = seq_lib.pad_input(torch.randn(
        batch, seq_len, cfg.input_dim,
        generator=torch.Generator().manual_seed(1)), p_width)
    args = tuple(t.to(device) for t in (w, b, x))

    table = seq_lib.choose_batch_block(batch, seq_len, L, p_width, H,
                                       smem_budget=budget)
    time_chunks: list[int | None] = [None]
    for t in (seq_len // 2, seq_len // 4):
        if 1 <= t < seq_len and t not in time_chunks:
            time_chunks.append(t)
    out: list[ProfileCandidate] = []
    for bm in tiling.halving(table.block_b) if table else ():
        home = seq_lib.weight_home(L, p_width, H, bm)
        for tc in time_chunks:
            if len(out) >= max_points:
                return out
            ws = seq_lib.working_set_bytes(seq_len, L, p_width, H, bm,
                                           time_chunk=tc)
            if ws > budget or seq_lib.fwd_threads(L, H) > \
                    seq_lib.fwd_max_threads(bm, home):
                continue
            costs = analysis.lstm_seq_stream_costs(
                seq_len, L, p_width, H, batch, bm, tc)
            out.append(ProfileCandidate(
                "lstm", "fused_seq", {"block_b": bm, "time_chunk": tc},
                functools.partial(seq_lib.lstm_seq, block_b=bm,
                                  time_chunk=tc),
                args, _model_s(costs), seq_lib.lstm_seq_plain))
    if table is None or table.n_blocks == 1:
        return out
    bm = table.block_b
    for g in (table.n_blocks, 2 * table.n_blocks):
        if len(out) >= max_points:
            break
        ws = seq_lib.working_set_bytes(seq_len, L, p_width, H, bm,
                                       n_blocks=g)
        threads = seq_lib.split_threads(L, H, g, block_b=bm)
        if H % g or ws > budget or threads > seq_lib.SPLIT_MAX_THREADS or \
                g * -(-batch // bm) > seq_lib.split_capacity(ws, threads):
            continue
        costs = analysis.lstm_seq_stream_costs(
            seq_len, L, p_width, H, batch, bm, None, n_blocks=g)
        out.append(ProfileCandidate(
            "lstm", "fused_seq", {"block_b": bm, "time_chunk": None,
                                  "n_blocks": g},
            functools.partial(seq_lib.lstm_seq, block_b=bm, n_blocks=g),
            args, _model_s(costs), seq_lib.lstm_seq_plain))
    return out


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
        dtypes=("float32", "bfloat16"), make_inputs=_lstm_make_inputs,
        apply=_lstm_apply, grads=_lstm_grads, viability=_lstm_viability,
        profile_hook=_lstm_profile_candidates)


register_family(_build_lstm_family())


# ===========================================================================
# rwkv6 family — stepwise oracle, plain chunked scan, the K6 kernel
# ===========================================================================
#: chunked-vs-stepwise agreement band (log-space chunk math reassociates
#: the decay products)
RWKV_TOL = {"float32": dict(rtol=5e-4, atol=5e-4),
            "bfloat16": dict(rtol=6e-2, atol=6e-2)}
RWKV_GRAD_TOL = {"float32": dict(rtol=2e-3, atol=2e-3)}

_RWKV_EXACT = EquivalencePolicy("exact", RWKV_TOL, RWKV_GRAD_TOL)

#: (B, T, H, dk, dv, chunk) — C=1, C=T, non-dividing T, chunk > T all on
#: the table, so the tail and clamping paths are part of the sweep
_RWKV_CASES = (
    Case("c8t24", (2, 24, 2, 8, 8, 8)),                     # C | T
    Case("c1", (2, 12, 2, 8, 8, 1), heavy_grad=False),      # C=1: per-step
    Case("cT", (1, 16, 2, 8, 8, 16)),                       # C=T: one chunk
    Case("oddT", (2, 23, 2, 8, 8, 8), heavy_grad=False),    # tail path
    Case("cgtT", (1, 7, 2, 8, 10, 32)),                     # clamp, dk != dv
    Case("long", (2, 96, 2, 16, 16, 16), heavy=True),
)


def _rwkv_make_inputs(case: Case, dtype: str):
    """((r, k, v, logw, u, state), chunk) on the CPU, from a seed of the
    case label: r, k, v in ``dtype``; logw (<= 0), u and state f32."""
    import zlib

    B, T, H, dk, dv, chunk = case.shape
    dt = getattr(torch, dtype)
    gen = torch.Generator().manual_seed(zlib.crc32(case.label.encode()))

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    r = randn(B, T, H, dk).to(dt)
    k = randn(B, T, H, dk).to(dt)
    v = randn(B, T, H, dv).to(dt)
    logw = -torch.exp(randn(B, T, H, dk))
    u = randn(H, dk)
    state = randn(B, H, dk, dv) * 0.3
    return (r, k, v, logw, u, state), chunk


def _rwkv_stepwise(r, k, v, logw, u, state, *, chunk):
    """Per-timestep oracle: models/rwkv.wkv_step over T — the fine-grained
    plan every chunked plan must reproduce."""
    from repro_torch.models import rwkv as rwkv_lib

    del chunk
    s = state.to(torch.float32)
    outs = []
    for t in range(r.shape[1]):
        out, s = rwkv_lib.wkv_step(r[:, t], k[:, t], v[:, t], logw[:, t],
                                   u, s)
        outs.append(out)
    return torch.stack(outs, dim=1).to(v.dtype), s


def _rwkv_chunked_xla(r, k, v, logw, u, state, *, chunk):
    """models/rwkv.wkv_chunked with the model's divisor clamp — the plain
    PyTorch chunked scan (the JAX package's jnp ``lax.scan`` plan)."""
    from repro_torch.models import rwkv as rwkv_lib

    S = r.shape[1]
    c = max(1, min(chunk, S))
    while S % c:              # largest divisor of S not above the target
        c -= 1
    out, state = rwkv_lib.wkv_chunked(r, k, v, logw, u, state, c)
    return out.to(v.dtype), state


def _rwkv_scan_blocks(seq_len: int, dk: int, dv: int, chunk: int,
                      device: torch.device, train: bool = False):
    """The kernel plan's tiling — from the backward's table when ``train``
    (its chunk serves both training launches) — or None where
    ``choose_blocks`` finds no chunk that fits a thread block and the
    tensors are on the CPU (the plan then runs ``chunked_xla``).  On the
    card no plain version stands in for the kernels: there it raises
    ValueError naming the working set."""
    from repro_torch.core import factorization
    from repro_torch.kernels import wkv6 as wkv6_lib

    mode = "bwd" if train else "fwd"
    blocks = wkv6_lib.choose_blocks(seq_len, dk, dv, target=chunk, mode=mode)
    if blocks is None and device.type != "cpu":
        smem = wkv6_lib.working_set_bytes(seq_len, dk, dv, 1, mode=mode)
        raise ValueError(
            f"chunked_scan: heads of {dk} x {dv} fit no chunk; the working "
            f"set of the {mode} kernel at chunk 1 is {smem} bytes of shared "
            f"memory (at most {factorization.H100_SMEM_PER_BLOCK}) and a side "
            f"may have at most {wkv6_lib.THREADS}")
    return blocks


def _rwkv_chunked_scan(r, k, v, logw, u, state, *, chunk):
    """kernels/wkv6: the model layout (B,S,H,*) folded to the kernels'
    (B*H, S, *), u broadcast per batch-head row (its gradient summed over
    B by autograd), any T.  Inference is K6; a call autograd records is
    K6t forward and K6b backward, at the chunk of the backward's table.
    Where ``choose_blocks`` finds no chunk that fits a thread block, a CPU
    call runs ``chunked_xla`` and says so in a ``plan/dispatch`` event,
    and a CUDA call raises (``_rwkv_scan_blocks``)."""
    from repro_torch.kernels import wkv6 as wkv6_lib
    from repro_torch.obs import trace as trace_lib

    B, S, H, dk = r.shape
    dv = v.shape[-1]
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (r, k, v, logw, u, state))
    blocks = _rwkv_scan_blocks(S, dk, dv, chunk, r.device, train)
    if blocks is None:
        tracer = trace_lib.get_tracer()
        if tracer.enabled:
            tracer.event("plan/dispatch", family="rwkv6",
                         plan="chunked_scan", fallback="chunked_xla",
                         n_bh=B * H, seq_len=S, dk=dk, dv=dv, train=train)
        return _rwkv_chunked_xla(r, k, v, logw, u, state, chunk=chunk)

    def fold(a):
        return a.transpose(1, 2).reshape(B * H, S, a.shape[-1])

    ub = u[None].expand(B, H, dk).reshape(B * H, dk)
    out, s_out = wkv6_lib.wkv6(
        fold(r), fold(k), fold(v), fold(logw), ub,
        state.reshape(B * H, dk, dv), chunk=blocks.chunk,
        bh_tile=blocks.bh_tile)
    return (out.reshape(B, H, S, dv).transpose(1, 2),
            s_out.reshape(B, H, dk, dv))


RWKV_PLANS: dict[str, Callable] = {
    "stepwise": _rwkv_stepwise,
    "chunked_xla": _rwkv_chunked_xla,
    "chunked_scan": _rwkv_chunked_scan,
}


def _rwkv_apply(plan: str, inputs):
    args, chunk = inputs
    return RWKV_PLANS[plan](*args, chunk=chunk)


def _rwkv_grads(plan: str, inputs):
    """Gradients of ``sum(tanh(out)) + 0.5 * sum(state'^2)`` through
    ``plan`` with respect to all six inputs (the JAX family's loss)."""
    args, chunk = inputs
    args = [a.detach().clone().requires_grad_() for a in args]
    out, s = RWKV_PLANS[plan](*args, chunk=chunk)
    loss = torch.sum(torch.tanh(out.to(torch.float32))) + 0.5 * torch.sum(
        s * s)
    return torch.autograd.grad(loss, args)


#: the rwkv6 plans that run the kernel, hence the ones viability gates
RWKV_SCAN_PLANS = ("chunked_scan",)


def rwkv_viability(seq_len: int, dk: int, dv: int, *, chunk: int = 32,
                   smem_budget: int | None = None, train: bool = False
                   ) -> Callable[[str], bool]:
    """Fig 7 ``viable=`` predicate for the rwkv6 family, from the
    kernels/wkv6 budget tables: the kernel plan is a real plan only while
    ``choose_blocks`` finds a chunk that fits a thread block — for
    ``train=True`` the backward's (K6b), whose working set is the larger,
    else the forward's.  Every other plan name stays viable."""
    from repro_torch.kernels import wkv6 as wkv6_lib

    blocks = wkv6_lib.choose_blocks(seq_len, dk, dv, target=chunk,
                                    smem_budget=smem_budget,
                                    mode="bwd" if train else "fwd")

    def viable(plan_name: str) -> bool:
        return blocks is not None or plan_name not in RWKV_SCAN_PLANS

    return viable


def _rwkv_profile_candidates(*, smem_budget: int | None = None,
                             max_points: int = 4, seq_len: int = 64,
                             n_bh: int = 4, dk: int = 8, dv: int = 8,
                             target: int = 16, device="cuda"
                             ) -> list[ProfileCandidate]:
    """Measured-profiler candidates for the rwkv6 family over the
    ``(bh_tile, chunk)`` surface of ``chunked_scan``'s kernel
    (``kernels/wkv6.wkv6``, K6): for each bh tile on the halving walk from
    the table's (one row a block), chunks from ``target`` halving, the
    points shared evenly over the tiles, admitted where the working set
    fits ``smem_budget``.  ``model_s`` comes from
    ``analysis.wkv6_stream_costs``."""
    import functools

    from repro_torch import analysis
    from repro_torch.core import factorization, tiling
    from repro_torch.kernels import wkv6 as wkv6_lib

    budget = factorization.H100_SMEM_PER_BLOCK if smem_budget is None \
        else smem_budget
    table = wkv6_lib.choose_blocks(seq_len, dk, dv, target=target,
                                   smem_budget=budget)
    args = (_seeded(20, device, n_bh, seq_len, dk),
            _seeded(21, device, n_bh, seq_len, dk),
            _seeded(22, device, n_bh, seq_len, dv),
            _seeded(23, device, n_bh, seq_len, dk,
                    transform=lambda t: -torch.exp(t)),
            _seeded(24, device, n_bh, dk),
            _seeded(25, device, n_bh, dk, dv, transform=lambda t: t * 0.3))
    out: list[ProfileCandidate] = []
    tiles = list(tiling.halving(table.bh_tile)) if table else []
    per_tile = max(1, max_points // max(1, len(tiles)))   # over both axes
    for bt in tiles:
        taken = 0
        for c in tiling.halving(max(1, min(target, seq_len))):
            if len(out) >= max_points or taken >= per_tile:
                break
            if wkv6_lib.working_set_bytes(seq_len, dk, dv, c) > budget:
                continue
            costs = analysis.wkv6_stream_costs(seq_len, n_bh, dk, dv, c,
                                               bh_tile=bt)
            out.append(ProfileCandidate(
                "rwkv6", "chunked_scan", {"chunk": c, "bh_tile": bt},
                functools.partial(wkv6_lib.wkv6, chunk=c, bh_tile=bt),
                args, _model_s(costs),
                functools.partial(wkv6_lib.wkv6_plain, chunk=c)))
            taken += 1
    return out


def _build_rwkv_family() -> Family:
    specs = {
        "stepwise": PlanSpec("stepwise", _rwkv_stepwise, _RWKV_EXACT),
        "chunked_xla": PlanSpec("chunked_xla", _rwkv_chunked_xla,
                                _RWKV_EXACT),
        "chunked_scan": PlanSpec("chunked_scan", _rwkv_chunked_scan,
                                 _RWKV_EXACT, fwd_launches=1,
                                 train_launches=2),
    }
    return Family(
        name="rwkv6", oracle="stepwise", plans=specs, cases=_RWKV_CASES,
        dtypes=("float32", "bfloat16"), make_inputs=_rwkv_make_inputs,
        apply=_rwkv_apply, grads=_rwkv_grads, viability=rwkv_viability,
        profile_hook=_rwkv_profile_candidates)


register_family(_build_rwkv_family())


# ===========================================================================
# mamba family — per-step scan oracle, the K7 kernel
# ===========================================================================
#: fused-vs-scan agreement band: both paths run the same per-step
#: recurrence in f32; differences come only from the order of its sums
MAMBA_TOL = {"float32": dict(rtol=2e-5, atol=2e-5),
             "bfloat16": dict(rtol=2e-2, atol=2e-2)}
MAMBA_GRAD_TOL = {"float32": dict(rtol=2e-4, atol=2e-5)}

_MAMBA_EXACT = EquivalencePolicy("exact", MAMBA_TOL, MAMBA_GRAD_TOL)

#: (B, T, d_inner, d_state, chunk, block_b) — C=1, C=T, non-dividing T
#: (pad path) and a non-dividing batch tile (row-pad path) all on the
#: table, so every clamp and pad branch is part of the sweep
_MAMBA_CASES = (
    Case("c8t24", (2, 24, 8, 4, 8, 2)),                     # C | T, bm | B
    Case("c1", (2, 12, 8, 4, 1, 2), heavy_grad=False),      # C=1: per-step
    Case("cT", (1, 16, 8, 4, 16, 1)),                       # C=T: one chunk
    Case("oddT", (2, 23, 8, 4, 8, 2), heavy_grad=False),    # pad path
    Case("btail", (3, 16, 8, 4, 8, 2)),                     # bm does not | B
    Case("long", (2, 96, 16, 8, 16, 2), heavy=True),
)


def _mamba_make_inputs(case: Case, dtype: str):
    """((x, dt, b, c, a, h0), chunk, block_b) on the CPU, from a seed of the
    case label: x in ``dtype``; dt (> 0), b, c, a (< 0) and h0 f32."""
    import zlib

    B, T, di, ds, chunk, block_b = case.shape
    gen = torch.Generator().manual_seed(zlib.crc32(case.label.encode()))

    def randn(*shape):
        return torch.randn(*shape, generator=gen)

    x = randn(B, T, di).to(getattr(torch, dtype))
    dt = torch.nn.functional.softplus(randn(B, T, di))
    a = -torch.exp(randn(di, ds))
    return ((x, dt, randn(B, T, ds), randn(B, T, ds), a,
             randn(B, di, ds) * 0.3), chunk, block_b)


def _mamba_scan(x, dt, b, c, a, h0, *, chunk, block_b):
    """Per-step scan oracle — the models/mamba recurrence
    (kernels/mamba_scan.mamba_scan_ref)."""
    from repro_torch.kernels import mamba_scan as ms_lib

    del chunk, block_b
    return ms_lib.mamba_scan_ref(x, dt, b, c, a, h0)


def _mamba_scan_blocks(seq_len: int, d_inner: int, d_state: int,
                       chunk: int, device: torch.device, train: bool = False):
    """The kernel plan's tiling — from the backward's table when ``train``
    (its chunk and tile serve both training launches) — or None where
    ``choose_blocks`` finds nothing and the tensors are on the CPU.  On the
    card no plain version stands in for the kernels: there it raises
    ValueError naming the working set."""
    from repro_torch.core import factorization
    from repro_torch.kernels import mamba_scan as ms_lib

    mode = "bwd" if train else "fwd"
    blocks = ms_lib.choose_blocks(seq_len, d_inner, d_state, target=chunk,
                                  mode=mode)
    if blocks is None and device.type != "cpu":
        smem = ms_lib.working_set_bytes(seq_len, d_state, 1,
                                        factorization.WARP, mode)
        raise ValueError(
            f"fused_scan: d_state {d_state} fits no tiling; the working set "
            f"of the {mode} kernel at chunk 1 and one warp is {smem} bytes "
            f"of shared memory (budget "
            f"{ms_lib.block_budget(factorization.WARP)}) and a thread keeps "
            f"at most {ms_lib.MAX_DS} states")
    return blocks


def _mamba_fused_scan(x, dt, b, c, a, h0, *, chunk, block_b):
    """kernels/mamba_scan: ONE launch forward (K7), and under autograd the
    trajectory forward K7t and the reverse sweep K7b, at the tiling of the
    backward's table; any T and B (the last chunk runs short).  Where
    ``choose_blocks`` finds nothing, a CPU call takes the oracle VJP
    (``ORACLE_BWD``; past the forward's table too, the ``scan`` oracle)
    and says so in a ``plan/dispatch`` event, and a CUDA call raises
    (``_mamba_scan_blocks``)."""
    from repro_torch.kernels import mamba_scan as ms_lib
    from repro_torch.kernels import ops
    from repro_torch.obs import trace as trace_lib

    B, T, di = x.shape
    ds = b.shape[-1]
    train = torch.is_grad_enabled() and any(
        t.requires_grad for t in (x, dt, b, c, a, h0))
    blocks = _mamba_scan_blocks(T, di, ds, chunk, x.device, train)
    bwd = ms_lib.FUSED_BWD
    if blocks is None:
        blocks = ms_lib.choose_blocks(T, di, ds, target=chunk) \
            if train else None
        tracer = trace_lib.get_tracer()
        if tracer.enabled:
            tracer.event("plan/dispatch", family="mamba", plan="fused_scan",
                         fallback="oracle_bwd" if blocks else "scan",
                         batch=B, seq_len=T, d_inner=di, d_state=ds,
                         train=train)
        if blocks is None:
            return _mamba_scan(x, dt, b, c, a, h0, chunk=chunk,
                               block_b=block_b)
        bwd = ms_lib.ORACLE_BWD
    return ops.mamba_scan(x, dt, b, c, a, h0, chunk=blocks.chunk,
                          block_b=block_b, di_tile=blocks.di_tile, bwd=bwd)


MAMBA_PLANS: dict[str, Callable] = {
    "scan": _mamba_scan,
    "fused_scan": _mamba_fused_scan,
}


def _mamba_apply(plan: str, inputs):
    args, chunk, block_b = inputs
    return MAMBA_PLANS[plan](*args, chunk=chunk, block_b=block_b)


def _mamba_grads(plan: str, inputs):
    """Gradients of ``sum(tanh(y)) + 0.5 * sum(h'^2)`` through ``plan``
    with respect to all six inputs (the JAX family's loss)."""
    args, chunk, block_b = inputs
    args = [a.detach().clone().requires_grad_() for a in args]
    y, h = MAMBA_PLANS[plan](*args, chunk=chunk, block_b=block_b)
    loss = torch.sum(torch.tanh(y.to(torch.float32))) + 0.5 * torch.sum(
        h * h)
    return torch.autograd.grad(loss, args)


#: the mamba plans that run the kernels, hence the ones viability gates
MAMBA_SCAN_PLANS = ("fused_scan",)


def mamba_viability(seq_len: int, d_inner: int, d_state: int, *,
                    chunk: int | None = None, smem_budget: int | None = None,
                    train: bool = False) -> Callable[[str], bool]:
    """Fig 7 ``viable=`` predicate for the mamba family, from the
    kernels/mamba_scan budget tables: the kernel plan is a real plan only
    while ``choose_blocks`` finds a tiling — for ``train=True`` the
    backward's (K7b), whose working set is the larger, else the
    forward's.  The ``scan`` oracle stays viable."""
    from repro_torch.kernels import mamba_scan as ms_lib

    blocks = ms_lib.choose_blocks(seq_len, d_inner, d_state, target=chunk,
                                  smem_budget=smem_budget,
                                  mode="bwd" if train else "fwd")

    def viable(plan_name: str) -> bool:
        return blocks is not None or plan_name not in MAMBA_SCAN_PLANS

    return viable


def _mamba_profile_candidates(*, smem_budget: int | None = None,
                              max_points: int = 4, batch: int = 4,
                              seq_len: int = 64, d_inner: int = 16,
                              d_state: int = 8, device="cuda"
                              ) -> list[ProfileCandidate]:
    """Measured-profiler candidates for the mamba family over the
    ``(di_tile, chunk)`` surface of ``fused_scan``'s kernel
    (``kernels/mamba_scan.mamba_scan``, K7) — the port's tile is of
    d_inner channels (a block runs its batch rows one after another, and
    the table keeps one a block): for each tile on the halving walk from
    the table's down to one warp, chunks from whole T halving, the points
    shared evenly over the tiles, admitted where the working set fits
    ``smem_budget``.  ``model_s`` comes from
    ``analysis.mamba_scan_stream_costs``."""
    import functools

    from repro_torch import analysis
    from repro_torch.core import factorization, tiling
    from repro_torch.kernels import mamba_scan as ms_lib

    budget = factorization.H100_SMEM_PER_BLOCK if smem_budget is None \
        else smem_budget
    table = ms_lib.choose_blocks(seq_len, d_inner, d_state,
                                 smem_budget=budget)
    softplus = torch.nn.functional.softplus
    args = (_seeded(30, device, batch, seq_len, d_inner),
            _seeded(31, device, batch, seq_len, d_inner, transform=softplus),
            _seeded(32, device, batch, seq_len, d_state),
            _seeded(33, device, batch, seq_len, d_state),
            _seeded(34, device, d_inner, d_state,
                    transform=lambda t: -torch.exp(t)),
            _seeded(35, device, batch, d_inner, d_state,
                    transform=lambda t: t * 0.3))
    out: list[ProfileCandidate] = []
    tiles = list(tiling.halving(table.di_tile, floor=factorization.WARP)) \
        if table else []
    per_tile = max(1, max_points // max(1, len(tiles)))   # over both axes
    for tile in tiles:
        taken = 0
        for cn in tiling.halving(seq_len):
            if len(out) >= max_points or taken >= per_tile:
                break
            if ms_lib.working_set_bytes(seq_len, d_state, cn, tile) > budget:
                continue
            costs = analysis.mamba_scan_stream_costs(
                seq_len, batch, d_inner, d_state, 1, cn, di_tile=tile)
            out.append(ProfileCandidate(
                "mamba", "fused_scan", {"di_tile": tile, "chunk": cn},
                functools.partial(ms_lib.mamba_scan, chunk=cn, block_b=1,
                                  di_tile=tile),
                args, _model_s(costs),
                functools.partial(ms_lib.mamba_scan_plain, chunk=cn)))
            taken += 1
    return out


def _build_mamba_family() -> Family:
    specs = {
        "scan": PlanSpec("scan", _mamba_scan, _MAMBA_EXACT),
        "fused_scan": PlanSpec("fused_scan", _mamba_fused_scan, _MAMBA_EXACT,
                               fwd_launches=1, train_launches=2),
    }
    return Family(
        name="mamba", oracle="scan", plans=specs, cases=_MAMBA_CASES,
        dtypes=("float32", "bfloat16"), make_inputs=_mamba_make_inputs,
        apply=_mamba_apply, grads=_mamba_grads, viability=mamba_viability,
        profile_hook=_mamba_profile_candidates)


register_family(_build_mamba_family())
