"""Deterministic, seeded fault injection for the serving stack (the port's
twin of the JAX package's ``serving/faults.py``: the same plans from the
same seeds, ``FaultPlan.seeded`` drawing from numpy exactly as JAX's does,
so one plan drives both engines).

MobiRNN's serving claim is about the MESSY device — contention, throttling,
load spikes — so the failure path needs the same engineering discipline as
the fast path, and above all it needs to be *reproducible*: a chaos run
that cannot be replayed cannot be debugged or asserted on.  This module is
the host half of that story:

* a ``FaultPlan`` is a frozen, seeded schedule of faults — NaN-poisoned
  decode lanes, failed prefills, artificially slow ticks, queue floods —
  generated once (``FaultPlan.seeded``) and serialisable
  (``save``/``to_json``) so CI uploads the exact schedule next to the trace
  it produced;
* a ``FaultInjector`` is the engine-facing view: cheap host-side lookups
  the ``SlotEngine`` consults at its injection points (tick start, prefill,
  watchdog).  The *device* half of poison injection lives in
  steps.guarded_decode_step — the injector only decides WHICH lanes (the
  engine writes them into the manager's static poison buffer for that one
  tick), the NaN overwrite and the per-lane finite guard run inside the
  tick, captured in its CUDA graph on the card.

Faults compose with the serving invariants, not against them: lanes never
interact, so a poisoned lane perturbs exactly one request; quarantine
zeroes that lane in place (core/state.lane_zero), so
``StatePool.stats.buffers_built`` stays at capacity through any schedule;
and an all-False poison mask is a bit-exact no-op, so healthy lanes'
greedy tokens are identical to a fault-free run (asserted by
tests/test_torch_serving_faults.py against the JAX package's engine).
"""
from __future__ import annotations

import dataclasses
import json

import numpy as np

from repro_torch.serving.slots import Request


class InjectedFault(RuntimeError):
    """Raised at a scheduled prefill-fault point, BEFORE the prefill
    dispatch (so the scratch cache is untouched by a failed call).  The engine's admission path catches it — retry with backoff or
    terminal ``finish_reason`` — exactly as it would a real exception."""


@dataclasses.dataclass(frozen=True)
class LanePoison:
    """NaN-poison lane ``lane``'s decode output at decode tick ``tick``
    (a no-op if the lane is free then — the guard ignores inactive lanes)."""
    tick: int
    lane: int


@dataclasses.dataclass(frozen=True)
class PrefillFault:
    """Fail one prefill ATTEMPT for ``uid``.  One-shot and per-attempt:
    a retry succeeds unless another PrefillFault for the same uid remains.

    ``chunk`` refines WHERE in a chunked admission the attempt fails:
    ``None`` (default, and the whole-prompt path's only meaning) fires at
    the next attempt whatever its chunk index; ``chunk=k`` fires at the
    attempt that would run chunk ``k``, i.e. after ``k`` chunks of scratch
    state have been filled.  Either way the fault raises BEFORE dispatch,
    the lane's partial prefill state is discarded (the scratch is zeroed
    in place), and a retry restarts from chunk 0 — token-identical to an
    unfaulted admission."""
    uid: int
    chunk: int | None = None


@dataclasses.dataclass(frozen=True)
class SlowTick:
    """Add ``extra_s`` seconds to the watchdog-visible latency of decode
    tick ``tick``.  Deterministic contention: no real sleep — the extra
    latency is folded into the observed tick time (and the plan's EMA), so
    chaos runs replay identically on any host."""
    tick: int
    extra_s: float


@dataclasses.dataclass(frozen=True)
class QueueFlood:
    """Submit ``n`` synthetic deadline'd requests just before decode tick
    ``tick`` — dead weight competing with real work for bounded queue
    space, exercising backpressure (QueueFull), expiry, and the
    degradation ladder's shed sweep."""
    tick: int
    n: int
    prompt_len: int = 4
    max_new_tokens: int = 4
    deadline_in_s: float = 1000.0


FAULT_KINDS = {c.__name__: c for c in
               (LanePoison, PrefillFault, SlowTick, QueueFlood)}


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A frozen, replayable fault schedule.  Equality is structural, so
    ``FaultPlan.seeded(s, ...) == FaultPlan.seeded(s, ...)`` — the
    determinism contract chaos tests assert on."""
    seed: int
    faults: tuple = ()

    @classmethod
    def seeded(cls, seed: int, *, n_slots: int, ticks: int = 16,
               uids: tuple[int, ...] = (), n_poison: int = 1,
               n_prefill: int = 1, n_slow_burst: int = 1,
               burst_len: int = 3, slow_extra_s: float = 1e6,
               n_flood: int = 0, flood_n: int = 2,
               flood_deadline_s: float = 1000.0) -> "FaultPlan":
        """Generate a random-but-deterministic schedule from ``seed``:
        ``n_poison`` lane poisons over the first ``ticks`` decode ticks,
        ``n_prefill`` one-shot prefill faults drawn from ``uids``,
        ``n_slow_burst`` bursts of ``burst_len`` consecutive slow ticks,
        and ``n_flood`` queue floods of ``flood_n`` requests each."""
        rng = np.random.default_rng(seed)
        faults: list = []
        for _ in range(n_poison):
            faults.append(LanePoison(int(rng.integers(0, ticks)),
                                     int(rng.integers(0, n_slots))))
        if uids and n_prefill:
            picks = rng.choice(np.asarray(uids),
                               size=min(n_prefill, len(uids)), replace=False)
            faults.extend(PrefillFault(int(u)) for u in picks)
        for _ in range(n_slow_burst):
            t0 = int(rng.integers(0, ticks))
            faults.extend(SlowTick(t0 + k, float(slow_extra_s))
                          for k in range(burst_len))
        for _ in range(n_flood):
            faults.append(QueueFlood(int(rng.integers(0, ticks)),
                                     int(flood_n),
                                     deadline_in_s=float(flood_deadline_s)))
        return cls(seed=seed, faults=tuple(faults))

    # -- serialisation (the CI chaos-smoke artifact) --------------------
    def to_json(self) -> dict:
        return {"seed": self.seed,
                "faults": [{"kind": type(f).__name__,
                            **dataclasses.asdict(f)}
                           for f in self.faults]}

    @classmethod
    def from_json(cls, obj: dict) -> "FaultPlan":
        faults = tuple(FAULT_KINDS[f["kind"]](
            **{k: v for k, v in f.items() if k != "kind"})
            for f in obj["faults"])
        return cls(seed=obj["seed"], faults=faults)

    def save(self, path: str) -> None:
        with open(path, "w") as fh:
            json.dump(self.to_json(), fh, indent=1)

    @classmethod
    def load(cls, path: str) -> "FaultPlan":
        with open(path) as fh:
            return cls.from_json(json.load(fh))


class FaultInjector:
    """Engine-facing index over a FaultPlan: O(1) host lookups per tick.

    Out-of-range faults are dropped at construction (a poison aimed past
    ``n_slots`` cannot land), and every flood request is clamped to fit a
    lane (``max_seq``) so injection never trips the engine's own
    admission validation.
    """

    #: flood uids count down from here — disjoint from client uid spaces
    FLOOD_UID_BASE = -1000

    def __init__(self, plan: FaultPlan, n_slots: int, *, vocab: int,
                 max_seq: int, token_tail: tuple[int, ...] = ()):
        self.plan = plan
        self._rng = np.random.default_rng(plan.seed)
        self._poison: dict[int, set[int]] = {}
        self._slow: dict[int, float] = {}
        self._floods: dict[int, list[QueueFlood]] = {}
        self._prefill: dict[int, list[int | None]] = {}  # uid -> chunks
        self._vocab = vocab
        self._max_seq = max_seq
        self._token_tail = tuple(token_tail)
        self._next_flood_uid = self.FLOOD_UID_BASE
        for f in plan.faults:
            if isinstance(f, LanePoison):
                if 0 <= f.lane < n_slots:
                    self._poison.setdefault(f.tick, set()).add(f.lane)
            elif isinstance(f, SlowTick):
                self._slow[f.tick] = self._slow.get(f.tick, 0.0) + f.extra_s
            elif isinstance(f, PrefillFault):
                self._prefill.setdefault(f.uid, []).append(f.chunk)
            elif isinstance(f, QueueFlood):
                self._floods.setdefault(f.tick, []).append(f)

    def poison_lanes(self, tick: int) -> tuple[int, ...]:
        """Lanes whose decode output is NaN-poisoned at this tick."""
        return tuple(sorted(self._poison.get(tick, ())))

    def slow_s(self, tick: int) -> float:
        """Injected extra latency folded into this tick's observed time."""
        return self._slow.get(tick, 0.0)

    def take_prefill_fault(self, uid: int, chunk: int = 0) -> bool:
        """True exactly once per scheduled PrefillFault for ``uid`` —
        consumed per ATTEMPT, not per request.  ``chunk`` is the chunk
        index this attempt would run (0 for the whole-prompt path, which
        has exactly one attempt per admission); a scheduled fault with
        ``chunk=None`` matches any attempt, ``chunk=k`` only the k-th."""
        scheduled = self._prefill.get(uid)
        if not scheduled:
            return False
        for i, want in enumerate(scheduled):
            if want is None or want == chunk:
                scheduled.pop(i)
                return True
        return False

    def flood_requests(self, tick: int, now: float) -> list[Request]:
        """Build (and consume) this tick's synthetic flood requests."""
        specs = self._floods.pop(tick, None)
        if not specs:
            return []
        out: list[Request] = []
        for spec in specs:
            s = max(1, min(spec.prompt_len, self._max_seq))
            new = max(1, min(spec.max_new_tokens, self._max_seq - s + 1))
            for _ in range(spec.n):
                self._next_flood_uid -= 1
                prompt = self._rng.integers(
                    0, self._vocab,
                    self._token_tail + (s,)).astype(np.int32)
                out.append(Request(self._next_flood_uid, prompt,
                                   max_new_tokens=new,
                                   deadline_s=now + spec.deadline_in_s))
        return out
