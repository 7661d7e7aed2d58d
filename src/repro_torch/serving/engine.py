"""Serving engines with MobiRNN-style runtime policies (the port's twin of
the JAX package's ``serving/engine.py``).

The paper's mechanisms are first-class here:
  * preallocated state pools (core/state.StatePool) — decode caches are
    built once and reset in place; no state is allocated on the serving
    path, and pool exhaustion is explicit backpressure;
  * load-aware dispatch (core/scheduler.Scheduler) — every decode plan is
    registered and the predicted-fastest under the sensed load runs each
    step or tick (paper Fig 7);
  * fixed-shape batching — the decode step has one shape for the life of
    the engine.

Two engines share that substrate:

``Engine`` — the coarse WAVE engine: requests are packed into lockstep
waves of ``batch_size``; every request is left-padded to the longest
prompt of its wave and decodes for the longest ``max_new_tokens``.  Short
waves are padded with zero-length dummy requests (an inactive lane, not a
duplicated real request).  Kept as the baseline.

``SlotEngine`` — slot-resident CONTINUOUS batching (serving/slots.py): the
batch axis is B independent slots over one preallocated cache; requests
are admitted from a bounded queue into free slots at step granularity,
decode runs one fused masked step across all lanes per tick, and
retirement resets just that lane and immediately admits the next request.
Tokens stream out per tick (``stream``/``on_token``).  Each decode plan's
tick is captured once, at construction, in a CUDA graph on the card
(serving/tick.py, the port's form of JAX's donated ``jax.jit``) and
replayed every tick; on the CPU it runs eagerly.

Both engines serve every family the port builds, the modality fronts
included: an audio model's prompts are (K, S) codebook ids, its tokens a
step (K,) and its Results' tokens (K, m); a vision model's prefills carry
zero patch embeddings (the JAX engine's stand-in for its stub encoder),
and the slot engine refuses chunked admission for it, as JAX's does.

Timings are host clock around work that ends in a read of its result on
the host (``.cpu()``) or ``torch.cuda.synchronize()``.
"""
from __future__ import annotations

import collections
import dataclasses
import time
import warnings
from typing import Any, Callable, Iterator

import numpy as np
import torch

from repro_torch import steps as steps_lib
from repro_torch.core.scheduler import (Plan, Scheduler, SyntheticLoadSensor,
                                        block_until_ready)
from repro_torch.core.state import StatePool
from repro_torch.models.registry import Model
from repro_torch.obs import trace as trace_lib
from repro_torch.obs.metrics import Metrics
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serving import faults as faults_lib
from repro_torch.serving.slots import (FinishReason, PrefillLane, QueueFull,
                                       Request, RequestQueue, Result,
                                       SlotManager, TokenEvent,
                                       chunk_schedule)
from repro_torch.serving.tick import DecodeTick


@dataclasses.dataclass
class EngineConfig:
    """The consolidated construction surface for both engines — every
    queue/retry/ladder/fault/chunk knob in one dataclass.  Engines take
    ``config=EngineConfig(...)``; the old per-engine kwargs remain as
    deprecated aliases (DeprecationWarning).  Unused knobs are ignored by
    the engine that does not implement them (``pool_capacity`` is a wave
    knob — the slot engine always runs ONE resident cache;
    ``queue_capacity``/retry/ladder/chunk knobs are slot knobs).

    Chunked prefill (``prefill_chunk_len``):
      * ``None`` (default) keeps whole-prompt admission — one B=1 prefill
        per request at its exact length, and one long prompt stalls every
        resident lane's decode tick for its whole prefill;
      * an int enables chunk-interleaved admission: prompts prefill
        through up-to-``prefill_lanes`` PrefillLane state machines, at
        most ONE fixed-shape chunk between decode ticks, and admit into a
        slot only when fully prefilled.  Greedy outputs equal whole-prompt
        prefill's — chunking changes scheduling, not math.
    """
    n_slots: int = 4
    max_seq: int = 128
    queue_capacity: int = 16
    pool_capacity: int = 2
    #: admission-prefill chunk length (None = whole-prompt admission)
    prefill_chunk_len: int | None = None
    #: concurrent partially-prefilled requests (chunked mode only)
    prefill_lanes: int = 2
    retry_budget: int = 0
    retry_backoff_s: float = 0.0
    tick_slo_s: float | None = None
    slo_breach_ticks: int = 3
    slo_recover_ticks: int = 8
    shed_margin: float = 1.0
    ladder: list[str] | None = None
    faults: faults_lib.FaultPlan | None = None

    @property
    def batch_size(self) -> int:
        """Wave-engine naming for the batch axis (== ``n_slots``)."""
        return self.n_slots


#: deprecated per-engine kwarg -> EngineConfig field
_WAVE_ALIASES = {"batch_size": "n_slots", "max_seq": "max_seq",
                 "pool_capacity": "pool_capacity"}
_SLOT_ALIASES = {k: k for k in (
    "n_slots", "max_seq", "queue_capacity", "faults", "retry_budget",
    "retry_backoff_s", "tick_slo_s", "slo_breach_ticks",
    "slo_recover_ticks", "shed_margin", "ladder")}


def _resolve_config(cls_name: str, config: EngineConfig | None,
                    legacy: dict, aliases: dict) -> EngineConfig:
    """Fold an engine's deprecated construction kwargs into EngineConfig.

    Exactly one spelling per call: legacy kwargs warn (DeprecationWarning
    pointing at the caller) and build a fresh config through the alias
    map; mixing them with an explicit ``config`` is ambiguous and raises."""
    if not legacy:
        return config if config is not None else EngineConfig()
    unknown = sorted(set(legacy) - set(aliases))
    if unknown:
        raise TypeError(
            f"{cls_name}: unexpected keyword argument(s) {unknown}")
    if config is not None:
        raise ValueError(
            f"{cls_name}: pass config=EngineConfig(...) OR the deprecated "
            f"kwargs {sorted(legacy)}, not both")
    warnings.warn(
        f"{cls_name}({', '.join(sorted(legacy))}) kwargs are deprecated; "
        "pass config=EngineConfig(...)", DeprecationWarning, stacklevel=3)
    return EngineConfig(**{aliases[k]: v for k, v in legacy.items()})


class _EngineBase:
    """Shared substrate: cache pool, prefill, decode-plan scheduler,
    metrics.  The pool's buffers live on the parameters' device."""

    def __init__(self, model: Model, params: Any, *, batch_size: int,
                 max_seq: int, pool_capacity: int, sensor,
                 per_lane_pos: bool):
        self.model = model
        self.cfg = model.cfg
        self.params = params
        self.batch_size = batch_size
        self.max_seq = max_seq
        self.device = params["final_norm"]["scale"].device
        # continuous batching: each lane decodes at its own position
        spec = model.init_cache(batch_size, max_seq, device="meta",
                                per_lane_pos=per_lane_pos)
        self.pool = StatePool(spec, capacity=pool_capacity,
                              device=self.device)
        self.scheduler = Scheduler(sensor or SyntheticLoadSensor(0.0))
        # serving metrics are ALWAYS on: plain host ints/deques, so they
        # cannot violate the zero-allocation serving invariant
        self.metrics = Metrics()

    def _prefill(self, params, cache, batch):
        return steps_lib.prefill_step(self.cfg, params, cache, batch)

    def _prefill_batch(self, toks: np.ndarray) -> dict:
        """A prefill's batch: the (B, [K,] S) prompt ids on the device, and
        for a vision model zero patch embeddings (B, n_vis, vis_dim) in
        the model dtype."""
        batch = {"tokens": torch.from_numpy(toks).to(self.device)}
        if self.cfg.n_vis_tokens:
            batch["vis_embeds"] = torch.zeros(
                (toks.shape[0], self.cfg.n_vis_tokens, self.cfg.vis_dim),
                dtype=getattr(torch, self.cfg.dtype), device=self.device)
        return batch

    def _check_vision_fit(self, uid: int, s: int, n_writes: int) -> None:
        """Raise ValueError when a vision model's prefix, ``s`` text
        positions and ``n_writes`` decode writes pass the cache (a ring
        cache wraps instead).  The JAX package drops such writes; on the
        card an out-of-range write is a device-side assert."""
        n_vis = self.cfg.n_vis_tokens
        if (n_vis and not self.cfg.sliding_window
                and n_vis + s + n_writes > self.max_seq):
            raise ValueError(
                f"request {uid}: vision prefix {n_vis} + prompt {s} + "
                f"{n_writes} decode writes exceed the cache's max_seq "
                f"{self.max_seq}")

    @property
    def token_tail(self) -> tuple[int, ...]:
        """The per-step token's shape: (K,) for audio codebooks, else ()."""
        return (self.cfg.n_codebooks,) if self.cfg.n_codebooks else ()


# ---------------------------------------------------------------------------
# Wave engine (baseline)
# ---------------------------------------------------------------------------
class Engine(_EngineBase):
    """Lockstep wave engine — the coarse-batching baseline.  Every decode
    step runs the plan the scheduler chooses (``decode/base``, the plain
    ``steps.decode_step``, unless ``extra_plans`` adds others)."""

    def __init__(self, model: Model, params: Any, *,
                 config: EngineConfig | None = None, sensor=None,
                 extra_plans: dict[str, Callable] | None = None, **legacy):
        config = _resolve_config("Engine", config, legacy, _WAVE_ALIASES)
        self.config = config
        super().__init__(model, params, batch_size=config.n_slots,
                         max_seq=config.max_seq,
                         pool_capacity=config.pool_capacity, sensor=sensor,
                         per_lane_pos=False)
        # looked up at call time, so a caller may wrap steps.decode_step
        plans = {"decode/base":
                 lambda p, c, b: steps_lib.decode_step(self.cfg, p, c, b)}
        plans.update(extra_plans or {})
        for name, fn in plans.items():
            self.scheduler.register(Plan(name, fn, shared=True))

    def _dummy_request(self) -> Request:
        """Zero-length, zero-token filler for ragged wave tails — an
        inactive lane, NOT a duplicate of a real request."""
        return Request(uid=-1, prompt=np.zeros(self.token_tail + (0,),
                                               np.int32), max_new_tokens=0)

    def _pad_prompts(self, reqs: list[Request]) -> np.ndarray:
        s = max(r.prompt.shape[-1] for r in reqs)
        toks = np.zeros((self.batch_size,) + self.token_tail + (s,),
                        np.int32)
        for i, r in enumerate(reqs):
            toks[i, ..., s - r.prompt.shape[-1]:] = r.prompt  # left-pad
        return toks

    def serve(self, requests: list[Request]) -> list[Result]:
        """Serve all requests in fixed-shape waves of ``batch_size``.  A
        wave decodes its longest budget from its longest prompt, one
        write a step; a vision wave that would pass the cache raises
        ValueError before any wave runs."""
        for i in range(0, len(requests), self.batch_size):
            wave = requests[i:i + self.batch_size]
            self._check_vision_fit(
                wave[0].uid, max(r.prompt.shape[-1] for r in wave),
                max(r.max_new_tokens for r in wave))
        results: list[Result] = []
        with torch.no_grad():
            for i in range(0, len(requests), self.batch_size):
                wave = requests[i:i + self.batch_size]
                pad = self.batch_size - len(wave)
                wave_padded = wave + [self._dummy_request()] * pad
                results.extend(self._serve_wave(wave_padded)[: len(wave)])
        return results

    def _serve_wave(self, reqs: list[Request]) -> list[Result]:
        cache = self.pool.checkout()
        toks = self._pad_prompts(reqs)
        batch = self._prefill_batch(toks)

        t0 = time.perf_counter()
        logits, cache = self._prefill(self.params, cache, batch)
        block_until_ready(logits)
        t_prefill = time.perf_counter() - t0

        max_new = max(r.max_new_tokens for r in reqs)
        outs = []
        decisions = []
        tracer = trace_lib.get_tracer()
        wave_span = (tracer.span("serve/wave", n_reqs=len(reqs),
                                 max_new=max_new, prefill_s=t_prefill)
                     if tracer.enabled else trace_lib.NULL_SPAN)
        # prefill logits keep a singleton seq axis before the vocab dim
        tok = steps_lib.greedy_sample(logits)[..., 0]
        t0 = time.perf_counter()
        with wave_span:
            for _ in range(max_new):
                outs.append(tok.cpu().numpy())
                d = self.scheduler.choose()
                decisions.append(d.plan)
                plan = self.scheduler.plans[d.plan]
                t1 = time.perf_counter()
                logits, cache = plan.fn(self.params, cache, {"tokens": tok})
                block_until_ready(logits)
                plan.observe(time.perf_counter() - t1, d.load)
                tok = steps_lib.greedy_sample(logits)
            t_decode = time.perf_counter() - t0
            wave_span.set(decode_s=t_decode)
        self.pool.give_back(cache)
        self.metrics.counter("serving/waves").inc()
        self.metrics.histogram("serving/wave_prefill_s").observe(t_prefill)
        self.metrics.histogram("serving/wave_decode_s").observe(t_decode)

        # (B, [K,] max_new); toks[..., :0] covers an all-zero-budget wave
        gen = np.stack(outs, axis=-1) if outs else toks[..., :0]
        return [Result(r.uid, gen[j, ..., :r.max_new_tokens], t_prefill,
                       t_decode, decisions)
                for j, r in enumerate(reqs)]


# ---------------------------------------------------------------------------
# Slot engine (continuous batching)
# ---------------------------------------------------------------------------
class SlotEngine(_EngineBase):
    """Slot-resident continuous batching (see serving/slots.py docstring).

    Greedy outputs equal an unpadded per-request reference (the wave
    engine at batch_size=1) up to the kernels' batch-dependent sums:
    admission prefills each prompt at its exact length through a B=1
    scratch cache, and lanes never interact — per-lane positions keep
    attention exact, and rwkv/mamba decode is lane-independent.

    With ``EngineConfig.prefill_chunk_len`` set, admission prefill is
    CHUNK-INTERLEAVED instead: up to ``prefill_lanes`` PrefillLane state
    machines each prefill one prompt through fixed-shape segments
    (slots.chunk_schedule), the tick loop advances at most ONE chunk
    between decode ticks (round-robin across lanes), and a lane admits
    into a slot only when fully prefilled.

    On the card each decode plan's tick is captured once in a CUDA graph
    and replayed (serving/tick.py); a capture that fails raises.  On the
    CPU the same ticks run eagerly.
    """

    #: smoothing for the observed tick-latency EMA the shed predicate and
    #: watchdog read (matches core.scheduler.Plan.ema)
    TICK_EMA = 0.3

    def __init__(self, model: Model, params: Any, *,
                 config: EngineConfig | None = None, sensor=None,
                 extra_plans: dict[str, Callable] | None = None,
                 clock: Callable[[], float] = None, **legacy):
        """All queue/retry/ladder/fault/chunk knobs live on ``config``;
        the old per-engine kwargs are accepted as deprecated aliases.
        ``sensor``/``extra_plans``/``clock`` are real kwargs.  An extra plan ``fn(params, cache, batch) -> (logits,
        cache)`` receives the batch with its ``active`` mask and must
        honour it as ``steps.decode_step`` does (steps.masked_decode_step)."""
        config = _resolve_config("SlotEngine", config, legacy, _SLOT_ALIASES)
        self.config = config
        n_slots, max_seq = config.n_slots, config.max_seq
        super().__init__(model, params, batch_size=n_slots, max_seq=max_seq,
                         pool_capacity=1, sensor=sensor, per_lane_pos=True)
        self.n_slots = n_slots
        self.clock = clock or time.monotonic
        self.queue = RequestQueue(config.queue_capacity, clock=self.clock)
        # completed Results land here until the caller consumes them with
        # take_finished() — long-running submit()/stream() users must drain
        # it, or host memory grows with every retired request
        self.finished: dict[int, Result] = {}

        # -- chunked prefill (admission interleaving) -----------------------
        w = self.cfg.sliding_window or 0
        #: longest prompt the CHUNKED path serves token-identically: a
        #: windowed KV ring starts evicting once the prompt outruns the
        #: cache seq axis.  Longer windowed prompts fall back to
        #: whole-prompt admission.
        self._chunk_safe_len = min(max_seq, w) if w else max_seq
        self._chunk_len = config.prefill_chunk_len
        self.prefill_lanes = config.prefill_lanes
        chunked = self._chunk_len is not None
        if chunked:
            if self.cfg.n_vis_tokens:
                raise ValueError(
                    "chunked prefill cannot serve vis-token prompts (the "
                    "vision prefix is not sliceable); keep "
                    "prefill_chunk_len=None")
            if not 0 < self._chunk_len <= self._chunk_safe_len:
                raise ValueError(
                    f"prefill_chunk_len {self._chunk_len} outside (0, "
                    f"{self._chunk_safe_len}] — chunks longer than the "
                    "cache seq axis would scatter duplicate ring slots")
            if self.prefill_lanes < 1:
                raise ValueError(
                    f"prefill_lanes {self.prefill_lanes} must be >= 1")

        # B=1 scratch the admission prefill runs through, zeroed in place
        # before each prompt.  Whole-prompt mode keeps ONE permanently
        # checked-out buffer; chunked mode pools ``prefill_lanes`` of them
        # (one per concurrent PrefillLane, checked out at lane start and
        # returned — zeroed in place — at admission, abort or failure),
        # plus the whole-prompt buffer when windowed fallbacks are
        # possible.  Either way the pool is built ONCE.
        scratch_spec = model.init_cache(1, max_seq, device="meta")
        self._fallback = chunked and bool(w) and self._chunk_safe_len < max_seq
        self._scratch_pool = StatePool(
            scratch_spec, capacity=(self.prefill_lanes + int(self._fallback)
                                    if chunked else 1), device=self.device)
        self._scratch = (self._scratch_pool.checkout()
                         if not chunked or self._fallback else None)

        # pre-create the serving instruments so metrics snapshots always
        # carry the full schema, zero-valued counters included
        for name in ("serving/ticks", "serving/tokens", "serving/retired",
                     "serving/deadline_miss", "serving/quarantined",
                     "serving/retries", "serving/shed"):
            self.metrics.counter(name)
        self.metrics.histogram("serving/ttft_s")
        self.metrics.histogram("serving/tbt_s")
        if chunked:
            self.metrics.histogram("serving/prefill_chunk_s")

        self._lanes: list[PrefillLane] = []
        self._rr = 0                 # round-robin cursor over live lanes
        self.manager = SlotManager(self.pool.checkout(), n_slots,
                                   token_tail=self.token_tail,
                                   clock=self.clock)

        # -- decode plans: one tick each, captured once --------------------
        graph = self.device.type == "cuda"
        pool = torch.cuda.graph_pool_handle() if graph else None
        self.ticks: dict[str, DecodeTick] = {}
        for name, fn in self._decode_plans(extra_plans or {}).items():
            tick = DecodeTick(fn, params, self.manager.cache,
                              self.manager.tick_batch(), graph=graph,
                              pool=pool)
            self.ticks[name] = tick
            self.scheduler.register(Plan(name, tick, shared=True))
        self.manager.check_resident()

        # -- fault tolerance ------------------------------------------------
        ladder = config.ladder
        unknown = set(ladder or []) - set(self.scheduler.plans)
        if unknown:
            raise ValueError(
                f"ladder names unregistered plans: {sorted(unknown)}")
        self.scheduler.ladder = list(ladder or [])
        self.retry_budget = config.retry_budget
        self.retry_backoff_s = config.retry_backoff_s
        self.tick_slo_s = config.tick_slo_s
        self.slo_breach_ticks = config.slo_breach_ticks
        self.slo_recover_ticks = config.slo_recover_ticks
        self.shed_margin = config.shed_margin
        faults = config.faults
        self.injector = None if faults is None else faults_lib.FaultInjector(
            faults, n_slots, vocab=self.cfg.vocab, max_seq=max_seq,
            token_tail=self.token_tail)
        self._attempts: dict[int, int] = {}   # uid -> retries consumed
        self._retry_backlog: list[tuple[float, Request]] = []
        self._tick_ema: float | None = None
        self._breach_ticks = 0
        self._healthy_ticks = 0

    def _decode_plans(self, extra: dict[str, Callable]
                      ) -> dict[str, Callable]:
        # every plan is wrapped with the active mask (free/finished lanes
        # keep their state untouched), the poison hook, the per-lane finite
        # guard and greedy sampling, so one tick yields (sampled tokens,
        # lane_ok, logits) directly
        def masked(fn=None):
            def plan(p, c, b):
                step = None if fn is None else (
                    lambda _cfg, p_, c_, b_: fn(p_, c_, b_))
                logits, lane_ok, _ = steps_lib.guarded_decode_step(
                    self.cfg, p, c, b, step_fn=step)
                return steps_lib.greedy_sample(logits), lane_ok, logits
            return plan

        plans = {"decode/base": masked()}
        plans.update({n: masked(fn) for n, fn in extra.items()})
        return plans

    # -- prefill dispatches ---------------------------------------------
    def _prefill_sample(self, cache: dict, batch: dict) -> torch.Tensor:
        """Zero the scratch (rwkv/mamba prefill consumes the cache as its
        initial state, so a previous occupant's state must not leak into
        the next prompt), prefill the whole prompt, and sample its first
        greedy token (a (1, [K]) device tensor)."""
        with torch.no_grad():
            for t in tree_leaves(cache):
                t.zero_()
            logits, _ = self._prefill(self.params, cache, batch)
            return steps_lib.greedy_sample(logits)[..., 0]

    def _prefill_chunk(self, cache: dict, batch: dict, first: bool
                       ) -> torch.Tensor:
        """One chunk of a chunked admission (chunk 0 zeroes the scratch
        first); returns the chunk's last position's greedy token."""
        with torch.no_grad():
            if first:
                for t in tree_leaves(cache):
                    t.zero_()
            logits, _ = steps_lib.chunked_prefill_step(self.cfg, self.params,
                                                       cache, batch)
            return steps_lib.greedy_sample(logits)[..., 0]

    # ------------------------------------------------------------------
    def _validate(self, req: Request) -> None:
        """Reject requests that cannot fit their lane BEFORE they queue —
        decode writes token ``i`` at position prompt_len + i, and an
        out-of-range lane write would corrupt another position.  The
        text is held to ``max_seq`` as in the JAX package, which counts
        no vision prefix; a vision request whose prefix, text and new
        tokens pass the cache is refused too (``_check_vision_fit``)."""
        if req.max_new_tokens <= 0:
            return                        # completes without touching a lane
        s = np.asarray(req.prompt).shape[-1]
        if not 0 < s <= self.max_seq:
            raise ValueError(
                f"request {req.uid}: prompt length {s} outside (0, "
                f"{self.max_seq}]")
        if s + req.max_new_tokens - 1 > self.max_seq:
            raise ValueError(
                f"request {req.uid}: prompt {s} + max_new_tokens "
                f"{req.max_new_tokens} - 1 exceeds max_seq {self.max_seq}")
        self._check_vision_fit(req.uid, s, req.max_new_tokens - 1)

    def submit(self, req: Request) -> bool:
        """Queue one request; raises QueueFull (backpressure) when bounded
        queue capacity is reached, ValueError when it cannot fit a lane.
        Returns False — with an immediate ``finish_reason='deadline'``
        Result published to ``finished`` — when the request is dead on
        arrival (its deadline already passed)."""
        self._validate(req)
        if not self.queue.submit(req):
            self.metrics.counter("serving/deadline_miss").inc()
            self._terminal(req, FinishReason.DEADLINE)
            return False
        return True

    def _admit_one(self, index: int, req: Request) -> TokenEvent:
        prompt = np.asarray(req.prompt, np.int32)
        t0 = time.perf_counter()
        tok0 = self._prefill_sample(self._scratch,
                                    self._prefill_batch(prompt[None]))
        prefill_s = time.perf_counter() - t0
        tok0_np = tok0.cpu().numpy()[0]          # () or (K,); blocks
        ttft_s = time.perf_counter() - t0          # admit -> first token
        self.manager.admit(index, req, self._scratch, tok0, prefill_s,
                           ttft_s=ttft_s)
        self.metrics.histogram("serving/ttft_s").observe(ttft_s)
        tracer = trace_lib.get_tracer()
        if tracer.enabled:
            tracer.event("serve/admit", uid=req.uid, slot=index,
                         prompt_len=int(prompt.shape[-1]),
                         prefill_s=prefill_s, ttft_s=ttft_s)
        return TokenEvent(req.uid, tok0_np, 0,
                          done=(req.max_new_tokens <= 1))

    # -- fault-tolerance plumbing --------------------------------------
    def _terminal(self, req: Request, reason: str) -> TokenEvent:
        """Publish a tokenless terminal Result (queue expiry, dead-on-
        arrival deadline, shed, failure out of retries) and return its
        stream event."""
        self._attempts.pop(req.uid, None)
        self.finished[req.uid] = Result(req.uid, self.manager.empty_tokens(),
                                        0.0, 0.0, [], finish_reason=reason)
        return TokenEvent(req.uid, None, 0, done=True, finish_reason=reason)

    def _finish(self, res: Result) -> None:
        """Adopt a retired lane's Result — the one place lane retirement
        updates the metrics and retry bookkeeping."""
        self.metrics.counter("serving/retired").inc()
        self._attempts.pop(res.uid, None)
        self.finished[res.uid] = res

    def _fail_or_retry(self, req: Request, now: float) -> str | None:
        """Shared quarantine / prefill-failure disposition.  Consumes one
        unit of ``retry_budget`` when available: the request re-enters the
        queue after exponential backoff (``retry_backoff_s * 2**attempt``)
        and restarts FROM PREFILL — a retried greedy request therefore
        still produces exactly its fault-free tokens.  Returns None on
        retry, otherwise the terminal finish_reason (ERROR with no budget,
        RETRIES_EXHAUSTED once the budget is spent)."""
        attempts = self._attempts.get(req.uid, 0)
        if attempts < self.retry_budget:
            self._attempts[req.uid] = attempts + 1
            self.metrics.counter("serving/retries").inc()
            ready = now + self.retry_backoff_s * (2.0 ** attempts)
            self._retry_backlog.append((ready, req))
            return None
        return (FinishReason.RETRIES_EXHAUSTED if self.retry_budget > 0
                else FinishReason.ERROR)

    def _prefill_failed(self, req: Request, now: float, err: Exception
                        ) -> Iterator[TokenEvent]:
        """Containment for an admission prefill that raised: emit the
        serve/fault event, then retry or terminate the request.  The
        scratch needs no rebuild: the next admission zeroes it first."""
        injected = isinstance(err, faults_lib.InjectedFault)
        tracer = trace_lib.get_tracer()
        if tracer.enabled:
            tracer.event("serve/fault", kind="prefill", uid=req.uid,
                         injected=injected, error=repr(err))
        reason = self._fail_or_retry(req, now)
        if reason is not None:
            yield self._terminal(req, reason)

    # -- chunked admission ---------------------------------------------
    def _lane_failed(self, lane: PrefillLane, now: float, err: Exception
                     ) -> Iterator[TokenEvent]:
        """Containment for a chunked-prefill attempt that raised: the
        lane's PARTIAL state is discarded (its scratch returns to the pool,
        zeroed in place), so a retry restarts from chunk 0 with a clean
        cache — token-identical to an unfaulted admission."""
        injected = isinstance(err, faults_lib.InjectedFault)
        self._scratch_pool.give_back(lane.cache)
        tracer = trace_lib.get_tracer()
        if tracer.enabled:
            tracer.event("serve/fault", kind="prefill",
                         uid=lane.request.uid, injected=injected,
                         chunk=lane.chunks_done, error=repr(err))
        reason = self._fail_or_retry(lane.request, now)
        if reason is not None:
            yield self._terminal(lane.request, reason)

    def _advance_lane(self, lane: PrefillLane, now: float
                      ) -> Iterator[TokenEvent]:
        """Run ONE prefill chunk for ``lane``; on the final chunk, admit
        the fully-prefilled request into a free slot (the invariant
        ``len(self._lanes) <= free slots`` guarantees one exists)."""
        mgr = self.manager
        req = lane.request
        inj = self.injector
        tracer = trace_lib.get_tracer()
        seg = lane.schedule[0]
        try:
            if inj is not None and inj.take_prefill_fault(
                    req.uid, lane.chunks_done):
                # raised BEFORE the dispatch: the lane cache is untouched
                raise faults_lib.InjectedFault(
                    f"injected prefill fault, uid={req.uid}, "
                    f"chunk={lane.chunks_done}")
            toks = lane.prompt[..., lane.filled:lane.filled + seg]
            t0 = time.perf_counter()
            tok = self._prefill_chunk(lane.cache,
                                      self._prefill_batch(toks[None]),
                                      first=lane.chunks_done == 0)
            block_until_ready(tok)
            chunk_s = time.perf_counter() - t0
        except Exception as err:      # containment: never escapes
            self._lanes.remove(lane)
            yield from self._lane_failed(lane, now, err)
            return
        lane.schedule.pop(0)
        lane.filled += seg
        lane.chunks_done += 1
        lane.prefill_s += chunk_s
        lane.last_tok = tok
        self.metrics.histogram("serving/prefill_chunk_s").observe(chunk_s)
        if tracer.enabled:
            tracer.event("serve/prefill_chunk", uid=req.uid,
                         chunk=lane.chunks_done - 1, seg_len=seg,
                         filled=lane.filled, chunk_s=chunk_s)
        if not lane.done:
            return
        # fully prefilled: admit into a free slot and release the scratch
        self._lanes.remove(lane)
        idx = mgr.free_indices()[0]
        tok0_np = lane.last_tok.cpu().numpy()[0]      # () or (K,)
        ttft_s = time.perf_counter() - lane.t_start
        mgr.admit(idx, req, lane.cache, lane.last_tok, lane.prefill_s,
                  ttft_s=ttft_s)
        self._scratch_pool.give_back(lane.cache)
        self.metrics.histogram("serving/ttft_s").observe(ttft_s)
        if tracer.enabled:
            tracer.event("serve/admit", uid=req.uid, slot=idx,
                         prompt_len=int(lane.prompt.shape[-1]),
                         prefill_s=lane.prefill_s, ttft_s=ttft_s,
                         chunks=lane.chunks_done)
        ev = TokenEvent(req.uid, tok0_np, 0, done=(req.max_new_tokens <= 1))
        yield ev
        if ev.done:
            self._finish(mgr.retire(idx))

    def _admit_chunked(self, now: float, refill) -> Iterator[TokenEvent]:
        """One scheduling round of chunk-interleaved admission: abort
        deadline-expired lanes, start new lanes while scratch buffers AND
        target slots are both free, then advance at most ONE chunk total
        (round-robin across live lanes) before the decode tick runs."""
        mgr = self.manager
        metrics = self.metrics
        inj = self.injector
        tracer = trace_lib.get_tracer()

        # partially-prefilled requests past their deadline abort here —
        # the partial state is discarded and buffers_built is untouched
        for lane in [ln for ln in self._lanes
                     if ln.request.deadline_s is not None
                     and ln.request.deadline_s <= now]:
            self._lanes.remove(lane)
            self._scratch_pool.give_back(lane.cache)
            metrics.counter("serving/deadline_miss").inc()
            yield self._terminal(lane.request, FinishReason.DEADLINE)

        # start lanes: never more live lanes than prefill_lanes OR free
        # slots — every lane must have a slot to land in when it finishes
        while (len(self._lanes) < self.prefill_lanes
               and len(self._lanes) < len(mgr.free_indices())):
            yield from refill()
            req = self.queue.pop()
            if req is None:
                break
            if req.max_new_tokens <= 0:
                # zero-budget request: complete without touching a lane
                self.finished[req.uid] = Result(
                    req.uid, mgr.empty_tokens(), 0.0, 0.0, [])
                yield TokenEvent(req.uid, None, 0, done=True,
                                 finish_reason=FinishReason.LENGTH)
                continue
            prompt = np.asarray(req.prompt, np.int32)
            if prompt.shape[-1] > self._chunk_safe_len:
                # windowed prompt past the cache seq axis: chunked replay
                # through the ring is not token-identical, so this one
                # admission takes the whole-prompt path
                idx = mgr.free_indices()[0]
                try:
                    if inj is not None and inj.take_prefill_fault(req.uid):
                        raise faults_lib.InjectedFault(
                            f"injected prefill fault, uid={req.uid}")
                    ev = self._admit_one(idx, req)
                except Exception as err:
                    yield from self._prefill_failed(req, now, err)
                    continue
                yield ev
                if ev.done:
                    self._finish(mgr.retire(idx))
                continue
            self._lanes.append(PrefillLane(
                request=req, cache=self._scratch_pool.checkout(),
                schedule=chunk_schedule(prompt.shape[-1], self._chunk_len),
                prompt=prompt, t_start=time.perf_counter()))
            if tracer.enabled:
                tracer.event("serve/prefill_start", uid=req.uid,
                             prompt_len=int(prompt.shape[-1]),
                             n_chunks=len(self._lanes[-1].schedule))

        # the chunk budget: ONE fixed-shape prefill per tick-loop
        # iteration, shared round-robin
        if self._lanes:
            self._rr += 1
            yield from self._advance_lane(
                self._lanes[self._rr % len(self._lanes)], now)

    def _watchdog(self, observed_s: float, tick: int) -> None:
        """Tick-latency watchdog driving the degradation ladder: after
        ``slo_breach_ticks`` consecutive ticks over ``tick_slo_s`` the
        scheduler steps one rung down (sched/degrade in the trace); after
        ``slo_recover_ticks`` consecutive healthy ticks it steps back up."""
        ema = self._tick_ema
        self._tick_ema = (observed_s if ema is None else
                          (1 - self.TICK_EMA) * ema
                          + self.TICK_EMA * observed_s)
        if self.tick_slo_s is None:
            return
        if observed_s > self.tick_slo_s:
            self._breach_ticks += 1
            self._healthy_ticks = 0
            if self._breach_ticks >= self.slo_breach_ticks:
                self.scheduler.degrade(reason=f"tick_slo@{tick}")
                self._breach_ticks = 0
        else:
            self._breach_ticks = 0
            self._healthy_ticks += 1
            if (self.scheduler.level > 0
                    and self._healthy_ticks >= self.slo_recover_ticks):
                self.scheduler.recover()
                self._healthy_ticks = 0

    def _run_tick(self, plan: Plan, lanes: tuple[int, ...]
                  ) -> tuple[np.ndarray, np.ndarray]:
        """One decode tick of ``plan``: the poison buffer holds ``lanes``
        for this tick only (written before, cleared after: a healthy tick
        writes nothing), then the host copies of sampled and lane_ok."""
        poison = self.manager.poison
        if lanes:
            mask = np.zeros((self.n_slots,), bool)
            mask[list(lanes)] = True
            poison.copy_(torch.from_numpy(mask))
        sampled, lane_ok, _ = plan.fn()
        sampled, lane_ok = sampled.cpu().numpy(), lane_ok.cpu().numpy()
        if lanes:
            poison.zero_()
        return sampled, lane_ok

    def stream(self, requests: list[Request] | None = None
               ) -> Iterator[TokenEvent]:
        """Run the continuous-batching loop, yielding one TokenEvent per
        generated token (plus terminal events), until queue and slots
        drain.  ``requests`` are fed into the bounded queue as space frees
        — external callers use ``submit`` and get backpressure instead.

        Results are published through ``self.finished`` as slots retire.
        The prefills and ticks run under ``torch.no_grad()`` themselves,
        so the caller's grad mode is never changed between events.
        """
        for req in requests or []:
            self._validate(req)          # fail fast, not mid-stream
        pending = collections.deque(requests or [])
        mgr = self.manager
        metrics = self.metrics
        inj = self.injector
        tick = 0
        while (pending or len(self.queue) or mgr.any_occupied
               or self._retry_backlog or self._lanes):
            now = self.clock()
            tracer = trace_lib.get_tracer()

            # injected queue floods land first: synthetic dead weight
            # competing with real work for bounded queue space.  A flood
            # bouncing off a full queue is dropped, not tracked.
            if inj is not None:
                for req in inj.flood_requests(tick, now):
                    if tracer.enabled:
                        tracer.event("serve/fault", kind="flood", tick=tick,
                                     uid=req.uid)
                    try:
                        if not self.queue.submit(req, now=now):
                            metrics.counter("serving/deadline_miss").inc()
                            yield self._terminal(req, FinishReason.DEADLINE)
                    except QueueFull:
                        pass

            # quarantined requests whose backoff elapsed re-enter the
            # queue (ahead of fresh `pending` work)
            if self._retry_backlog:
                still: list[tuple[float, Request]] = []
                for ready_t, req in self._retry_backlog:
                    if ready_t > now or self.queue.full:
                        still.append((ready_t, req))
                    elif not self.queue.submit(req, now=now):
                        metrics.counter("serving/deadline_miss").inc()
                        yield self._terminal(req, FinishReason.DEADLINE)
                self._retry_backlog = still

            def refill_and_expire():
                """Top the queue up from `pending`, then drop anything whose
                deadline already passed.  A pending request dead on
                arrival terminates immediately without queueing."""
                while pending and not self.queue.full:
                    req = pending.popleft()
                    if not self.queue.submit(req, now=now):
                        metrics.counter("serving/deadline_miss").inc()
                        yield self._terminal(req, FinishReason.DEADLINE)
                for req in self.queue.expire(now):
                    metrics.counter("serving/deadline_miss").inc()
                    yield self._terminal(req, FinishReason.DEADLINE)

            yield from refill_and_expire()
            # resident lanes past their deadline retire with what they have
            for idx in mgr.expired_indices(now):
                res = mgr.retire(idx, finish_reason=FinishReason.DEADLINE)
                metrics.counter("serving/deadline_miss").inc()
                self._finish(res)
                yield TokenEvent(res.uid, None, res.tokens.shape[-1],
                                 done=True,
                                 finish_reason=FinishReason.DEADLINE)

            # degradation ladder, shed half: once degraded, queued requests
            # whose deadlines are provably unmeetable under the observed
            # tick latency are dropped now
            if self.scheduler.level > 0 and self._tick_ema is not None:
                horizon = now + self.shed_margin * self._tick_ema
                for req in self.queue.shed(
                        lambda r: r.deadline_s is not None
                        and r.deadline_s <= horizon):
                    metrics.counter("serving/shed").inc()
                    if tracer.enabled:
                        tracer.event("serve/shed", uid=req.uid, tick=tick,
                                     deadline_s=req.deadline_s,
                                     tick_ema_s=self._tick_ema)
                    yield self._terminal(req, FinishReason.SHED)

            # step-granular admission — chunk-interleaved (at most one
            # prefill chunk before the decode tick) or whole-prompt
            if self._chunk_len is not None:
                yield from self._admit_chunked(now, refill_and_expire)
            else:
                for idx in mgr.free_indices():
                    yield from refill_and_expire()
                    req = self.queue.pop()
                    if req is None:
                        break
                    if req.max_new_tokens <= 0:
                        # zero-budget request: complete without a lane
                        self.finished[req.uid] = Result(
                            req.uid, mgr.empty_tokens(), 0.0, 0.0, [])
                        yield TokenEvent(req.uid, None, 0, done=True,
                                         finish_reason=FinishReason.LENGTH)
                        continue
                    try:
                        if (inj is not None
                                and inj.take_prefill_fault(req.uid)):
                            # raised BEFORE the dispatch: the scratch is
                            # untouched
                            raise faults_lib.InjectedFault(
                                f"injected prefill fault, uid={req.uid}")
                        ev = self._admit_one(idx, req)
                    except Exception as err:  # containment: never escapes
                        yield from self._prefill_failed(req, now, err)
                        continue
                    yield ev
                    if ev.done:
                        self._finish(mgr.retire(idx))

            queue_depth = len(self.queue)
            occupied = sum(1 for s in mgr.slots if s.occupied)
            metrics.gauge("serving/queue_depth").set(float(queue_depth))
            metrics.gauge("serving/occupancy").set(occupied / mgr.n_slots)

            if not mgr.active_mask().any():
                if (pending or len(self.queue) or self._retry_backlog
                        or self._lanes):
                    # only expiries/zero-token admissions/backoffs/partial
                    # prefills left; lanes advance one chunk per iteration
                    continue
                break

            # ONE fused masked decode tick across all lanes — the span
            # wraps choose + replay + host copy, so the per-tick
            # sched/choose event nests under serve/tick in the trace
            span = (tracer.span("serve/tick", tick=tick,
                                queue_depth=queue_depth, occupied=occupied)
                    if tracer.enabled else trace_lib.NULL_SPAN)
            with span:
                d = self.scheduler.choose()
                plan = self.scheduler.plans[d.plan]
                lanes = inj.poison_lanes(tick) if inj is not None else ()
                if lanes and tracer.enabled:
                    for lane in lanes:
                        tracer.event("serve/fault", kind="poison",
                                     tick=tick, lane=lane)
                t0 = time.perf_counter()
                sampled, lane_ok = self._run_tick(plan, lanes)
                tick_s = time.perf_counter() - t0
                extra_s = inj.slow_s(tick) if inj is not None else 0.0
                if extra_s and tracer.enabled:
                    tracer.event("serve/fault", kind="slow", tick=tick,
                                 extra_s=extra_s)
                observed_s = tick_s + extra_s
                plan.observe(observed_s, d.load)
                span.set(plan=d.plan, load=d.load, tick_s=tick_s,
                         observed_s=observed_s)
            metrics.counter("serving/ticks").inc()
            self._watchdog(observed_s, tick)

            # quarantine: any ACTIVE lane whose finite guard tripped
            # retires NOW, before its poisoned token could be recorded —
            # retire() zeroes just that lane in place, so its neighbours
            # and the zero-allocation invariant are untouched
            for s in [s for s in mgr.slots
                      if s.occupied and not lane_ok[s.index]]:
                req = s.request
                metrics.counter("serving/quarantined").inc()
                reason = self._fail_or_retry(req, now)
                res = mgr.retire(s.index,
                                 finish_reason=reason or FinishReason.ERROR)
                if tracer.enabled:
                    tracer.event("serve/quarantine", uid=req.uid,
                                 slot=s.index, tick=tick,
                                 action="retry" if reason is None
                                 else reason)
                if reason is None:
                    # retry path: partial output discarded — the retry
                    # restarts from prefill and regenerates the same
                    # greedy tokens
                    continue
                self._finish(res)
                yield TokenEvent(req.uid, None, res.tokens.shape[-1],
                                 done=True, finish_reason=reason)
            tick += 1

            just_active = [s.index for s in mgr.slots
                           if s.occupied and s.remaining > 0]
            done_idx = set(mgr.record(sampled, d.plan))
            metrics.counter("serving/tokens").inc(len(just_active))
            token_t = time.perf_counter()
            tbt = metrics.histogram("serving/tbt_s")
            for idx in just_active:
                s = mgr.slots[idx]
                tbt.observe(token_t - s.last_token_t)
                s.last_token_t = token_t
                yield TokenEvent(s.request.uid, np.asarray(sampled[idx],
                                                           np.int32),
                                 len(s.tokens) - 1, done=idx in done_idx)
            for idx in done_idx:
                self._finish(mgr.retire(idx))

        # one summary record per drained stream: every counter (including
        # zero-valued deadline_miss), gauge and histogram summary
        tracer = trace_lib.get_tracer()
        if tracer.enabled:
            tracer.event("serve/metrics", **metrics.snapshot())

    def take_finished(self) -> dict[int, Result]:
        """Pop and return every completed Result (uid -> Result).  The
        consumption half of the streaming API: call it periodically from a
        long-running submit()/stream() loop to keep host memory bounded."""
        out, self.finished = self.finished, {}
        return out

    def serve(self, requests: list[Request],
              on_token: Callable[[TokenEvent], None] | None = None
              ) -> list[Result]:
        """Convenience wrapper: stream everything, return per-request
        Results in submission order."""
        self.finished = {}
        for ev in self.stream(requests):
            if on_token is not None:
                on_token(ev)
        done = self.take_finished()
        return [done[r.uid] for r in requests]
