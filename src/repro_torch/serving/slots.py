"""Slot-resident continuous batching over preallocated recurrent state (the
port's twin of the JAX package's ``serving/slots.py``).

The wave engine (serving/engine.Engine) serves lockstep batches: every
request in a wave is padded to the longest prompt and the longest
``max_new_tokens``, so one long request stalls its lane-mates and finished
lanes ride along as dead weight.  This module turns the batch axis into B
independent **slots**:

* each slot owns a fixed lane (index ``i`` of the batch axis) of ONE
  preallocated cache checked out from core/state.StatePool — lane state
  for the RNN/SSM/attention families is fixed-shape, so no paged-KV
  machinery is needed;
* requests wait in a bounded ``RequestQueue`` (FIFO, backpressure by
  raising ``QueueFull``, per-request deadlines);
* admission prefills the new prompt through a B=1 scratch cache and
  copies it into the free lane in place (core/state.lane_write);
* every tick runs ONE fused masked decode step across all lanes
  (steps.guarded_decode_step, captured in a CUDA graph on the card:
  serving/tick.py) — free/finished lanes are carried by a per-slot active
  mask and per-lane ``pos`` counters;
* retirement zeroes JUST that lane in place (core/state.lane_zero) and
  the next queued request is admitted immediately.

The JAX manager rebinds ``self.cache`` to what its donated jits return.
The port's ``SlotManager.cache`` is NEVER rebound: its tensors, and the
``tokens``/``active``/``poison`` buffers, are the ones a captured decode
tick reads and writes by address, so every admit and retire writes one
lane of them in place and checks that no leaf moved (``check_resident``).

Invariants (the MobiRNN rules at serving granularity):
  * fixed shapes — the decode tick has ONE shape for the life of the
    engine, whatever the occupancy;
  * no serving-path allocation — pool buffers are built once
    (``StatePool.stats.buffers_built == capacity`` forever);
  * step-granular admission/retirement — a lane never waits for its
    neighbours (RTMobile's real-time admission argument, PAPERS.md).
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Any, Callable

import numpy as np
import torch

from repro_torch.core import state as state_lib
from repro_torch.optim.adamw import tree_leaves


class QueueFull(RuntimeError):
    """Bounded-queue backpressure: the caller must retry or shed load."""


class FinishReason:
    """The CLOSED set of terminal request states.  Every Result carries
    exactly one of these (validated in ``Result.__post_init__``) — a
    request always terminates with a DEFINITE reason:

      * ``LENGTH``            — produced its full ``max_new_tokens`` budget;
      * ``DEADLINE``          — ``deadline_s`` passed (queued: zero tokens;
                                resident: whatever it produced so far);
      * ``ERROR``             — lane quarantined (non-finite decode output)
                                or prefill failure, with no retry budget;
      * ``RETRIES_EXHAUSTED`` — quarantined/failed more times than the
                                engine's ``retry_budget`` allowed;
      * ``SHED``              — dropped from the queue by the degradation
                                ladder: its deadline was provably unmeetable
                                under the observed tick latency.
    """
    LENGTH = "length"
    DEADLINE = "deadline"
    ERROR = "error"
    RETRIES_EXHAUSTED = "retries_exhausted"
    SHED = "shed"


FINISH_REASONS = frozenset({
    FinishReason.LENGTH, FinishReason.DEADLINE, FinishReason.ERROR,
    FinishReason.RETRIES_EXHAUSTED, FinishReason.SHED})


@dataclasses.dataclass
class Request:
    uid: int
    prompt: np.ndarray               # (S,) int32 (or (K,S) for audio)
    max_new_tokens: int = 16
    # absolute deadline on the engine clock (time.monotonic by default);
    # None = no deadline.  Expired requests are retired with
    # finish_reason='deadline' — from the queue without running, from a
    # slot with whatever tokens they produced so far.
    deadline_s: float | None = None


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray               # (m,) or (K, m); m may be 0 on expiry
    prefill_s: float
    decode_s: float
    plan_decisions: list[str]
    finish_reason: str = FinishReason.LENGTH   # one of FINISH_REASONS
    #: admission -> first sampled token available on host, seconds.
    #: 0.0 for requests that never reached a lane (queue expiry,
    #: zero-token budgets) — mirrors prefill_s there.
    ttft_s: float = 0.0

    def __post_init__(self) -> None:
        if self.finish_reason not in FINISH_REASONS:
            raise ValueError(
                f"finish_reason {self.finish_reason!r} outside the closed "
                f"set {sorted(FINISH_REASONS)}")


@dataclasses.dataclass
class TokenEvent:
    """One streamed token (or a terminal marker) surfaced per tick."""
    uid: int
    token: np.ndarray | None         # () or (K,) int32; None on tokenless end
    index: int                       # position within the request's output
    done: bool
    finish_reason: str | None = None


def chunk_schedule(prompt_len: int, chunk_len: int) -> list[int]:
    """Fixed-shape segment decomposition of one prompt: ``prompt_len //
    chunk_len`` full chunks, then the remainder in DESCENDING powers of
    two (its binary decomposition).

    Every segment length is either ``chunk_len`` or a power of two below
    it, so however ragged the prompt mix, chunked prefill runs at most
    ``1 + ceil(log2(chunk_len))`` distinct shapes (the JAX package's bound
    on compiled executables).  Bigger segments come first, so the tail
    segments (the cheap ones) are what lands between the final decode
    ticks before admission."""
    if prompt_len < 0 or chunk_len < 1:
        raise ValueError(f"chunk_schedule({prompt_len}, {chunk_len})")
    full, r = divmod(prompt_len, chunk_len)
    segs = [chunk_len] * full
    for b in reversed(range(r.bit_length())):
        if (r >> b) & 1:
            segs.append(1 << b)
    return segs


@dataclasses.dataclass
class PrefillLane:
    """State machine for one partially-prefilled admission: holds the
    request, its B=1 scratch cache (checked out from the engine's scratch
    StatePool; returned, zeroed in place, at admission, abort or failure
    — ``buffers_built`` stays at capacity through every path), and the
    remaining fixed-shape segment schedule.

    Lifecycle: FILLING (schedule non-empty) -> DONE (``done``: last
    chunk's sampled token is ready and the lane admits into a free slot)
    | ABORTED (deadline passed mid-prefill: partial state is discarded)
    | FAILED (a chunk attempt raised — injected or real; retry restarts
    from chunk 0 with a zeroed scratch, so the retried prefill is
    bit-identical to an unfaulted one)."""
    request: Request
    cache: Any                      # B=1 scratch, owned until release
    schedule: list[int]             # remaining segment lengths
    prompt: np.ndarray = None       # int32 view of request.prompt
    filled: int = 0                 # prompt tokens already prefilled
    chunks_done: int = 0
    t_start: float = 0.0            # perf_counter at lane start (TTFT)
    prefill_s: float = 0.0          # accumulated chunk dispatch time
    last_tok: Any = None            # device token from the latest chunk

    @property
    def done(self) -> bool:
        return not self.schedule


class RequestQueue:
    """Bounded FIFO admission queue with deadline expiry."""

    def __init__(self, capacity: int, clock: Callable[[], float] = None):
        assert capacity >= 1
        self.capacity = capacity
        self.clock = clock or time.monotonic
        self._q: collections.deque[Request] = collections.deque()

    def __len__(self) -> int:
        return len(self._q)

    @property
    def full(self) -> bool:
        return len(self._q) >= self.capacity

    def submit(self, req: Request, now: float | None = None) -> bool:
        """Queue one request.  Returns True when queued; False when the
        request is dead on arrival — its ``deadline_s`` has ALREADY passed
        (the caller publishes the immediate ``finish_reason='deadline'``
        Result).  Raises QueueFull (backpressure) when the bounded
        capacity is reached."""
        if req.deadline_s is not None:
            now = self.clock() if now is None else now
            if req.deadline_s <= now:
                return False
        if self.full:
            raise QueueFull(
                f"RequestQueue full (capacity={self.capacity}); "
                "slot-resident serving bounds queued work — retry later")
        self._q.append(req)
        return True

    def expire(self, now: float | None = None) -> list[Request]:
        """Remove and return every queued request whose deadline passed.

        One pass, partitioned by identity — ``deque.remove`` would compare
        dataclasses whose ndarray prompts make ``==`` ambiguous."""
        now = self.clock() if now is None else now
        expired: list[Request] = []
        keep: collections.deque[Request] = collections.deque()
        for r in self._q:
            if r.deadline_s is not None and r.deadline_s <= now:
                expired.append(r)
            else:
                keep.append(r)
        self._q = keep
        return expired

    def shed(self, predicate: Callable[[Request], bool]) -> list[Request]:
        """Remove and return every queued request ``predicate`` marks as
        sheddable (the degradation ladder's provably-unmeetable sweep).
        Same identity-partitioned single pass as ``expire``."""
        dropped: list[Request] = []
        keep: collections.deque[Request] = collections.deque()
        for r in self._q:
            (dropped if predicate(r) else keep).append(r)
        self._q = keep
        return dropped

    def pop(self) -> Request | None:
        return self._q.popleft() if self._q else None


@dataclasses.dataclass
class Slot:
    """Host-side bookkeeping for one lane of the resident cache."""
    index: int
    request: Request | None = None
    remaining: int = 0               # decode tokens still owed
    tokens: list = dataclasses.field(default_factory=list)
    prefill_s: float = 0.0
    admitted_t: float = 0.0
    ttft_s: float = 0.0              # admit -> first token, host-visible
    last_token_t: float = 0.0        # perf_counter of the latest token (TBT)
    plan_decisions: list = dataclasses.field(default_factory=list)

    @property
    def occupied(self) -> bool:
        return self.request is not None


class SlotManager:
    """B lanes of one pooled cache buffer + the tick's device buffers.

    The manager owns the device cache (``pos`` in its per-lane (B,) vector
    form) and the per-slot host records; the engine owns params, the decode
    ticks and the scheduler and drives ticks.  ``tokens`` (B,) + ``token_tail``
    int32 (the tail is (K,) for an audio model's codebooks, as in the JAX
    package), ``active`` (B,) bool and ``poison`` (B,) bool live on the cache's
    device and are only written in place: one lane at an admit or retire,
    ``tokens`` as a whole by the tick itself (JAX's ``set_sampled``),
    ``poison`` only around a fault tick.  Nothing is uploaded on a healthy
    tick.
    """

    def __init__(self, cache: Any, n_slots: int,
                 token_tail: tuple[int, ...] = (),
                 clock: Callable[[], float] = None):
        self.cache = cache
        self.n_slots = n_slots
        self.clock = clock or time.monotonic
        self.slots = [Slot(i) for i in range(n_slots)]
        self._token_tail = tuple(token_tail)
        device = cache["pos"].device
        self.tokens = torch.zeros((n_slots,) + self._token_tail,
                                  dtype=torch.int32, device=device)
        self.active = torch.zeros(n_slots, dtype=torch.bool, device=device)
        self.poison = torch.zeros(n_slots, dtype=torch.bool, device=device)
        self._resident = self._addresses()

    def _addresses(self) -> list[int]:
        return [t.data_ptr() for t in (*tree_leaves(self.cache), self.tokens,
                                       self.active, self.poison)]

    def check_resident(self) -> None:
        """Raise if a leaf of the cache or a tick buffer was rebound (a
        captured tick would then read and write freed memory)."""
        if self._addresses() != self._resident:
            raise RuntimeError("SlotManager: a resident buffer was rebound; "
                               "the captured decode tick reads the old one")

    # -- occupancy ------------------------------------------------------
    def free_indices(self) -> list[int]:
        return [s.index for s in self.slots if not s.occupied]

    @property
    def any_occupied(self) -> bool:
        return any(s.occupied for s in self.slots)

    def active_mask(self) -> np.ndarray:
        return np.array([s.occupied and s.remaining > 0
                         for s in self.slots], bool)

    def expired_indices(self, now: float | None = None) -> list[int]:
        now = self.clock() if now is None else now
        return [s.index for s in self.slots
                if s.occupied and s.request.deadline_s is not None
                and s.request.deadline_s <= now]

    # -- lane lifecycle -------------------------------------------------
    def admit(self, index: int, req: Request, lane_cache: Any,
              first_token: torch.Tensor, prefill_s: float,
              ttft_s: float | None = None) -> Slot:
        """Copy a freshly prefilled request into a free lane, in place.

        ``lane_cache`` is the B=1 scratch cache holding the prompt's state
        (0-d ``pos`` = prompt length); its single lane is written into lane
        ``index`` (core/state.lane_write), with the prompt's first sampled
        token (``first_token``, a device tensor of one step's token: one
        element, or K for codebooks).  ``ttft_s``
        is the admit->first-token wall time the engine measured; defaults
        to ``prefill_s``."""
        s = self.slots[index]
        assert not s.occupied, index
        state_lib.lane_write(self.cache["slots"], lane_cache["slots"], index,
                             axis=1)
        self.cache["pos"][index:index + 1].copy_(
            lane_cache["pos"].reshape(1))
        self.tokens[index:index + 1].copy_(
            first_token.reshape((1,) + self._token_tail))
        self.active[index] = True
        self.check_resident()
        s.request = req
        s.tokens = [np.asarray(first_token.cpu().numpy().reshape(
            self._token_tail), np.int32)]
        s.remaining = req.max_new_tokens - 1
        s.prefill_s = prefill_s
        s.admitted_t = time.perf_counter()
        s.ttft_s = prefill_s if ttft_s is None else ttft_s
        s.last_token_t = s.admitted_t
        s.plan_decisions = []
        return s

    def retire(self, index: int,
               finish_reason: str = FinishReason.LENGTH) -> Result:
        """Reset ONE lane in place and free the slot for the next request."""
        s = self.slots[index]
        assert s.occupied, index
        state_lib.lane_zero(self.cache["slots"], index, axis=1)
        self.cache["pos"][index] = 0
        self.tokens[index] = 0
        self.active[index] = False
        self.check_resident()
        toks = (np.stack(s.tokens, axis=-1) if s.tokens
                else self.empty_tokens())
        res = Result(uid=s.request.uid, tokens=toks, prefill_s=s.prefill_s,
                     decode_s=time.perf_counter() - s.admitted_t,
                     plan_decisions=s.plan_decisions,
                     finish_reason=finish_reason, ttft_s=s.ttft_s)
        self.slots[index] = Slot(index)
        return res

    def empty_tokens(self) -> np.ndarray:
        """Zero-length token array of the right per-request shape."""
        return np.zeros(self._token_tail + (0,), np.int32)

    # -- tick interface -------------------------------------------------
    def tick_batch(self) -> dict:
        """The fixed-shape, device-resident batch of one fused masked
        decode step — nothing is uploaded per tick."""
        return {"tokens": self.tokens, "active": self.active,
                "poison": self.poison}

    def record(self, sampled: np.ndarray, plan: str) -> list[int]:
        """Fold one tick's greedy samples (host copy) into the active
        lanes; returns the indices that just produced their final token."""
        finished = []
        for s in self.slots:
            if not (s.occupied and s.remaining > 0):
                continue
            s.tokens.append(np.asarray(sampled[s.index], np.int32))
            s.remaining -= 1
            s.plan_decisions.append(plan)
            if s.remaining == 0:
                finished.append(s.index)
        return finished
