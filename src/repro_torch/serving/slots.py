"""Request and result types of serving (the part of the JAX package's
``serving/slots.py`` the wave engine uses; the slot-resident machinery
comes with the slot engine's slice)."""
from __future__ import annotations

import dataclasses

import numpy as np


class FinishReason:
    """The CLOSED set of terminal request states.  Every Result carries
    exactly one of these (validated in ``Result.__post_init__``):

      * ``LENGTH``            — produced its full ``max_new_tokens`` budget;
      * ``DEADLINE``          — ``deadline_s`` passed;
      * ``ERROR``             — lane quarantined or prefill failure;
      * ``RETRIES_EXHAUSTED`` — failed more times than the retry budget;
      * ``SHED``              — dropped from the queue by the degradation
                                ladder.
    The wave engine finishes every request with ``LENGTH``.
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
    prompt: np.ndarray               # (S,) int32
    max_new_tokens: int = 16
    # absolute deadline on the engine clock; None = no deadline (read by
    # the slot engine)
    deadline_s: float | None = None


@dataclasses.dataclass
class Result:
    uid: int
    tokens: np.ndarray               # (m,); m may be 0
    prefill_s: float
    decode_s: float
    plan_decisions: list[str]
    finish_reason: str = FinishReason.LENGTH   # one of FINISH_REASONS
    #: admission -> first sampled token available on host, seconds
    ttft_s: float = 0.0

    def __post_init__(self) -> None:
        if self.finish_reason not in FINISH_REASONS:
            raise ValueError(
                f"finish_reason {self.finish_reason!r} outside the closed "
                f"set {sorted(FINISH_REASONS)}")
