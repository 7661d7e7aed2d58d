"""Family-generic tiling substrate: one (batch_tile, time_chunk) layer.

MobiRNN's tuning loop — pick the COARSEST work unit whose working set fits
fast memory, stream what does not fit, shrink the work unit only as a last
resort — is a property of the recurrence shape, not of any one device.  On
Hopper the fast memory is a thread block's shared memory
(core/factorization.H100_SMEM_PER_BLOCK); the term algebra and the search
order are the JAX package's ``core/tiling.py`` unchanged:

* ``WorkingSet``: a named-term accumulator whose ``bwd_only`` terms count
  only under ``mode="bwd"`` (the training working set);
* ``streamed_rows``: whole-axis residency vs ``STREAM_SLOTS``
  double-buffered chunk windows; ``bwd_window_rows``: the reverse sweep's
  trajectory window, one overlap row longer;
* ``joint_search``: whole-T residency at the coarsest batch tile first, then
  streamed time chunks from coarse to fine, then smaller batch tiles.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Iterator, Protocol, runtime_checkable

#: Streamed axes are double-buffered: one window computes while the next
#: prefetches (the x ring of kernels/csrc/lstm_seq.cu).
STREAM_SLOTS = 2


@runtime_checkable
class TilePlan(Protocol):
    """The interface every family's tiling result presents: ``batch_tile``
    rows of the batch-like axis per thread block, ``time_chunk`` the
    streamed time-window length, or None for whole-axis residency."""

    @property
    def batch_tile(self) -> int: ...

    @property
    def time_chunk(self) -> int | None: ...


def check_mode(mode: str) -> str:
    """Validate the fwd/bwd phase split shared by the budget tables."""
    if mode not in ("fwd", "bwd"):
        raise ValueError(f"mode must be 'fwd' or 'bwd', got {mode!r}")
    return mode


def weight_dtype_bytes(dtype_bytes: int, w_dtype_bytes: int | None = None,
                       quantized: bool = False) -> int:
    """Bytes per weight under the shared parameterisation: an explicit
    ``w_dtype_bytes`` wins; otherwise quantized plans hold int8 weights
    (1 byte) and float plans hold activation-width weights."""
    if w_dtype_bytes is not None:
        return w_dtype_bytes
    return 1 if quantized else dtype_bytes


def streamed_rows(seq_len: int, time_chunk: int | None) -> int:
    """Rows a (possibly streamed) sequence-axis buffer holds: the whole
    axis when ``time_chunk`` is None, else ``STREAM_SLOTS`` double-buffered
    windows of ``min(time_chunk, seq_len)`` rows."""
    if time_chunk is None:
        return seq_len
    return STREAM_SLOTS * min(time_chunk, seq_len)


def bwd_window_rows(seq_len: int, time_chunk: int) -> int:
    """Rows per reverse-sweep trajectory window: a chunked backward needs
    the t-1 row of the previous chunk, so each window carries one overlap
    row whenever more than one chunk exists."""
    tc = min(time_chunk, seq_len)
    return tc + 1 if seq_len > tc else tc


@dataclasses.dataclass
class WorkingSet:
    """Named-term working set of ONE thread block — the algebra the budget
    tables are written in.  ``bwd_only`` terms count only under
    ``mode="bwd"``, the working set of the training kernels.  ``total()``
    is what the budget compares; ``terms`` is what tests and the ROADMAP
    table introspect."""
    mode: str = "fwd"
    terms: dict[str, int] = dataclasses.field(default_factory=dict)

    def __post_init__(self):
        check_mode(self.mode)

    def add(self, name: str, nbytes: int, bwd_only: bool = False
            ) -> "WorkingSet":
        if bwd_only and self.mode != "bwd":
            return self
        self.terms[name] = self.terms.get(name, 0) + int(nbytes)
        return self

    def total(self) -> int:
        return sum(self.terms.values())


def halving(start: int) -> Iterator[int]:
    """Coarse-to-fine halving walk: start, start//2, ..., 1."""
    c = max(1, start)
    while True:
        yield c
        if c <= 1:
            return
        c = max(c // 2, 1)


def joint_search(batch: int, seq_len: int,
                 fits: Callable[[int, int | None], bool], *,
                 seed_batch_tile: int | None = None
                 ) -> tuple[int, int | None] | None:
    """The coarseness-ordered joint ``(batch_tile, time_chunk)`` search.

    ``fits(batch_tile, time_chunk)`` is the family's working-set-vs-budget
    predicate (``time_chunk=None`` = whole-axis residency).  Order:

    1. whole-T residency at the current batch tile when it fits;
    2. otherwise stream the time axis — a halving sweep from
       ``seq_len // 2`` down to 1 takes the first, coarsest chunk that
       fits;
    3. only when even ``tc=1`` does not fit, halve the batch tile and retry.

    Returns ``(batch_tile, time_chunk)`` or None when even ``(1, 1)`` does
    not fit, and the caller routes to its fallback plan.
    """
    bm = batch if seed_batch_tile is None else seed_batch_tile
    bm = max(1, min(bm, batch))
    start = max(seq_len // 2, 1)
    while bm >= 1:
        if fits(bm, None):
            return bm, None
        for tc in halving(start):
            if fits(bm, tc):
                return bm, tc
        if bm == 1:
            break
        bm = max(bm // 2, 1)
    return None
