"""Preallocated, reusable recurrent-state pools (paper §3.2) — the port's
twin of the JAX package's ``core/state.py``.

MobiRNN preallocates the recurrent state once (its shapes are static given
the model) and reuses it as work retires, bounding live memory.
``StatePool`` is an allocation-free checkout/return pool over buffers built
once: checkout never allocates, exhaustion raises (backpressure), and
``give_back`` zeroes the buffer IN PLACE, so ``stats.buffers_built`` stays
at ``capacity`` for the life of the pool.  The JAX package gets in-place
updates by donating buffers to its jits; the port writes into the
checked-out tensors directly (``copy_``, ``zero_``).  The lane-granular
helpers (``lane_write``/``lane_zero``) serve slot-resident continuous
batching (serving/slots.py): one batch axis of a pooled buffer is B
independent lanes, and admission writes, and retirement zeroes, JUST one
lane of the preallocated tree in place (no fresh zero tensor, no whole-
buffer copy).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.optim.adamw import tree_leaves, tree_map


def make_buffer(spec_tree: Any, device: str | torch.device) -> Any:
    """A tree of zeros on ``device`` shaped like ``spec_tree`` (tensors,
    typically on the ``meta`` device, whose shapes and dtypes it takes)."""
    return tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype,
                                          device=device), spec_tree)


@dataclasses.dataclass
class PoolStats:
    capacity: int = 0
    outstanding: int = 0
    high_water: int = 0
    checkouts: int = 0
    resets: int = 0
    buffers_built: int = 0        # must stay == capacity after __init__
    allocation_bytes: int = 0


class StatePool:
    """Fixed-capacity pool of identically-shaped state trees on one
    device."""

    def __init__(self, spec_tree: Any, capacity: int,
                 device: str | torch.device = "cpu"):
        self._free: list[Any] = []
        self.stats = PoolStats(capacity=capacity)
        for _ in range(capacity):
            self._free.append(make_buffer(spec_tree, device))
            self.stats.buffers_built += 1
        per_buf = sum(t.numel() * t.element_size()
                      for t in tree_leaves(spec_tree))
        self.stats.allocation_bytes = per_buf * capacity

    def checkout(self) -> Any:
        if not self._free:
            raise RuntimeError(
                f"StatePool exhausted (capacity={self.stats.capacity}); "
                "MobiRNN-style preallocation bounds concurrency — release a "
                "buffer or size the pool to the wavefront width.")
        buf = self._free.pop()
        self.stats.outstanding += 1
        self.stats.checkouts += 1
        self.stats.high_water = max(self.stats.high_water,
                                    self.stats.outstanding)
        return buf

    def give_back(self, buf: Any) -> None:
        """Return a buffer, zeroed in place (no fresh storage)."""
        for t in tree_leaves(buf):
            t.zero_()
        self._free.append(buf)
        self.stats.resets += 1
        self.stats.outstanding -= 1


# ---------------------------------------------------------------------------
# Lane-granular state ops (slot-resident continuous batching)
# ---------------------------------------------------------------------------
def lane_write(tree: Any, lane: Any, index: int, axis: int) -> Any:
    """Copy a width-1 ``lane`` slice into position ``index`` of ``axis`` on
    every leaf of ``tree``, in place (``lane`` leaves carry the singleton
    axis, e.g. a B=1 prefill cache written into lane i of a B-lane
    buffer; a dtype differing from the target's is cast).  Returns
    ``tree``, its tensors unchanged."""
    big, small = tree_leaves(tree), tree_leaves(lane)
    if len(big) != len(small):
        raise ValueError(f"lane_write: {len(small)} lane leaves for "
                         f"{len(big)} leaves")
    for b, s in zip(big, small):
        b.narrow(axis, index, 1).copy_(s)
    return tree


def lane_zero(tree: Any, index: int, axis: int) -> Any:
    """Zero position ``index`` of ``axis`` on every leaf, in place (slot
    retirement: the lane-granular ``StatePool.give_back``).  Returns
    ``tree``, its tensors unchanged."""
    for b in tree_leaves(tree):
        b.narrow(axis, index, 1).zero_()
    return tree
