"""Serving metrics: plain-Python counters, gauges, bounded histograms (the
port's copy of the JAX package's ``obs/metrics.py``, which imports nothing
of JAX either).

The serving invariant these must respect: after warmup the slot engine
performs ZERO device allocations per tick (StatePool.stats.buffers_built
stays at capacity).  Everything here is host-side — ints, floats, and a
bounded ``collections.deque`` — so metrics can stay enabled on the hot
path unconditionally.  Histograms are bounded (default 4096 samples,
matching Scheduler.MAX_DECISIONS) so a long-lived engine is not a slow
host-memory leak.

Percentiles use nearest-rank on a sorted snapshot — exact for the sample
sizes here, no interpolation surprises at p99 with small n.

Serving instruments (pre-created by SlotEngine so snapshots always carry
the full schema): counters serving/{ticks,tokens,retired,deadline_miss,
quarantined,retries,shed}; histograms serving/ttft_s (admission -> first
token host-visible — under chunked prefill this spans every interleaved
chunk, the TTFT-under-contention number the adversary benchmarks bound),
serving/tbt_s, and serving/prefill_chunk_s (per fixed-shape chunk
dispatch; chunked mode only).
"""
from __future__ import annotations

import collections
import math


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n


class Gauge:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0.0

    def set(self, value: float) -> None:
        self.value = value


class Histogram:
    """Bounded reservoir of the most recent ``maxlen`` observations."""
    __slots__ = ("_values",)

    DEFAULT_MAXLEN = 4096

    def __init__(self, maxlen: int = DEFAULT_MAXLEN):
        self._values: collections.deque[float] = collections.deque(maxlen=maxlen)

    def observe(self, value: float) -> None:
        self._values.append(value)

    @property
    def count(self) -> int:
        return len(self._values)

    def percentile(self, p: float) -> float:
        """Nearest-rank percentile; NaN when empty."""
        if not self._values:
            return math.nan
        vals = sorted(self._values)
        rank = max(1, math.ceil((p / 100.0) * len(vals)))
        return vals[rank - 1]

    def summary(self) -> dict[str, float]:
        if not self._values:
            return {"count": 0, "p50": math.nan, "p99": math.nan,
                    "mean": math.nan, "max": math.nan}
        vals = list(self._values)
        return {
            "count": len(vals),
            "p50": self.percentile(50),
            "p99": self.percentile(99),
            "mean": sum(vals) / len(vals),
            "max": max(vals),
        }


class Metrics:
    """Get-or-create registry.  Names are flat strings — the serving
    engines use a ``serving/`` prefix (see ROADMAP §Observability)."""

    def __init__(self) -> None:
        self._counters: dict[str, Counter] = {}
        self._gauges: dict[str, Gauge] = {}
        self._histograms: dict[str, Histogram] = {}

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge()
        return g

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram()
        return h

    def snapshot(self) -> dict[str, dict]:
        """JSON-able view of every instrument — traced at end of a run."""
        return {
            "counters": {n: c.value for n, c in sorted(self._counters.items())},
            "gauges": {n: g.value for n, g in sorted(self._gauges.items())},
            "histograms": {n: h.summary()
                           for n, h in sorted(self._histograms.items())},
        }
