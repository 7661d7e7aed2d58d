"""Structured tracing: spans + events over a pluggable sink.

The part of the JAX package's ``repro/obs/trace.py`` that the serving path
uses, with the same record schema, so a trace from either package reads
the same offline:

    {"type": "span"|"event", "name": str, "seq": int, "ts": float,
     "span": int|None, "parent": int|None, "dur_s": float (spans only),
     "attrs": {...}}

The process-global tracer defaults to a ``NullSink``; ``Tracer.enabled`` is
a plain attribute read, so a hot call site guards with ``if tr.enabled:``
and pays one branch.  Span records are emitted at span exit (a child's
record precedes its parent's) carrying ``ts`` (entry time) and ``dur_s``.
Event names used by the port: ``plan/dispatch`` (with ``fallback=`` when a
fused plan reroutes), ``sched/calibrate``, ``sched/choose``, ``sched/run``,
``sched/degrade``, ``sched/recover`` and ``profile/point``.
``JsonlSink`` writes one record a line; ``read_jsonl`` (here or the JAX
package's) reads them back as the same records.
"""
from __future__ import annotations

import json
import time
from typing import Any, TextIO


def _jsonable(obj: Any) -> Any:
    """Fallback encoder: numpy scalars -> python, array-likes -> lists,
    anything else -> repr."""
    try:
        return obj.item()          # numpy scalar / 0-d array or tensor
    except (ValueError, RuntimeError):   # more than one value: keep them
        try:
            return obj.tolist()
        except Exception:
            return repr(obj)
    except AttributeError:
        return repr(obj)


class NullSink:
    """The default: tracing off."""
    enabled = False

    def emit(self, record: dict) -> None:  # pragma: no cover - guarded off
        pass

    def close(self) -> None:
        pass


class ListSink:
    """In-memory sink for tests and smoke runs."""
    enabled = True

    def __init__(self) -> None:
        self.records: list[dict] = []

    def emit(self, record: dict) -> None:
        self.records.append(record)

    def close(self) -> None:
        pass


class JsonlSink:
    """One JSON object per line, append-as-you-go (a crash keeps the
    prefix).  Non-finite floats are written as ``null`` so the file stays
    parseable by strict readers."""
    enabled = True

    def __init__(self, path: str):
        self.path = str(path)
        self._fh: TextIO = open(self.path, "w", encoding="utf-8")

    def emit(self, record: dict) -> None:
        self._fh.write(json.dumps(_sanitize(record), default=_jsonable))
        self._fh.write("\n")

    def close(self) -> None:
        if not self._fh.closed:
            self._fh.flush()
            self._fh.close()


def _sanitize(obj: Any) -> Any:
    """Replace non-finite floats with None, recursively (strict JSON has
    no Infinity/NaN literals; plan predictions can legitimately be inf)."""
    if isinstance(obj, float):
        return obj if obj == obj and obj not in (float("inf"), float("-inf")) else None
    if isinstance(obj, dict):
        return {k: _sanitize(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_sanitize(v) for v in obj]
    return obj


def read_jsonl(path: str) -> list[dict]:
    with open(path, "r", encoding="utf-8") as fh:
        return [json.loads(line) for line in fh if line.strip()]


class _NullSpan:
    """Shared no-op context manager returned when tracing is off."""
    __slots__ = ()

    def __enter__(self) -> "_NullSpan":
        return self

    def __exit__(self, *exc) -> bool:
        return False

    def set(self, **attrs) -> None:
        pass


NULL_SPAN = _NullSpan()


class Span:
    """Emitted as ONE record at exit; ``set`` adds attrs mid-flight."""
    __slots__ = ("_tracer", "name", "attrs", "span_id", "parent_id", "_t0")

    def __init__(self, tracer: "Tracer", name: str, attrs: dict):
        self._tracer = tracer
        self.name = name
        self.attrs = attrs
        self.span_id = tracer._new_id()
        self.parent_id: int | None = None
        self._t0 = 0.0

    def set(self, **attrs) -> None:
        self.attrs.update(attrs)

    def __enter__(self) -> "Span":
        tr = self._tracer
        self.parent_id = tr._stack[-1] if tr._stack else None
        tr._stack.append(self.span_id)
        self._t0 = tr.clock()
        return self

    def __exit__(self, *exc) -> bool:
        tr = self._tracer
        dur = tr.clock() - self._t0
        if tr._stack and tr._stack[-1] == self.span_id:
            tr._stack.pop()
        tr._emit({
            "type": "span", "name": self.name, "span": self.span_id,
            "parent": self.parent_id, "ts": self._t0, "dur_s": dur,
            "attrs": self.attrs,
        })
        return False


class Tracer:
    """Span/event frontend over a sink.  ``Tracer()`` is disabled (NullSink)."""

    def __init__(self, sink=None):
        self.sink = sink if sink is not None else NullSink()
        self.enabled: bool = self.sink.enabled
        self.clock = time.perf_counter
        self._seq = 0
        self._next = 0
        self._stack: list[int] = []

    def _new_id(self) -> int:
        self._next += 1
        return self._next

    def _emit(self, record: dict) -> None:
        record["seq"] = self._seq
        self._seq += 1
        self.sink.emit(record)

    def event(self, name: str, **attrs) -> None:
        """Point-in-time record, parented to the innermost open span."""
        if not self.enabled:
            return
        self._emit({
            "type": "event", "name": name, "span": None,
            "parent": self._stack[-1] if self._stack else None,
            "ts": self.clock(), "attrs": attrs,
        })

    def span(self, name: str, **attrs):
        """Context manager; a shared no-op when disabled."""
        if not self.enabled:
            return NULL_SPAN
        return Span(self, name, attrs)

    def close(self) -> None:
        self.sink.close()
        self.enabled = False
        self.sink = NullSink()


#: process-global tracer; NullSink by default so instrumented hot paths
#: pay one ``enabled`` branch until someone calls configure()/set_tracer()
_GLOBAL = Tracer()


def get_tracer() -> Tracer:
    return _GLOBAL


def set_tracer(tracer: Tracer) -> Tracer:
    """Install ``tracer`` globally; returns the previous one (so callers
    can restore it)."""
    global _GLOBAL
    old = _GLOBAL
    _GLOBAL = tracer
    return old


def configure(path: str | None = None, sink=None) -> Tracer:
    """Install a global tracer: JSONL to ``path``, an explicit ``sink``,
    or (neither) the disabled default."""
    if path is not None and sink is not None:
        raise ValueError("pass path or sink, not both")
    if path is not None:
        sink = JsonlSink(path)
    tracer = Tracer(sink)
    set_tracer(tracer)
    return tracer
