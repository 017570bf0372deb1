"""Tracing core: nested spans over a lock-free event buffer.

Design constraints (see docs/OBSERVABILITY.md):

* **Disabled path is one branch.** Every module-level helper
  (:func:`span`, :func:`instant`, :func:`count`, :func:`gauge`,
  :func:`observe`) checks a single module global; when no tracer is
  installed they return a shared no-op singleton / fall through without
  allocating. The tuner loop is instrumented unconditionally and pays
  ~a dict-miss-free branch per call when tracing is off.
* **Lock-free buffer.** Events are appended to a plain list by the
  emitting thread — ``list.append`` is atomic under the GIL, so a
  single-process multi-threaded run needs no lock. Span *stacks* are
  per-thread (keyed by ``threading.get_ident()``) so nesting resolves
  correctly if workload evaluation ever fans out to threads.
* **No RNG, no semantics.** Instrumentation never touches random state
  or alters control flow: trajectories are bit-identical tracer-on vs
  tracer-off at a fixed seed (pinned in ``tests/test_obs.py``).

Event vocabulary (validated against ``trace_schema.json``):

``span``      closed span: name, ts, dur (seconds from tracer epoch),
              id, parent (-1 = top level), tid, args
``instant``   point event: name, ts, tid, args
``counter`` / ``gauge`` / ``histogram``
              metric snapshots emitted by :meth:`Tracer.emit_metrics`
``meta``      one per trace: epoch timestamps + tracer name
"""

from __future__ import annotations

import itertools
import threading
import time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional

from .metrics import Metrics

__all__ = [
    "Span", "Tracer", "get_tracer", "set_tracer", "tracing",
    "span", "instant", "count", "gauge", "observe",
]


class Span:
    """A span in flight. Use as a context manager; ``set(**attrs)``
    attaches result attributes discovered mid-span (cost, cache hit...)."""

    __slots__ = ("_tr", "name", "args", "id", "parent", "tid", "_t0")

    def __init__(self, tracer: "Tracer", name: str, args: Dict[str, Any]):
        self._tr = tracer
        self.name = name
        self.args = args
        self.id = next(tracer._ids)
        self.parent = -1
        self.tid = 0
        self._t0 = 0.0

    def set(self, **attrs: Any) -> "Span":
        self.args.update(attrs)
        return self

    def __enter__(self) -> "Span":
        tr = self._tr
        tid = threading.get_ident()
        self.tid = tid
        stack = tr._stacks.get(tid)
        if stack is None:
            stack = tr._stacks[tid] = []
        if stack:
            self.parent = stack[-1]
        stack.append(self.id)
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        t1 = time.perf_counter()
        tr = self._tr
        stack = tr._stacks.get(self.tid)
        if stack and stack[-1] == self.id:
            stack.pop()
        elif stack and self.id in stack:  # mis-nested exit: unwind to self
            del stack[stack.index(self.id):]
        tr._emit({
            "type": "span",
            "name": self.name,
            "ts": self._t0 - tr.epoch,
            "dur": t1 - self._t0,
            "id": self.id,
            "parent": self.parent,
            "tid": self.tid,
            "args": self.args,
        })


class _NoopSpan:
    """Shared do-nothing span returned when tracing is disabled."""

    __slots__ = ()
    id = -1
    parent = -1

    def set(self, **attrs: Any) -> "_NoopSpan":
        return self

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        return None


NOOP_SPAN = _NoopSpan()


class Tracer:
    """Collects events for one run. Cheap enough to leave on in tests;
    bounded by ``max_events`` (drops and counts overflow, never grows
    unboundedly in a service loop)."""

    def __init__(self, name: str = "run", metrics: Optional[Metrics] = None,
                 max_events: int = 1_000_000):
        self.name = name
        self.epoch = time.perf_counter()
        self.wall_epoch = time.time()
        self.events: List[Dict[str, Any]] = []
        self.metrics = metrics if metrics is not None else Metrics()
        self.max_events = max_events
        self.dropped = 0
        self._ids = itertools.count(1)
        self._stacks: Dict[int, List[int]] = {}

    # ----------------------------------------------------------------- emit
    def now(self) -> float:
        return time.perf_counter() - self.epoch

    def _emit(self, ev: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(ev)

    def span(self, name: str, **args: Any) -> Span:
        return Span(self, name, args)

    def instant(self, name: str, **args: Any) -> None:
        self._emit({
            "type": "instant",
            "name": name,
            "ts": self.now(),
            "tid": threading.get_ident(),
            "args": args,
        })

    def current_span_id(self) -> int:
        stack = self._stacks.get(threading.get_ident())
        return stack[-1] if stack else -1

    def emit_metrics(self, metrics: Optional[Metrics] = None,
                     scope: str = "global") -> None:
        """Append one event per metric in ``metrics`` (default: the
        tracer's own registry). ``scope`` distinguishes per-run registries
        from the module-global one in a multi-session export."""
        m = metrics if metrics is not None else self.metrics
        ts = self.now()
        snap = m.snapshot()
        for k, v in snap["counters"].items():
            self._emit({"type": "counter", "name": k, "ts": ts,
                        "scope": scope, "value": v})
        for k, v in snap["gauges"].items():
            self._emit({"type": "gauge", "name": k, "ts": ts,
                        "scope": scope, "value": v})
        for k, h in snap["histograms"].items():
            self._emit({"type": "histogram", "name": k, "ts": ts,
                        "scope": scope, **h})


# --------------------------------------------------------------------------
# Module-level tracer: the one-branch disabled path.
# --------------------------------------------------------------------------

_TRACER: Optional[Tracer] = None


def get_tracer() -> Optional[Tracer]:
    return _TRACER


def set_tracer(tracer: Optional[Tracer]) -> Optional[Tracer]:
    """Install ``tracer`` as the process-global tracer; returns the
    previous one so callers can restore it."""
    global _TRACER
    prev = _TRACER
    _TRACER = tracer
    return prev


@contextmanager
def tracing(tracer: Optional[Tracer] = None, name: str = "run"):
    """``with tracing() as tr: ...`` — install a tracer for the block."""
    tr = tracer if tracer is not None else Tracer(name)
    prev = set_tracer(tr)
    try:
        yield tr
    finally:
        set_tracer(prev)


def span(name: str, **args: Any):
    """Open a span on the global tracer, or a shared no-op when disabled."""
    tr = _TRACER
    if tr is None:
        return NOOP_SPAN
    return Span(tr, name, args)


def instant(name: str, **args: Any) -> None:
    tr = _TRACER
    if tr is None:
        return
    tr.instant(name, **args)


def count(name: str, n: float = 1.0) -> None:
    tr = _TRACER
    if tr is None:
        return
    tr.metrics.counter(name).add(n)


def gauge(name: str, v: float) -> None:
    tr = _TRACER
    if tr is None:
        return
    tr.metrics.gauge(name).set(v)


def observe(name: str, v: float) -> None:
    tr = _TRACER
    if tr is None:
        return
    tr.metrics.histogram(name).observe(v)
