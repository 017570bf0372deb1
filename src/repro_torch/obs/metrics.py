"""Typed metrics registry for the tuner loop.

Three metric kinds, all allocation-free on the hot path:

``Counter``
    A monotonically-growing float sum (``add``). Stage overheads, budget
    attribution and cache hit/miss tallies are counters.
``Gauge``
    A last-value-wins float (``set``). Pool-bucket occupancy, cache sizes.
``Histogram``
    Fixed *log-spaced* bin edges chosen at creation, so recording a value
    is one ``np.searchsorted`` + one integer increment — no rebinning, no
    per-observation allocation. Bin ``i`` (``1 <= i <= len(edges) - 1``)
    covers the half-open range ``[edges[i-1], edges[i])``; index ``0`` is
    the underflow bin (``v < edges[0]``) and index ``len(edges)`` the
    overflow bin (``v >= edges[-1]``).

The registry is the single sink for what used to be ad-hoc side channels
(``TuningResult.overheads`` / ``surrogate_cache`` / ``plane_cache``):
controllers record into a :class:`Metrics` instance and the legacy result
fields are materialized as *views* over it (:meth:`Metrics.counters_view`),
preserving their exact key/value shapes.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

__all__ = ["Counter", "Gauge", "Histogram", "Metrics"]

# default histogram geometry: 12 decades (1e-6 .. 1e6), 4 bins per decade
HIST_LO = 1e-6
HIST_HI = 1e6
HIST_BINS = 48


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def add(self, n: float = 1.0) -> None:
        self.value += n


class Gauge:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0.0

    def set(self, v: float) -> None:
        self.value = float(v)


class Histogram:
    """Fixed log-spaced bins; one ``searchsorted`` per observation."""

    __slots__ = ("name", "edges", "counts", "n", "total", "vmin", "vmax")

    def __init__(self, name: str, lo: float = HIST_LO, hi: float = HIST_HI,
                 bins: int = HIST_BINS):
        if not (lo > 0 and hi > lo and bins >= 1):
            raise ValueError(f"bad histogram geometry lo={lo} hi={hi} bins={bins}")
        self.name = name
        self.edges = np.logspace(np.log10(lo), np.log10(hi), bins + 1)
        self.counts = np.zeros(bins + 2, dtype=np.int64)  # +under/overflow
        self.n = 0
        self.total = 0.0
        self.vmin = float("inf")
        self.vmax = float("-inf")

    def observe(self, v: float) -> None:
        self.counts[int(np.searchsorted(self.edges, v, side="right"))] += 1
        self.n += 1
        self.total += v
        if v < self.vmin:
            self.vmin = v
        if v > self.vmax:
            self.vmax = v

    def snapshot(self) -> Dict[str, Any]:
        return {
            "edges": [float(e) for e in self.edges],
            "counts": [int(c) for c in self.counts],
            "n": int(self.n),
            "total": float(self.total),
            "min": float(self.vmin) if self.n else 0.0,
            "max": float(self.vmax) if self.n else 0.0,
        }


class Metrics:
    """Name-keyed registry of counters / gauges / histograms."""

    __slots__ = ("_counters", "_gauges", "_hists")

    def __init__(self):
        self._counters: Dict[str, Counter] = {}
        self._gauges: Dict[str, Gauge] = {}
        self._hists: Dict[str, Histogram] = {}

    # ------------------------------------------------------------- accessors
    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter(name)
        return c

    def gauge(self, name: str) -> Gauge:
        g = self._gauges.get(name)
        if g is None:
            g = self._gauges[name] = Gauge(name)
        return g

    def histogram(self, name: str, lo: float = HIST_LO, hi: float = HIST_HI,
                  bins: int = HIST_BINS) -> Histogram:
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram(name, lo, hi, bins)
        return h

    # ----------------------------------------------------------------- views
    def set_counter(self, name: str, value: float) -> None:
        self.counter(name).value = float(value)

    def absorb_counters(self, prefix: str, values: Dict[str, float]) -> None:
        """Install externally-tracked tallies (e.g. a cache's hit/miss
        counters) under ``prefix`` so exports see one vocabulary."""
        for k, v in values.items():
            self.set_counter(prefix + k, v)

    def counters_view(self, prefix: str, coerce_int: bool = True) -> Dict[str, Any]:
        """Legacy-dict view of the counters under ``prefix``: keys lose the
        prefix; with ``coerce_int`` integral values come back as ints (the
        historical shapes of ``TuningResult.surrogate_cache`` /
        ``plane_cache``; ``overheads`` keeps floats)."""
        out: Dict[str, Any] = {}
        for name, c in self._counters.items():
            if name.startswith(prefix):
                v = c.value
                if coerce_int and float(v).is_integer():
                    v = int(v)
                out[name[len(prefix):]] = v
        return out

    def names(self) -> List[str]:
        return list(self._counters) + list(self._gauges) + list(self._hists)

    def snapshot(self) -> Dict[str, Any]:
        return {
            "counters": {k: c.value for k, c in self._counters.items()},
            "gauges": {k: g.value for k, g in self._gauges.items()},
            "histograms": {k: h.snapshot() for k, h in self._hists.items()},
        }
