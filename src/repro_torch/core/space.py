"""Configuration search space: the columnar plane.

The space is a flat, named collection of knobs. Four knob kinds are
supported (float / int / categorical / bool), with optional log scaling for
numeric knobs. Every knob can additionally carry a *restriction*: for
numeric knobs a union of closed intervals (the output of the density-based
range compression, paper Eq. 5), and for categorical/bool knobs a subset of
the choices (paper Eq. 6). Sampling, unit-cube encoding and neighbourhood
mutation all respect the active restriction.

Encoding: each knob maps to one dimension in [0, 1]. Numeric knobs are
affinely mapped (in log space when ``log=True``); categorical knobs map to
the bin midpoint of the chosen category. This single encoding is shared by
the surrogates, the Shapley attribution, the KDE compression and LHS so
that all components observe a consistent geometry.

Plane / compile model
---------------------
All whole-pool operations run through a :class:`SpacePlane`, a
struct-of-arrays compile of the space: per-knob transform tables (log-affine
``(t_lo, t_span)`` parameters, restriction CDFs as normalized
cumulative-length arrays, category index tables) built once per
``(space, sampling geometry)`` and cached on the space. ``sample`` /
``lhs_sample`` / ``mutate_many`` / ``encode_many`` / ``decode_many`` /
``project_many`` draw U(0,1) matrices once and push whole knob *columns*
through the tables — a handful of vector ops per knob instead of a
per-config, per-knob Python loop. Results are wrapped in a lazy
:class:`ConfigBatch` (canonical value matrix + cached unit encoding) so the
generator/acquisition path never round-trips through Config dicts; dicts
are materialized only at the evaluation boundary.

Host draws
----------
Carried from the reference as numpy: every draw is the reference's
``numpy.random.Generator`` call, so a fixed seed gives the reference's
pools. Log knobs sample uniformly in log space (the reference's columnar
default geometry). The reference's per-element ``"scalar"`` space backend
and its geometry override are not carried. ``ConfigBatch.unit_tensor``
uploads a pool's unit matrix to a device once.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Any, Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs as _obs

__all__ = [
    "Knob",
    "FloatKnob",
    "IntKnob",
    "CatKnob",
    "BoolKnob",
    "ConfigSpace",
    "ConfigBatch",
    "SpacePlane",
    "Intervals",
]


Interval = Tuple[float, float]


# ---------------------------------------------------------------------------
# Intervals
# ---------------------------------------------------------------------------


class Intervals:
    """A normalized union of closed intervals on the real line."""

    def __init__(self, intervals: Sequence[Interval]):
        self.intervals: List[Interval] = self._normalize(intervals)

    @staticmethod
    def _normalize(intervals: Sequence[Interval]) -> List[Interval]:
        ivs = sorted((float(a), float(b)) for a, b in intervals if b >= a)
        merged: List[Interval] = []
        for a, b in ivs:
            if merged and a <= merged[-1][1]:
                merged[-1] = (merged[-1][0], max(merged[-1][1], b))
            else:
                merged.append((a, b))
        return merged

    def __bool__(self) -> bool:
        return bool(self.intervals)

    def __iter__(self):
        return iter(self.intervals)

    def __repr__(self) -> str:
        return f"Intervals({self.intervals!r})"

    @property
    def total_length(self) -> float:
        return sum(b - a for a, b in self.intervals)

    @property
    def lo(self) -> float:
        return self.intervals[0][0]

    @property
    def hi(self) -> float:
        return self.intervals[-1][1]

    def contains(self, x: float) -> bool:
        return any(a - 1e-12 <= x <= b + 1e-12 for a, b in self.intervals)

    def clip(self, x: float) -> float:
        """Project x onto the nearest point of the union."""
        if self.contains(x):
            return x
        best, bd = x, math.inf
        for a, b in self.intervals:
            for edge in (a, b):
                d = abs(x - edge)
                if d < bd:
                    best, bd = edge, d
        return best

    # Legacy raw-unit sampling helpers. The batched paths go through
    # SpacePlane's CDF tables instead; these remain for direct callers and
    # as the historical reference for the raw-unit geometry.
    def sample(self, rng: np.random.Generator, n: int = 1) -> np.ndarray:
        """Uniform samples over the union (length-weighted across pieces)."""
        lengths = np.array([b - a for a, b in self.intervals], dtype=float)
        if lengths.sum() <= 0:
            # degenerate (point) intervals: pick midpoints uniformly
            pts = np.array([(a + b) / 2 for a, b in self.intervals])
            return rng.choice(pts, size=n)
        probs = lengths / lengths.sum()
        idx = rng.choice(len(self.intervals), size=n, p=probs)
        u = rng.random(n)
        out = np.empty(n)
        for i, (a, b) in enumerate(self.intervals):
            sel = idx == i
            out[sel] = a + u[sel] * (b - a)
        return out

    def quantile_map(self, u: np.ndarray) -> np.ndarray:
        """Map u in [0,1] onto the union, proportionally by length."""
        lengths = np.array([b - a for a, b in self.intervals], dtype=float)
        tot = lengths.sum()
        if tot <= 0:
            pts = np.array([(a + b) / 2 for a, b in self.intervals])
            return pts[np.minimum((u * len(pts)).astype(int), len(pts) - 1)]
        cum = np.concatenate([[0.0], np.cumsum(lengths)]) / tot
        out = np.empty_like(u, dtype=float)
        for i, (a, b) in enumerate(self.intervals):
            sel = (u >= cum[i]) & (u <= cum[i + 1] if i == len(self.intervals) - 1 else u < cum[i + 1])
            if lengths[i] > 0:
                out[sel] = a + (u[sel] - cum[i]) / (cum[i + 1] - cum[i]) * (b - a)
            else:
                out[sel] = a
        return out


def _active_intervals(restriction: Optional[Intervals], lo: float, hi: float) -> Intervals:
    """Restriction clipped to [lo, hi]; the full range when empty/absent.

    Shared by FloatKnob and IntKnob (previously copy-pasted in both).
    """
    if restriction is not None and restriction:
        clipped = [
            (max(a, lo), min(b, hi))
            for a, b in restriction
            if min(b, hi) >= max(a, lo)
        ]
        if clipped:
            return Intervals(clipped)
    return Intervals([(float(lo), float(hi))])


# ---------------------------------------------------------------------------
# Knobs
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class Knob:
    name: str

    @property
    def kind(self) -> str:
        raise NotImplementedError

    def default_value(self) -> Any:
        raise NotImplementedError


@dataclass(frozen=True)
class FloatKnob(Knob):
    lo: float
    hi: float
    log: bool = False
    default: Optional[float] = None
    restriction: Optional[Intervals] = None  # in raw (untransformed) units

    @property
    def kind(self) -> str:
        return "float"

    def default_value(self) -> float:
        return self.default if self.default is not None else (self.lo + self.hi) / 2

    def _t(self, x: np.ndarray | float) -> np.ndarray | float:
        return np.log(x) if self.log else x

    def _it(self, t: np.ndarray | float) -> np.ndarray | float:
        return np.exp(t) if self.log else t

    def to_unit(self, x: np.ndarray | float) -> np.ndarray | float:
        a, b = self._t(self.lo), self._t(self.hi)
        return (self._t(x) - a) / (b - a)

    def from_unit(self, u: np.ndarray | float) -> np.ndarray | float:
        a, b = self._t(self.lo), self._t(self.hi)
        return self._it(a + np.clip(u, 0.0, 1.0) * (b - a))

    def active_intervals(self) -> Intervals:
        return _active_intervals(self.restriction, self.lo, self.hi)


@dataclass(frozen=True)
class IntKnob(Knob):
    lo: int
    hi: int
    log: bool = False
    default: Optional[int] = None
    restriction: Optional[Intervals] = None

    @property
    def kind(self) -> str:
        return "int"

    def default_value(self) -> int:
        return self.default if self.default is not None else (self.lo + self.hi) // 2

    def _t(self, x):
        return np.log(x) if self.log else x

    def _it(self, t):
        return np.exp(t) if self.log else t

    def to_unit(self, x):
        a, b = self._t(self.lo), self._t(self.hi)
        if b == a:
            return np.zeros_like(np.asarray(x, dtype=float))
        return (self._t(x) - a) / (b - a)

    def from_unit(self, u):
        a, b = self._t(self.lo), self._t(self.hi)
        val = self._it(a + np.clip(u, 0.0, 1.0) * (b - a))
        return np.clip(np.rint(val), self.lo, self.hi).astype(int)

    def active_intervals(self) -> Intervals:
        return _active_intervals(self.restriction, self.lo, self.hi)


@dataclass(frozen=True)
class CatKnob(Knob):
    choices: Tuple[Any, ...]
    default: Optional[Any] = None
    restriction: Optional[Tuple[Any, ...]] = None

    @property
    def kind(self) -> str:
        return "cat"

    def default_value(self) -> Any:
        return self.default if self.default is not None else self.choices[0]

    def active_choices(self) -> Tuple[Any, ...]:
        if self.restriction:
            kept = tuple(c for c in self.choices if c in self.restriction)
            if kept:
                return kept
        return self.choices

    def to_unit(self, x) -> float:
        i = self.choices.index(x)
        return (i + 0.5) / len(self.choices)

    def from_unit(self, u) -> Any:
        i = min(int(np.clip(u, 0.0, 1.0 - 1e-9) * len(self.choices)), len(self.choices) - 1)
        return self.choices[i]


@dataclass(frozen=True)
class BoolKnob(Knob):
    default: bool = False
    restriction: Optional[Tuple[bool, ...]] = None

    @property
    def kind(self) -> str:
        return "bool"

    def default_value(self) -> bool:
        return self.default

    def active_choices(self) -> Tuple[bool, ...]:
        if self.restriction:
            return self.restriction
        return (False, True)

    def to_unit(self, x) -> float:
        return 0.75 if x else 0.25

    def from_unit(self, u) -> bool:
        return bool(u >= 0.5)


Config = Dict[str, Any]

_KIND_FLOAT, _KIND_INT, _KIND_CAT, _KIND_BOOL = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# SpacePlane: struct-of-arrays compile of a ConfigSpace
# ---------------------------------------------------------------------------


@dataclass
class _NumTable:
    """Per-numeric-knob restriction tables (one geometry)."""

    ga: np.ndarray        # piece lower bounds, sampling geometry
    gb: np.ndarray        # piece upper bounds, sampling geometry
    cum: np.ndarray       # (P+1,) normalized cumulative lengths (the CDF)
    raw_a: np.ndarray     # piece lower bounds, raw units (projection)
    raw_b: np.ndarray     # piece upper bounds, raw units
    edges: np.ndarray     # interleaved (a0, b0, a1, b1, ...) raw edges
    mid: np.ndarray       # raw piece midpoints (degenerate-union fallback)
    degenerate: bool      # True when the union has zero total length
    transformed: bool     # True when ga/gb live in log space


@dataclass
class _CatTable:
    """Per-categorical-knob active-choice index table."""

    n: int                # total number of choices (encoding bins)
    act: np.ndarray       # active choice indices into the full choice tuple
    act_set: frozenset    # same, as a set (projection membership)


class SpacePlane:
    """Columnar compile of a :class:`ConfigSpace` (see module docstring).

    One instance per (space, log-sampling geometry); built lazily by
    ``ConfigSpace.plane()`` and cached on the space — knobs are frozen
    dataclasses and the knob list never mutates after construction, so the
    compile stays valid for the space's lifetime.

    Canonical value matrix convention (``values`` of :class:`ConfigBatch`):
    float64, one column per knob — numeric knobs store the raw value (ints
    exactly representable), categorical knobs the index into the *full*
    choice tuple, bool knobs 0.0/1.0.
    """

    def __init__(self, space: "ConfigSpace", log_sampling_: bool):
        self.space = space
        self.log_sampling = bool(log_sampling_)
        knobs = space.knobs
        D = len(knobs)
        self.kind = np.empty(D, dtype=np.int8)
        self.is_log = np.zeros(D, dtype=bool)
        self.lo = np.zeros(D)
        self.hi = np.zeros(D)
        self.t_lo = np.zeros(D)
        self.t_span = np.ones(D)
        self.zero_span = np.zeros(D, dtype=bool)
        self.n_choices = np.zeros(D, dtype=np.int64)
        self.num_tables: List[Optional[_NumTable]] = [None] * D
        self.cat_tables: List[Optional[_CatTable]] = [None] * D
        default_row = np.zeros(D)
        for j, k in enumerate(knobs):
            if isinstance(k, (FloatKnob, IntKnob)):
                self.kind[j] = _KIND_INT if isinstance(k, IntKnob) else _KIND_FLOAT
                self.is_log[j] = bool(k.log)
                self.lo[j], self.hi[j] = float(k.lo), float(k.hi)
                a, b = k._t(float(k.lo)), k._t(float(k.hi))
                self.t_lo[j] = a
                self.t_span[j] = b - a
                self.zero_span[j] = b == a
                iv = k.active_intervals()
                raw_a = np.array([p[0] for p in iv], dtype=float)
                raw_b = np.array([p[1] for p in iv], dtype=float)
                transformed = self.log_sampling and bool(k.log)
                ga = np.log(raw_a) if transformed else raw_a
                gb = np.log(raw_b) if transformed else raw_b
                lengths = gb - ga
                tot = lengths.sum()
                if tot > 0:
                    cum = np.concatenate([[0.0], np.cumsum(lengths) / tot])
                    degenerate = False
                else:
                    cum = np.linspace(0.0, 1.0, len(raw_a) + 1)
                    degenerate = True
                self.num_tables[j] = _NumTable(
                    ga=ga, gb=gb, cum=cum, raw_a=raw_a, raw_b=raw_b,
                    edges=np.stack([raw_a, raw_b], axis=1).reshape(-1),
                    mid=(raw_a + raw_b) / 2, degenerate=degenerate,
                    transformed=transformed,
                )
                default_row[j] = float(k.default_value())
            elif isinstance(k, CatKnob):
                self.kind[j] = _KIND_CAT
                n = len(k.choices)
                self.n_choices[j] = n
                act = np.array([k.choices.index(c) for c in k.active_choices()], dtype=np.int64)
                self.cat_tables[j] = _CatTable(n=n, act=act, act_set=frozenset(int(i) for i in act))
                default_row[j] = float(k.choices.index(k.default_value()))
            elif isinstance(k, BoolKnob):
                self.kind[j] = _KIND_BOOL
                self.n_choices[j] = 2
                act = np.array([1 if c else 0 for c in k.active_choices()], dtype=np.int64)
                self.cat_tables[j] = _CatTable(n=2, act=act, act_set=frozenset(int(i) for i in act))
                default_row[j] = 1.0 if k.default_value() else 0.0
            else:
                raise TypeError(k)
        self.default_row = default_row

    # ----------------------------------------------------------- column ops
    def _to_unit_col(self, j: int, v: np.ndarray) -> np.ndarray:
        """Raw values -> affine unit coordinate (no clipping)."""
        kj = self.kind[j]
        if kj in (_KIND_FLOAT, _KIND_INT):
            if self.zero_span[j]:
                return np.zeros_like(v)
            t = np.log(v) if self.is_log[j] else v
            return (t - self.t_lo[j]) / self.t_span[j]
        if kj == _KIND_CAT:
            return (v + 0.5) / self.n_choices[j]
        return np.where(v != 0, 0.75, 0.25)

    def _from_unit_col(self, j: int, u: np.ndarray) -> np.ndarray:
        """Unit coordinate -> raw canonical value (legacy from_unit)."""
        kj = self.kind[j]
        if kj in (_KIND_FLOAT, _KIND_INT):
            t = self.t_lo[j] + np.clip(u, 0.0, 1.0) * self.t_span[j]
            v = np.exp(t) if self.is_log[j] else t
            if kj == _KIND_INT:
                v = np.clip(np.rint(v), self.lo[j], self.hi[j])
            return v
        if kj == _KIND_CAT:
            n = self.n_choices[j]
            return np.minimum(
                (np.clip(u, 0.0, 1.0 - 1e-9) * n).astype(np.int64), n - 1
            ).astype(float)
        return (u >= 0.5).astype(float)

    def _quantile_col(self, j: int, u: np.ndarray) -> np.ndarray:
        """Unit draw -> raw value, uniform over the active restriction
        (in the plane's sampling geometry for log knobs)."""
        kj = self.kind[j]
        if kj in (_KIND_FLOAT, _KIND_INT):
            tab = self.num_tables[j]
            P = len(tab.ga)
            if tab.degenerate:
                v = tab.mid[np.minimum((u * P).astype(np.int64), P - 1)]
            else:
                i = np.clip(np.searchsorted(tab.cum, u, side="right") - 1, 0, P - 1)
                span = tab.cum[i + 1] - tab.cum[i]
                frac = np.where(span > 0, (u - tab.cum[i]) / np.where(span > 0, span, 1.0), 0.0)
                g = tab.ga[i] + frac * (tab.gb[i] - tab.ga[i])
                v = np.exp(g) if tab.transformed else g
            if kj == _KIND_INT:
                v = np.clip(np.rint(v), self.lo[j], self.hi[j])
            return v
        tab = self.cat_tables[j]
        m = len(tab.act)
        pick = np.minimum((u * m).astype(np.int64), m - 1)
        return tab.act[pick].astype(float)

    def _project_col(self, j: int, v: np.ndarray) -> np.ndarray:
        """Clip a value column into the active restriction (raw units)."""
        kj = self.kind[j]
        if kj in (_KIND_FLOAT, _KIND_INT):
            v = self._iv_clip_col(j, v)
            if kj == _KIND_INT:
                v = np.rint(v)
            return np.clip(v, self.lo[j], self.hi[j])
        tab = self.cat_tables[j]
        ok = np.isin(v.astype(np.int64), tab.act)
        return np.where(ok, v, float(tab.act[0]))

    def _iv_clip_col(self, j: int, v: np.ndarray) -> np.ndarray:
        """Nearest-point projection onto the raw union (no bound clip) —
        the columnar Intervals.clip shared by projection and mutation.
        argmin keeps the first minimum, matching the scalar strict-< scan
        over pieces in order."""
        tab = self.num_tables[j]
        inside = np.zeros(v.shape, dtype=bool)
        for a, b in zip(tab.raw_a, tab.raw_b):
            inside |= (a - 1e-12 <= v) & (v <= b + 1e-12)
        if inside.all():
            return v
        nearest = tab.edges[np.argmin(np.abs(v[:, None] - tab.edges[None, :]), axis=1)]
        return np.where(inside, v, nearest)

    # ----------------------------------------------------------- device pool
    def device_tables(self) -> Tuple[tuple, tuple]:
        """Static per-knob signature + arrays for the on-device sampler.

        Returns ``(sig, cols)``: ``sig`` is a hashable tuple of per-knob
        ``(kind, is_log, transformed, degenerate, zero_span, size)`` tuples
        (a jit static argument for the fused propose step), ``cols`` the
        matching tuple of per-knob numpy array tuples — numeric knobs get
        ``(ga, gb, cum, mid, scal)`` with ``scal = [t_lo, t_span, lo, hi]``
        (the restriction-CDF tables plus the log-affine unit transform),
        categorical/bool knobs ``(act,)`` with the choice count carried in
        the signature. The fused propose step uploads these once and
        replays ``_quantile_col`` + clipped ``_to_unit_col`` per column on
        device.
        """
        sig, cols = [], []
        for j in range(len(self.space.knobs)):
            kj = int(self.kind[j])
            if kj in (_KIND_FLOAT, _KIND_INT):
                tab = self.num_tables[j]
                sig.append((kj, bool(self.is_log[j]), bool(tab.transformed),
                            bool(tab.degenerate), bool(self.zero_span[j]),
                            len(tab.ga)))
                scal = np.array([self.t_lo[j], self.t_span[j],
                                 self.lo[j], self.hi[j]])
                cols.append((tab.ga, tab.gb, tab.cum, tab.mid, scal))
            else:
                tab = self.cat_tables[j]
                sig.append((kj, False, False, False, False,
                            int(self.n_choices[j])))
                cols.append((tab.act,))
        return tuple(sig), tuple(cols)

    # ------------------------------------------------------------ matrix ops
    def encode_values(self, V: np.ndarray) -> np.ndarray:
        U = np.empty_like(V)
        for j in range(V.shape[1]):
            U[:, j] = np.clip(self._to_unit_col(j, V[:, j]), 0.0, 1.0)
        return U

    def decode_units(self, U: np.ndarray) -> np.ndarray:
        """Unit rows -> canonical values, restriction-aware: ``from_unit``
        followed by projection onto the active restriction (the legacy
        ``decode`` silently bypassed restrictions; ``decode``/``decode_many``
        now route here)."""
        V = np.empty_like(U)
        for j in range(U.shape[1]):
            V[:, j] = self._project_col(j, self._from_unit_col(j, U[:, j]))
        return V

    def sample_values(self, U: np.ndarray) -> np.ndarray:
        V = np.empty_like(U)
        for j in range(U.shape[1]):
            V[:, j] = self._quantile_col(j, U[:, j])
        return V

    def mutate_values(
        self, V: np.ndarray, G: np.ndarray, Z: np.ndarray, C: np.ndarray,
        scale: float, p: float,
    ) -> np.ndarray:
        out = V.copy()
        for j in range(V.shape[1]):
            mut = G[:, j] <= p
            if not mut.any():
                continue
            if self.kind[j] in (_KIND_FLOAT, _KIND_INT):
                u = np.clip(self._to_unit_col(j, V[:, j]), 0.0, 1.0)
                u = np.clip(u + scale * Z[:, j], 0.0, 1.0)
                w = self._from_unit_col(j, u)
                w = self._iv_clip_col(j, w)
                if self.kind[j] == _KIND_INT:
                    w = np.clip(np.rint(w), self.lo[j], self.hi[j])
                out[:, j] = np.where(mut, w, V[:, j])
            else:
                out[:, j] = np.where(mut, self._quantile_col(j, C[:, j]), V[:, j])
        return out

    def project_values(self, V: np.ndarray) -> np.ndarray:
        out = np.empty_like(V)
        for j in range(V.shape[1]):
            out[:, j] = self._project_col(j, V[:, j])
        return out

    # --------------------------------------------------------- dict boundary
    def gather(self, cfgs: Sequence[Config]) -> np.ndarray:
        """Config dicts -> canonical value matrix (missing knobs -> default)."""
        knobs = self.space.knobs
        V = np.empty((len(cfgs), len(knobs)))
        for j, k in enumerate(knobs):
            name = k.name
            if self.kind[j] == _KIND_CAT:
                idx = k.choices.index
                dv = float(idx(k.default_value()))
                V[:, j] = [float(idx(c[name])) if name in c else dv for c in cfgs]
            elif self.kind[j] == _KIND_BOOL:
                dv = 1.0 if k.default_value() else 0.0
                V[:, j] = [(1.0 if c[name] else 0.0) if name in c else dv for c in cfgs]
            else:
                dv = float(k.default_value())
                V[:, j] = [float(c.get(name, dv)) for c in cfgs]
        return V

    def materialize_row(self, row: np.ndarray) -> Config:
        """One canonical value row -> Config dict with native value types."""
        out: Config = {}
        for j, k in enumerate(self.space.knobs):
            kj = self.kind[j]
            if kj == _KIND_FLOAT:
                out[k.name] = float(row[j])
            elif kj == _KIND_INT:
                out[k.name] = int(row[j])
            elif kj == _KIND_CAT:
                out[k.name] = k.choices[int(row[j])]
            else:
                out[k.name] = bool(row[j] != 0)
        return out


class ConfigBatch(Sequence):
    """A pool of configurations as a canonical value matrix.

    Behaves as a ``Sequence[Config]`` — indexing/iteration materialize dicts
    one row at a time — while the generator/acquisition path reads
    ``values`` (canonical matrix) and ``unit()`` (cached unit-cube encoding)
    without ever building dicts.
    """

    __slots__ = ("space", "values", "_unit")

    def __init__(self, space: "ConfigSpace", values: np.ndarray):
        self.space = space
        self.values = np.ascontiguousarray(np.atleast_2d(np.asarray(values, dtype=float)))
        if self.values.size == 0:
            self.values = self.values.reshape(0, space.dim)
        if self.values.shape[1] != space.dim:
            raise ValueError(f"value matrix has {self.values.shape[1]} columns, space has {space.dim}")
        self._unit: Optional[np.ndarray] = None

    @classmethod
    def from_configs(cls, space: "ConfigSpace", cfgs: Sequence[Config]) -> "ConfigBatch":
        if isinstance(cfgs, ConfigBatch):
            if cfgs.space is space:
                return cfgs
            return cls(space, space.plane().gather(list(cfgs)))
        return cls(space, space.plane().gather(cfgs))

    # ------------------------------------------------------------- sequence
    def __len__(self) -> int:
        return self.values.shape[0]

    def __getitem__(self, i):
        if isinstance(i, slice):
            return self.take(range(*i.indices(len(self))))
        return self.space.plane().materialize_row(self.values[i])

    def __iter__(self) -> Iterator[Config]:
        plane = self.space.plane()
        for i in range(len(self)):
            yield plane.materialize_row(self.values[i])

    # -------------------------------------------------------------- columnar
    def unit(self) -> np.ndarray:
        """Unit-cube encoding of the whole pool (cached)."""
        if self._unit is None:
            self._unit = self.space._encode_values(self.values)
        return self._unit

    def unit_tensor(self, device) -> torch.Tensor:
        """The pool's unit matrix as a float64 (n, dim) tensor on ``device``
        (one upload of the host draws)."""
        return torch.from_numpy(np.ascontiguousarray(self.unit(), dtype=np.float64)).to(device)

    def take(self, idx) -> "ConfigBatch":
        idx = np.asarray(idx)
        if idx.dtype == bool:
            idx = np.flatnonzero(idx)
        idx = idx.astype(np.int64)
        out = ConfigBatch(self.space, self.values[idx])
        if self._unit is not None:
            out._unit = self._unit[idx]
        return out

    def row_keys(self) -> List[bytes]:
        """Exact-match dedup keys (canonical rows as bytes)."""
        return [self.values[i].tobytes() for i in range(len(self))]

    def materialize(self) -> List[Config]:
        return list(self)

    @staticmethod
    def concat(batches: Sequence["ConfigBatch"]) -> "ConfigBatch":
        if not batches:
            raise ValueError("no batches to concat")
        space = batches[0].space
        return ConfigBatch(space, np.concatenate([b.values for b in batches], axis=0))


# ---------------------------------------------------------------------------
# ConfigSpace
# ---------------------------------------------------------------------------


class ConfigSpace:
    """Ordered collection of knobs with encode/decode/sample/mutate.

    Batched entry points (``sample`` / ``lhs_sample`` / ``mutate_many`` /
    ``encode_many`` / ``decode_many`` / ``project_many``) run through the
    columnar :class:`SpacePlane` and share one unit-draw protocol: uniforms
    are drawn as whole (n, dim) matrices up front, as in the reference.
    """

    def __init__(self, knobs: Sequence[Knob]):
        names = [k.name for k in knobs]
        if len(set(names)) != len(names):
            raise ValueError("duplicate knob names")
        self.knobs: List[Knob] = list(knobs)
        self.by_name: Dict[str, Knob] = {k.name: k for k in knobs}
        self._planes: Dict[bool, SpacePlane] = {}

    # ------------------------------------------------------------------ basics
    @property
    def names(self) -> List[str]:
        return [k.name for k in self.knobs]

    @property
    def dim(self) -> int:
        return len(self.knobs)

    def __contains__(self, name: str) -> bool:
        return name in self.by_name

    def __len__(self) -> int:
        return len(self.knobs)

    def default(self) -> Config:
        return {k.name: k.default_value() for k in self.knobs}

    def plane(self) -> SpacePlane:
        """The compiled plane (log knobs sampled in log space)."""
        plane = self._planes.get(True)
        if plane is None:
            plane = SpacePlane(self, True)
            self._planes[True] = plane
        return plane

    # ------------------------------------------------------------- en/decoding
    def encode(self, cfg: Config) -> np.ndarray:
        """Config dict -> unit-cube vector (missing knobs -> default)."""
        out = np.empty(self.dim, dtype=float)
        for i, k in enumerate(self.knobs):
            v = cfg.get(k.name, k.default_value())
            out[i] = float(np.clip(k.to_unit(v), 0.0, 1.0))
        return out

    def _encode_values(self, V: np.ndarray) -> np.ndarray:
        return self.plane().encode_values(V)

    def encode_many(self, cfgs: Sequence[Config]) -> np.ndarray:
        if isinstance(cfgs, ConfigBatch) and cfgs.space is self:
            return cfgs.unit()
        if len(cfgs) == 0:
            return np.zeros((0, self.dim))
        return self.plane().encode_values(self.plane().gather(list(cfgs)))

    def decode(self, u: np.ndarray) -> Config:
        """Unit vector -> config, projected onto the active restriction.

        (The legacy decode used raw ``from_unit`` and could return values in
        a region excluded by the restriction; decode now projects.)
        """
        return self.decode_many(np.atleast_2d(np.asarray(u, dtype=float)))[0]

    def decode_many(self, U: np.ndarray) -> ConfigBatch:
        U = np.atleast_2d(np.asarray(U, dtype=float))
        return ConfigBatch(self, self.plane().decode_units(U))

    # ---------------------------------------------------------------- sampling
    def sample(self, rng: np.random.Generator, n: int = 1) -> ConfigBatch:
        """n uniform samples over the active (restricted) space.

        Draws one (n, dim) U(0,1) matrix and maps each knob column through
        its restriction CDF table (log knobs in log space).
        """
        with _obs.span("space_sample", kind="uniform", n=n, dim=self.dim):
            U = rng.random((n, self.dim))
            return self._map_unit_draws(U)

    def lhs_sample(self, rng: np.random.Generator, n: int) -> ConfigBatch:
        """Latin Hypercube Sampling (McKay et al.), restriction-aware.

        Keeps the legacy per-knob draw order: for each knob (in order) a
        stratified column ``(perm(n) + U(n)) / n``.
        """
        if n <= 0:
            return ConfigBatch(self, np.zeros((0, self.dim)))
        with _obs.span("space_sample", kind="lhs", n=n, dim=self.dim):
            U = np.empty((n, self.dim))
            for j in range(self.dim):
                U[:, j] = (rng.permutation(n) + rng.random(n)) / n
            return self._map_unit_draws(U)

    def _map_unit_draws(self, U: np.ndarray) -> ConfigBatch:
        return ConfigBatch(self, self.plane().sample_values(U))

    # ---------------------------------------------------------------- mutation
    def mutate_many(
        self,
        cfgs: Sequence[Config],
        rng: np.random.Generator,
        scale: float = 0.2,
        p: float = 0.3,
    ) -> ConfigBatch:
        """Gaussian-in-unit-space perturbation of a random knob subset,
        vectorized over the whole batch.

        Draw protocol: a (n, dim) uniform gate
        matrix, a (n, dim) standard-normal step matrix, and a (n, dim)
        uniform resample matrix for categorical/bool knobs.
        """
        with _obs.span("space_sample", kind="mutate", n=len(cfgs), dim=self.dim):
            batch = ConfigBatch.from_configs(self, cfgs)
            n = len(batch)
            G = rng.random((n, self.dim))
            Z = rng.standard_normal((n, self.dim))
            C = rng.random((n, self.dim))
            return ConfigBatch(
                self, self.plane().mutate_values(batch.values, G, Z, C, scale, p)
            )

    def mutate(self, cfg: Config, rng: np.random.Generator, scale: float = 0.2, p: float = 0.3) -> Config:
        """Single-config convenience wrapper over :meth:`mutate_many`."""
        return self.mutate_many([cfg], rng, scale=scale, p=p)[0]

    # ------------------------------------------------------------- restriction
    def project(self, cfg: Config) -> Config:
        """Clip a config into the active (restricted) space."""
        out: Config = {}
        for k in self.knobs:
            v = cfg.get(k.name, k.default_value())
            if isinstance(k, FloatKnob):
                out[k.name] = float(np.clip(k.active_intervals().clip(float(v)), k.lo, k.hi))
            elif isinstance(k, IntKnob):
                out[k.name] = int(np.clip(np.rint(k.active_intervals().clip(float(v))), k.lo, k.hi))
            elif isinstance(k, CatKnob):
                ch = k.active_choices()
                out[k.name] = v if v in ch else ch[0]
            elif isinstance(k, BoolKnob):
                ch = k.active_choices()
                out[k.name] = bool(v) if bool(v) in ch else ch[0]
        return out

    def project_many(self, cfgs: Sequence[Config]) -> ConfigBatch:
        batch = ConfigBatch.from_configs(self, cfgs)
        return ConfigBatch(self, self.plane().project_values(batch.values))

    def restrict(
        self,
        keep: Optional[Sequence[str]] = None,
        ranges: Optional[Dict[str, Intervals]] = None,
        cat_subsets: Optional[Dict[str, Sequence[Any]]] = None,
    ) -> "ConfigSpace":
        """Return a new space with knobs dropped and/or ranges restricted.

        Dropped knobs simply disappear from the space; the tuner pins them
        to their defaults (the paper removes them from the search space).
        """
        keep_set = set(keep) if keep is not None else set(self.names)
        new_knobs: List[Knob] = []
        for k in self.knobs:
            if k.name not in keep_set:
                continue
            if isinstance(k, (FloatKnob, IntKnob)) and ranges and k.name in ranges:
                k = replace(k, restriction=ranges[k.name])
            elif isinstance(k, CatKnob) and cat_subsets and k.name in cat_subsets:
                k = replace(k, restriction=tuple(cat_subsets[k.name]))
            elif isinstance(k, BoolKnob) and cat_subsets and k.name in cat_subsets:
                k = replace(k, restriction=tuple(bool(c) for c in cat_subsets[k.name]))
            new_knobs.append(k)
        return ConfigSpace(new_knobs)

    def complete(self, cfg: Config) -> Config:
        """Fill missing knobs with defaults (used after knob-dropping)."""
        out = self.default()
        out.update({k: v for k, v in cfg.items() if k in self.by_name})
        return out

    def complete_batch(self, batch: ConfigBatch) -> ConfigBatch:
        """Lift a batch from a (possibly compressed) sub-space into this
        space: shared knobs copy their canonical columns, dropped knobs take
        this space's defaults. The canonical representation is knob-local,
        so columns transfer without re-encoding."""
        if batch.space is self:
            return batch
        plane = self.plane()
        V = np.broadcast_to(plane.default_row, (len(batch), self.dim)).copy()
        col = {name: j for j, name in enumerate(self.names)}
        for j_src, k in enumerate(batch.space.knobs):
            j_dst = col.get(k.name)
            if j_dst is None:
                continue
            # canonical columns are knob-local: numeric = raw units
            # (universal), cat = index into the knob's own choices tuple —
            # reject a shared name whose representation is incompatible
            # instead of silently materializing the wrong value
            mine = self.knobs[j_dst]
            if mine.kind != k.kind or (
                isinstance(k, CatKnob) and mine.choices != k.choices
            ):
                raise ValueError(
                    f"knob {k.name!r} has incompatible definitions across "
                    f"spaces ({mine.kind} vs {k.kind}); cannot lift batch"
                )
            V[:, j_dst] = batch.values[:, j_src]
        return ConfigBatch(self, V)
