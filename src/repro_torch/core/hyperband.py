"""Hyperband / successive-halving scheduling (paper §3.4, Alg. 1, Table 1).

The schedule is computed exactly as in Alg. 1:
    s_max = floor(log_eta(R)),  B = (s_max + 1) * R
    for s in {s_max, ..., 0}:
        n_1 = ceil(B/R * eta^s / (s+1)),  r_1 = R * eta^{-s}
        run SH(n_1, r_1)
Inside SH, after evaluating n_i configs at resource r_i, the top
n_i/eta of the *successful* configs advance to r_{i+1} = eta * r_i until
r = R (failed evaluations occupy a rung slot but never promote and never
count toward the promotion quota).

Resources map to fidelity deltas: delta = r / R (so R=9, eta=3 gives the
paper's default proxy levels 1/9, 1/3, 1).

Evaluation is delegated to a callback so the same scheduler drives the
Spark simulator, the JAX objective and the unit tests. The §6.3 median
early-stop is applied here: an evaluation is capped at the median cost of
historical evaluations at the same fidelity (factor configurable).

Bracket bookkeeping comes in two backends (same pattern as the space /
surrogate / acquisition planes), both host numpy as in the reference
(port of ``repro.core.hyperband``):

``backend="table"`` (default) — array-native :class:`RungTable` state:
    one row per evaluation with config-index / score / failed / elapsed /
    rung-id columns, rung promotion as one masked stable top-k over the
    score column, and per-fidelity cost history in growable
    :class:`CostColumns` buffers (vectorized running medians).
    ``run_bracket`` is a thin loop over ``table.record(...)`` /
    ``table.promote(...)`` steps, and the finished tables are kept on
    ``runner.tables`` so callers (benchmarks, an async-ASHA service layer)
    can read promotion state without re-deriving it.
``backend="loop"`` — the original list-of-dataclass scalar reference.

Both backends replay the same float comparisons (Python's stable
``list.sort`` vs ``np.argsort(kind="stable")`` over float64 scores), so
survivor sets are bit-identical; NaN scores on successful rows are
rejected by the table (they would silently poison either sort order).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs

__all__ = [
    "hb_schedule",
    "sh_schedule",
    "Bracket",
    "Rung",
    "RungTable",
    "CostColumns",
    "HyperbandRunner",
    "get_hyperband_backend",
    "set_hyperband_backend",
    "hyperband_backend",
]


@dataclass
class Rung:
    n: int           # configs evaluated at this rung
    r: float         # resource units
    delta: float     # fidelity r / R


@dataclass
class Bracket:
    s: int
    rungs: List[Rung]


def sh_schedule(n1: int, r1: float, R: float, eta: int) -> List[Rung]:
    rungs = []
    n, r = n1, r1
    while True:
        rungs.append(Rung(n=max(int(n), 1), r=r, delta=min(r / R, 1.0)))
        if r >= R - 1e-9:
            break
        n = max(int(np.floor(n / eta)), 1)
        r = r * eta
    return rungs


def hb_schedule(R: float, eta: int) -> List[Bracket]:
    """Alg. 1 / Table 1 enumeration of (n_i, r_i)."""
    s_max = int(np.floor(np.log(R) / np.log(eta)))
    B = (s_max + 1) * R
    brackets = []
    for s in range(s_max, -1, -1):
        n1 = int(np.ceil(B / R * (eta**s) / (s + 1)))
        r1 = R * (eta ** (-s))
        brackets.append(Bracket(s=s, rungs=sh_schedule(n1, r1, R, eta)))
    return brackets


# ---------------------------------------------------------------------------
# backend selection (module default + context override, like the space /
# forest / acquisition planes)
# ---------------------------------------------------------------------------

_HB_BACKENDS = ("table", "loop")
_HB_BACKEND = "table"


def get_hyperband_backend() -> str:
    return _HB_BACKEND


def set_hyperband_backend(backend: str) -> str:
    """Set the module-default bracket-bookkeeping backend; returns previous."""
    global _HB_BACKEND
    if backend not in _HB_BACKENDS:
        raise ValueError(f"unknown hyperband backend {backend!r}; pick from {_HB_BACKENDS}")
    prev = _HB_BACKEND
    _HB_BACKEND = backend
    return prev


@contextmanager
def hyperband_backend(backend: str):
    prev = set_hyperband_backend(backend)
    try:
        yield
    finally:
        set_hyperband_backend(prev)


# ---------------------------------------------------------------------------
# array-native bookkeeping
# ---------------------------------------------------------------------------


class CostColumns:
    """Per-fidelity running cost buffers with vectorized medians.

    One growable float64 column per fidelity key (amortized-doubling
    appends, contiguous filled views), so the §6.3 median cost cap is one
    ``np.median`` over an existing array instead of a per-call Python-list
    conversion. Values and medians are bit-identical to the list path.
    """

    __slots__ = ("_buf", "_len")

    def __init__(self):
        self._buf: Dict[float, np.ndarray] = {}
        self._len: Dict[float, int] = {}

    def __contains__(self, key: float) -> bool:
        return key in self._buf

    def __setitem__(self, key: float, values) -> None:
        vals = np.asarray(list(values), dtype=np.float64)
        self._buf[key] = vals
        self._len[key] = vals.size

    def keys(self):
        return self._buf.keys()

    def count(self, key: float) -> int:
        return self._len.get(key, 0)

    def values(self, key: float) -> np.ndarray:
        """Contiguous filled view of one fidelity's cost column."""
        return self._buf.get(key, np.empty(0))[: self._len.get(key, 0)]

    def _room(self, key: float, extra: int) -> Tuple[np.ndarray, int]:
        n = self._len.get(key, 0)
        buf = self._buf.get(key)
        if buf is None or n + extra > buf.size:
            cap = max(8, buf.size if buf is not None else 0)
            while cap < n + extra:
                cap *= 2
            grown = np.empty(cap, dtype=np.float64)
            if n:
                grown[:n] = buf[:n]
            self._buf[key] = grown
            buf = grown
        return buf, n

    def append(self, key: float, value: float) -> None:
        buf, n = self._room(key, 1)
        buf[n] = value
        self._len[key] = n + 1

    def extend(self, key: float, values) -> None:
        vals = np.asarray(values, dtype=np.float64)
        buf, n = self._room(key, vals.size)
        buf[n : n + vals.size] = vals
        self._len[key] = n + vals.size

    def median(self, key: float) -> float:
        return float(np.median(self.values(key)))

    def capacity(self) -> int:
        """Total allocated slots across fidelity columns (growth guard)."""
        return int(sum(b.size for b in self._buf.values()))


class RungTable:
    """Array-native successive-halving state for one bracket.

    One row per evaluation, columnar: ``config_idx`` (index into the
    provisioned candidate sequence), ``score`` (performance, lower =
    better), ``failed`` mask, ``elapsed`` cost and ``rung_id``. Promotion
    is a masked stable top-k over the score column — the exact float
    comparisons of the scalar reference's ``sort(key=performance)``, so
    survivor sets are bit-identical — and the promotion quota counts only
    successful rows (top ``len(ok) // eta``).

    Columns grow by amortized doubling and are reusable via ``clear()``
    (buffers are kept), so a long-running service performs no per-bracket
    allocations once warm. ``survivors`` keeps each promotion's surviving
    config indices for introspection (benchmarks / async-ASHA promotion
    state).
    """

    __slots__ = (
        "s",
        "n_rungs",
        "configs",
        "survivors",
        "config_idx",
        "score",
        "failed",
        "elapsed",
        "rung_id",
        "trace_id",
        "_n",
    )

    def __init__(self, bracket: Bracket, configs: Sequence, capacity: Optional[int] = None):
        self.s = bracket.s
        self.n_rungs = len(bracket.rungs)
        self.configs = configs
        self.survivors: List[np.ndarray] = []
        cap = max(
            capacity if capacity is not None else sum(r.n for r in bracket.rungs), 1
        )
        self.config_idx = np.empty(cap, dtype=np.int64)
        self.score = np.empty(cap, dtype=np.float64)
        self.failed = np.empty(cap, dtype=bool)
        self.elapsed = np.empty(cap, dtype=np.float64)
        self.rung_id = np.empty(cap, dtype=np.int32)
        self.trace_id = np.empty(cap, dtype=np.int64)  # rung_eval span id (-1 = untraced)
        self._n = 0

    def __len__(self) -> int:
        return self._n

    @property
    def capacity(self) -> int:
        return self.config_idx.size

    def clear(self, configs: Optional[Sequence] = None) -> None:
        """Reset to empty, keeping the allocated column buffers."""
        self._n = 0
        self.survivors = []
        if configs is not None:
            self.configs = configs

    def _grow(self, need: int) -> None:
        cap = self.capacity
        while cap < need:
            cap *= 2
        for name in ("config_idx", "score", "failed", "elapsed", "rung_id", "trace_id"):
            old = getattr(self, name)
            grown = np.empty(cap, dtype=old.dtype)
            grown[: self._n] = old[: self._n]
            setattr(self, name, grown)

    def record(self, rung_i: int, config_idx, score, failed, elapsed,
               trace_id: int = -1) -> None:
        """Append one rung's evaluation results as columns.

        Non-finite scores on successful rows are rejected: a NaN (or inf)
        ``performance`` that is not marked ``failed`` would silently poison
        the promotion sort (and downstream best-tracking) on either
        backend — callers must coerce such results to failures first.
        """
        idx = np.asarray(config_idx, dtype=np.int64).ravel()
        sc = np.asarray(score, dtype=np.float64).ravel()
        fl = np.asarray(failed, dtype=bool).ravel()
        el = np.asarray(elapsed, dtype=np.float64).ravel()
        if not (idx.size == sc.size == fl.size == el.size):
            raise ValueError("record columns must have equal length")
        if not np.isfinite(sc[~fl]).all():
            raise ValueError(
                "non-finite performance on a successful evaluation; "
                "coerce non-finite aggregates to failed before recording"
            )
        n0, n1 = self._n, self._n + idx.size
        if n1 > self.capacity:
            self._grow(n1)
        self.config_idx[n0:n1] = idx
        self.score[n0:n1] = sc
        self.failed[n0:n1] = fl
        self.elapsed[n0:n1] = el
        self.rung_id[n0:n1] = rung_i
        self.trace_id[n0:n1] = trace_id
        self._n = n1

    def rows(self, rung_i: int) -> np.ndarray:
        """Row indices recorded at rung ``rung_i`` (in evaluation order)."""
        return np.flatnonzero(self.rung_id[: self._n] == rung_i)

    def promote(self, rung_i: int, eta: int) -> np.ndarray:
        """Masked stable top-k: config indices surviving rung ``rung_i``.

        keep = max(len(ok) // eta, 1) successful rows by ascending score;
        ties keep evaluation order (stable sort), replaying the scalar
        reference bit-for-bit.
        """
        rows = self.rows(rung_i)
        ok = rows[~self.failed[rows]]
        if ok.size == 0:
            surv = np.empty(0, dtype=np.int64)
        else:
            keep = max(int(ok.size) // int(eta), 1)
            order = np.argsort(self.score[ok], kind="stable")
            surv = self.config_idx[ok[order[:keep]]]
        self.survivors.append(surv)
        return surv

    def rung_outcomes(self, rung_i: int) -> List["EvalOutcome"]:
        """Materialize one rung's rows as scalar ``EvalOutcome``s."""
        return [
            EvalOutcome(
                config=self.configs[int(self.config_idx[i])],
                performance=float(self.score[i]),
                failed=bool(self.failed[i]),
                elapsed=float(self.elapsed[i]),
            )
            for i in self.rows(rung_i)
        ]


@dataclass
class EvalOutcome:
    config: dict
    performance: float
    failed: bool
    elapsed: float


class HyperbandRunner:
    """Drives one SH inner loop at a time.

    provide_candidates(n, rungs) -> sequence of configs for a new bracket
        (the controller injects warm starts + BO candidates here; the
        table backend accepts any indexable sequence — e.g. a columnar
        ``ConfigBatch`` / ``CandidateColumns`` — and materializes rows
        only when an evaluation needs the dict).
    evaluate(config, delta, cost_cap) -> (performance, failed, elapsed)
        performance must be comparable within a fidelity (lower better).
    on_result(config, delta, performance, failed, elapsed) -> None
        observation hook (knowledge base updates).
    should_stop() -> bool  budget check between evaluations.

    Batched rungs: pass ``evaluate_batch(configs, delta, cost_cap) ->
    list[(performance, failed, elapsed)]`` to ``run_bracket`` and every rung
    evaluates all of its survivors in one call (the vectorized
    ``Workload.evaluate_many`` path). The median-cost cap is computed once
    from the history at rung start and applied to the whole rung (the
    scalar path refreshes it per config — the only semantic difference);
    per-config cost history, on_result hooks and promotion are unchanged.
    The callback may return fewer results than configs (a prefix) when the
    caller's budget runs out mid-rung, mirroring the scalar path's
    between-config should_stop checks.

    ``backend="table"`` (module default) keeps bracket state in an
    array-native :class:`RungTable` (finished/in-flight tables exposed on
    ``self.tables``); ``backend="loop"`` is the pinned scalar reference.
    Survivor sets, outcome order and cost caps are bit-identical across
    backends.
    """

    def __init__(
        self,
        R: float = 9,
        eta: int = 3,
        early_stop_factor: float = 1.0,
        seed: int = 0,
        backend: Optional[str] = None,
    ):
        self.R = R
        self.eta = eta
        self.early_stop_factor = early_stop_factor
        self.brackets = hb_schedule(R, eta)
        self.backend = backend if backend is not None else get_hyperband_backend()
        if self.backend not in _HB_BACKENDS:
            raise ValueError(f"unknown hyperband backend {self.backend!r}")
        self._bracket_idx = 0
        self._cost_history = CostColumns() if self.backend == "table" else {}
        self.tables: List[RungTable] = []
        self.rng = np.random.default_rng(seed)

    def next_bracket(self) -> Bracket:
        b = self.brackets[self._bracket_idx % len(self.brackets)]
        self._bracket_idx += 1
        return b

    def _record_cost(self, delta: float, elapsed: float) -> None:
        key = round(delta, 6)
        if isinstance(self._cost_history, CostColumns):
            self._cost_history.append(key, elapsed)
        else:
            self._cost_history.setdefault(key, []).append(elapsed)

    def _cost_cap(self, delta: float) -> Optional[float]:
        key = round(delta, 6)
        hist = self._cost_history
        if isinstance(hist, CostColumns):
            if hist.count(key) < 3:
                return None
            return self.early_stop_factor * hist.median(key)
        h = hist.get(key, [])
        if len(h) < 3:
            return None
        return self.early_stop_factor * float(np.median(h))

    def run_bracket(
        self,
        bracket: Bracket,
        provide_candidates: Callable[[int, List[Rung]], Sequence[dict]],
        evaluate: Callable[[dict, float, Optional[float]], Tuple[float, bool, float]],
        on_result: Callable[[dict, float, float, bool, float], None],
        should_stop: Callable[[], bool],
        evaluate_batch: Optional[
            Callable[[List[dict], float, Optional[float]], List[Tuple[float, bool, float]]]
        ] = None,
    ) -> List[EvalOutcome]:
        """Run one SH inner loop; returns outcomes of the final rung."""
        args = (bracket, provide_candidates, evaluate, on_result, should_stop, evaluate_batch)
        if self.backend == "table":
            return self._run_bracket_table(*args)
        return self._run_bracket_loop(*args)

    # ------------------------------------------------------- scalar reference
    def _run_bracket_loop(
        self, bracket, provide_candidates, evaluate, on_result, should_stop, evaluate_batch
    ) -> List[EvalOutcome]:
        rungs = bracket.rungs
        configs = provide_candidates(rungs[0].n, rungs)
        outcomes: List[EvalOutcome] = []
        survivors = list(configs)
        for rung_i, rung in enumerate(rungs):
            if should_stop():
                break
            with obs.span(
                "rung_eval", s=bracket.s, rung=rung_i, delta=rung.delta,
                n=min(rung.n, len(survivors)),
            ) as sp:
                results: List[EvalOutcome] = []
                if evaluate_batch is not None:
                    batch = survivors[: rung.n]
                    cap = self._cost_cap(rung.delta)
                    for cfg, (perf, failed, elapsed) in zip(
                        batch, evaluate_batch(batch, rung.delta, cap)
                    ):
                        self._record_cost(rung.delta, elapsed)
                        on_result(cfg, rung.delta, perf, failed, elapsed)
                        results.append(EvalOutcome(cfg, perf, failed, elapsed))
                else:
                    for cfg in survivors[: rung.n]:
                        if should_stop():
                            break
                        cap = self._cost_cap(rung.delta)
                        perf, failed, elapsed = evaluate(cfg, rung.delta, cap)
                        self._record_cost(rung.delta, elapsed)
                        on_result(cfg, rung.delta, perf, failed, elapsed)
                        results.append(EvalOutcome(cfg, perf, failed, elapsed))
                ok = [r for r in results if not r.failed]
                ok.sort(key=lambda r: r.performance)
                sp.set(
                    evaluated=len(results), ok=len(ok),
                    cost=float(sum(r.elapsed for r in results)),
                )
                if rung_i + 1 < len(rungs):
                    # promotion quota over *successful* evaluations: counting
                    # failed rows (the old len(results)) promoted more than the
                    # top n_i/eta of the configs that actually have a score
                    keep = max(len(ok) // self.eta, 1)
                    survivors = [r.config for r in ok[:keep]]
                    sp.set(survivors=len(survivors))
                    if not survivors:
                        break
                else:
                    outcomes = results
        return outcomes

    # ----------------------------------------------------- array-native table
    def _run_bracket_table(
        self, bracket, provide_candidates, evaluate, on_result, should_stop, evaluate_batch
    ) -> List[EvalOutcome]:
        rungs = bracket.rungs
        configs = provide_candidates(rungs[0].n, rungs)
        table = RungTable(bracket, configs)
        self.tables.append(table)
        outcomes: List[EvalOutcome] = []
        survivors = np.arange(len(configs), dtype=np.int64)
        for rung_i, rung in enumerate(rungs):
            if should_stop():
                break
            idxs = survivors[: rung.n]
            with obs.span(
                "rung_eval", s=bracket.s, rung=rung_i, delta=rung.delta, n=len(idxs)
            ) as sp:
                if evaluate_batch is not None:
                    batch = [configs[int(i)] for i in idxs]
                    cap = self._cost_cap(rung.delta)
                    res = evaluate_batch(batch, rung.delta, cap)
                    idxs = idxs[: len(res)]  # budget may truncate to a prefix
                    perf = np.fromiter((r[0] for r in res), dtype=np.float64, count=len(res))
                    fail = np.fromiter((r[1] for r in res), dtype=bool, count=len(res))
                    elap = np.fromiter((r[2] for r in res), dtype=np.float64, count=len(res))
                    if isinstance(self._cost_history, CostColumns):
                        self._cost_history.extend(round(rung.delta, 6), elap)
                    else:
                        for e in elap:
                            self._record_cost(rung.delta, float(e))
                    for i, (p, f, e) in zip(idxs, res):
                        on_result(configs[int(i)], rung.delta, p, f, e)
                else:
                    done, perf_l, fail_l, elap_l = 0, [], [], []
                    for i in idxs:
                        if should_stop():
                            break
                        cfg = configs[int(i)]
                        cap = self._cost_cap(rung.delta)
                        p, f, e = evaluate(cfg, rung.delta, cap)
                        self._record_cost(rung.delta, e)
                        on_result(cfg, rung.delta, p, f, e)
                        perf_l.append(p)
                        fail_l.append(f)
                        elap_l.append(e)
                        done += 1
                    idxs = idxs[:done]
                    perf = np.asarray(perf_l, dtype=np.float64)
                    fail = np.asarray(fail_l, dtype=bool)
                    elap = np.asarray(elap_l, dtype=np.float64)
                table.record(rung_i, idxs, perf, fail, elap, trace_id=sp.id)
                sp.set(
                    evaluated=len(idxs), ok=int(len(idxs) - np.count_nonzero(fail)),
                    cost=float(elap.sum()),
                )
                if rung_i + 1 < len(rungs):
                    survivors = table.promote(rung_i, self.eta)
                    sp.set(survivors=int(survivors.size))
                    if survivors.size == 0:
                        break
                else:
                    outcomes = table.rung_outcomes(rung_i)
        return outcomes
