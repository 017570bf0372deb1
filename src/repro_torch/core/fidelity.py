"""Query-based fidelity partitioning (paper §6.1, Algorithm 2).

A delta-fidelity proxy is a subset Q_delta of the workload's queries whose
aggregate latency rank-correlates with the full workload across
configurations, subject to Cost(Q_delta) <= delta * Cost(Q). The greedy
solver starts from the empty set and repeatedly adds the query that
maximizes the weighted Kendall-tau correlation score while respecting the
cost budget. Correlations are computed on historical observations of
source tasks with the *same query set* (Eq. 8), weighted by task
similarity; the current task's own full-fidelity observations can serve as
a source (degradation path, §6.3).

Also provides the two proxy baselines the paper evaluates in Fig. 1b
(data-volume scaling and SQL early stop) so the comparison is reproducible.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from .knowledge import TaskRecord
from .similarity import kendall_tau

__all__ = [
    "QueryStats",
    "collect_query_stats",
    "query_cost_ratios",
    "subset_correlation",
    "greedy_query_subset",
    "FidelityPartition",
    "partition_fidelities",
    "early_stop_subset",
]


@dataclass
class QueryStats:
    """Per-source-task observation matrices aligned to the query list.

    perf: (n_configs, n_queries) latency of each query under each config.
    cost: (n_configs, n_queries) evaluation cost (elapsed time here).
    weight: the task's transfer weight w_i.
    """

    task_id: str
    perf: np.ndarray
    cost: np.ndarray
    weight: float


def collect_query_stats(
    tasks: Sequence[TaskRecord], weights: Dict[str, float], min_configs: int = 3
) -> List[QueryStats]:
    out: List[QueryStats] = []
    for t in tasks:
        obs = t.with_query_vectors()
        if len(obs) < min_configs:
            continue
        w = weights.get(t.task_id, 0.0)
        if t.task_id == "__target__":
            w = weights.get("__target__", 0.0)
        if w <= 0:
            continue
        perf = np.array([o.per_query_perf for o in obs], dtype=float)
        cost = np.array(
            [o.per_query_cost if o.per_query_cost is not None else o.per_query_perf for o in obs],
            dtype=float,
        )
        out.append(QueryStats(task_id=t.task_id, perf=perf, cost=cost, weight=w))
    return out


def query_cost_ratios(stats: Sequence[QueryStats]) -> np.ndarray:
    """Weighted average cost ratio c(q) of each query (Alg. 2 line 2)."""
    total_w = sum(s.weight for s in stats)
    m = stats[0].cost.shape[1]
    c = np.zeros(m)
    for s in stats:
        per_cfg_total = s.cost.sum(axis=1, keepdims=True)  # (n,1)
        ratios = (s.cost / np.maximum(per_cfg_total, 1e-12)).mean(axis=0)
        c += (s.weight / total_w) * ratios
    return c


def subset_correlation(stats: Sequence[QueryStats], subset: Sequence[int]) -> float:
    """tau(Q_delta, Q) = sum_i w_i KendallTau(A_i^{Q_delta}, A_i^{Q})  (Eq. 8)."""
    if not subset:
        return 0.0
    idx = np.asarray(list(subset), dtype=int)
    total_w = sum(s.weight for s in stats)
    score = 0.0
    for s in stats:
        agg_sub = s.perf[:, idx].sum(axis=1)
        agg_full = s.perf.sum(axis=1)
        tau, _ = kendall_tau(agg_sub, agg_full)
        score += (s.weight / total_w) * tau
    return score


def greedy_query_subset(
    stats: Sequence[QueryStats], delta: float
) -> Tuple[List[int], float, float]:
    """Algorithm 2. Returns (subset indices, correlation score, cost ratio)."""
    if not stats:
        raise ValueError("no source stats for fidelity partitioning")
    c = query_cost_ratios(stats)
    m = len(c)
    subset: List[int] = []
    r = 0.0
    current_tau = 0.0
    remaining = set(range(m))
    while True:
        best_q, best_tau = None, -np.inf
        for q in sorted(remaining):
            if r + c[q] > delta + 1e-12:
                continue
            tau = subset_correlation(stats, subset + [q])
            if tau > best_tau:
                best_q, best_tau = q, tau
        if best_q is None:
            break
        subset.append(best_q)
        remaining.discard(best_q)
        r += c[best_q]
        current_tau = best_tau
        if current_tau >= 1.0 - 1e-12:
            break
    return subset, current_tau, r


@dataclass
class FidelityPartition:
    """Mapping fidelity delta -> selected query indices (+ diagnostics)."""

    subsets: Dict[float, List[int]]
    scores: Dict[float, float]
    cost_ratios: Dict[float, float]

    def queries_for(self, delta: float) -> List[int]:
        if delta >= 1.0:
            # full fidelity: all queries (total count inferred from any subset)
            return []  # sentinel: empty means "all"
        key = min(self.subsets.keys(), key=lambda d: abs(d - delta))
        return self.subsets[key]


def partition_fidelities(
    stats: Sequence[QueryStats], deltas: Sequence[float]
) -> FidelityPartition:
    subsets: Dict[float, List[int]] = {}
    scores: Dict[float, float] = {}
    ratios: Dict[float, float] = {}
    for d in deltas:
        if d >= 1.0:
            continue
        s, tau, r = greedy_query_subset(stats, d)
        subsets[d] = s
        scores[d] = tau
        ratios[d] = r
    return FidelityPartition(subsets=subsets, scores=scores, cost_ratios=ratios)


def early_stop_subset(n_queries: int, delta: float) -> List[int]:
    """SQL Early Stop baseline: first ceil(delta * m) queries (Fig. 1b)."""
    k = max(1, int(np.ceil(delta * n_queries)))
    return list(range(min(k, n_queries)))
