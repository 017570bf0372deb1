"""Workload protocol shared by the Spark simulator and the JAX objective.

A workload is a named set of queries evaluated under a configuration; the
tuner only ever interacts with this interface, so MFTune is agnostic to
whether a "query" is a SQL statement (sparksim) or a compiled step program
(jaxwl). Evaluation cost is charged to a Budget whose clock is virtual for
the simulator and real for compiled evaluations.

Two evaluation entry points:

- ``evaluate(config, ...)``       — one configuration.
- ``evaluate_many(configs, ...)`` — a batch of configurations over the same
  query subset / data fraction. The base implementation is a loop over
  ``evaluate`` so every workload supports it; implementations with a
  vectorizable objective (``sparksim.SparkWorkload`` via
  ``SparkCostModel.evaluate_batch``) override it to evaluate the whole
  (configs x queries) grid in one pass. Hyperband rungs feed entire
  survivor sets through this hook.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Union

__all__ = ["EvalResult", "Workload", "Budget"]

Config = Dict[str, Any]


@dataclass
class EvalResult:
    per_query_latency: List[float]          # latency per evaluated query (aligned to subset order)
    per_query_cost: List[float]             # cost charged per evaluated query
    failed: bool = False                    # OOM / error / early-stopped
    failure_reason: str = ""

    @property
    def aggregate(self) -> float:
        return float(sum(self.per_query_latency))

    @property
    def elapsed(self) -> float:
        return float(sum(self.per_query_cost))


class Workload:
    """Interface. Implementations: sparksim.SparkWorkload, jaxwl.CellWorkload."""

    task_id: str = "workload"

    @property
    def queries(self) -> List[str]:
        raise NotImplementedError

    @property
    def space(self):  # -> ConfigSpace
        raise NotImplementedError

    def default_config(self) -> Config:
        return self.space.default()

    def evaluate(
        self,
        config: Config,
        query_indices: Optional[Sequence[int]] = None,
        cost_cap: Optional[float] = None,
        data_fraction: float = 1.0,
    ) -> EvalResult:
        """Run the given queries (None => all) under ``config``.

        ``cost_cap``: abort (failed=True, reason='early_stop') once the
        accumulated cost exceeds the cap — the §6.3 median early-stop hook.
        ``data_fraction``: scale the input data volume (the paper's
        Data-Volume proxy baseline); implementations may ignore it.
        """
        raise NotImplementedError

    def evaluate_many(
        self,
        configs: Sequence[Config],
        query_indices: Optional[Sequence[int]] = None,
        cost_cap: Union[None, float, Sequence[Optional[float]]] = None,
        data_fraction: float = 1.0,
    ) -> List[EvalResult]:
        """Evaluate a batch of configs over the same query subset.

        ``cost_cap`` is either one cap applied to every config independently
        or a per-config sequence. Default: loop over ``evaluate`` —
        override for vectorized backends.
        """
        caps = self._per_config_caps(cost_cap, len(configs))
        return [
            self.evaluate(c, query_indices=query_indices, cost_cap=cap,
                          data_fraction=data_fraction)
            for c, cap in zip(configs, caps)
        ]

    @staticmethod
    def _per_config_caps(
        cost_cap: Union[None, float, Sequence[Optional[float]]], n: int
    ) -> List[Optional[float]]:
        if cost_cap is None or isinstance(cost_cap, (int, float)):
            return [cost_cap] * n  # type: ignore[list-item]
        caps = list(cost_cap)
        if len(caps) != n:
            raise ValueError(f"{len(caps)} cost caps for {n} configs")
        return caps

    def meta_features(self) -> Optional[List[float]]:
        return None


class Budget:
    """Budget accounting on a virtual or real clock."""

    def __init__(self, total: float):
        self.total = float(total)
        self.spent = 0.0
        self.events: List[Dict[str, float]] = []

    def charge(self, seconds: float, label: str = "") -> None:
        self.spent += float(seconds)
        self.events.append({"t": self.spent, "cost": float(seconds), "label": label})

    @property
    def remaining(self) -> float:
        return self.total - self.spent

    @property
    def exhausted(self) -> bool:
        return self.spent >= self.total

    @property
    def now(self) -> float:
        return self.spent
