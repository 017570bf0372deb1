"""SparkWorkload: the Workload-protocol adapter over the cost model,
including SparkEventLog-style 34-d meta-feature extraction (paper §4.2).

``evaluate`` runs one config through the scalar reference path;
``evaluate_many`` routes a whole batch of configs through the vectorized
``SparkCostModel.evaluate_batch`` grid engine (bit-for-bit equivalent to a
loop over ``evaluate``, but one NumPy pass over all configs x queries) —
this is the path Hyperband rungs use.
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Union

import numpy as np

from .. import obs
from ..core.space import ConfigSpace
from ..tuneapi import EvalResult, Workload
from .knobs import spark_space
from .model import SCENARIOS, HardwareScenario, SparkCostModel

__all__ = ["SparkWorkload", "make_task_id"]

Config = Dict[str, Any]


def make_task_id(benchmark: str, data_gb: int, hardware: str) -> str:
    return f"{benchmark}-{data_gb}gb-{hardware}"


class SparkWorkload(Workload):
    def __init__(
        self,
        benchmark: str = "tpch",
        data_gb: int = 600,
        hardware: str = "A",
        seed: int = 1234,
        space: Optional[ConfigSpace] = None,
    ):
        self.benchmark = benchmark
        self.data_gb = data_gb
        self.hardware = hardware
        self.model = SparkCostModel(benchmark, data_gb, SCENARIOS[hardware], seed=seed)
        self._space = space or spark_space()
        self.task_id = make_task_id(benchmark, data_gb, hardware)

    @property
    def queries(self) -> List[str]:
        return [p.name for p in self.model.profiles]

    @property
    def space(self) -> ConfigSpace:
        return self._space

    def evaluate(
        self,
        config: Config,
        query_indices: Optional[Sequence[int]] = None,
        cost_cap: Optional[float] = None,
        data_fraction: float = 1.0,
    ) -> EvalResult:
        cfg = dict(self._space.default(), **config)
        with obs.span("workload_eval", task=self.task_id, n=1,
                      queries=len(query_indices) if query_indices is not None
                      else len(self.model.profiles)) as sp:
            lats, costs, failed, reason = self.model.evaluate(
                cfg,
                query_indices=list(query_indices) if query_indices is not None else None,
                data_fraction=data_fraction,
                cost_cap=cost_cap,
            )
            obs.count(f"workload/{reason or 'ok'}")
            sp.set(failed=failed, reason=reason or "ok")
        return EvalResult(
            per_query_latency=lats, per_query_cost=costs, failed=failed, failure_reason=reason
        )

    def evaluate_many(
        self,
        configs: Sequence[Config],
        query_indices: Optional[Sequence[int]] = None,
        cost_cap: Union[None, float, Sequence[Optional[float]]] = None,
        data_fraction: float = 1.0,
    ) -> List[EvalResult]:
        """Batched evaluation via the vectorized cost-model grid."""
        caps = self._per_config_caps(cost_cap, len(configs))
        cfgs = [dict(self._space.default(), **c) for c in configs]
        with obs.span("workload_eval", task=self.task_id, n=len(cfgs),
                      queries=len(query_indices) if query_indices is not None
                      else len(self.model.profiles)) as sp:
            rows = self.model.evaluate_batch(
                cfgs,
                query_indices=list(query_indices) if query_indices is not None else None,
                data_fraction=data_fraction,
                cost_cap=caps,
            )
            n_failed = 0
            for _, _, failed, reason in rows:
                obs.count(f"workload/{reason or 'ok'}")
                n_failed += bool(failed)
            sp.set(failures=n_failed)
        return [
            EvalResult(per_query_latency=lats, per_query_cost=costs,
                       failed=failed, failure_reason=reason)
            for lats, costs, failed, reason in rows
        ]

    # ----------------------------------------------------------- meta features
    def meta_features(self) -> List[float]:
        """34-d vector from the default-config 'event log' (paper §4.2).

        Per-query latencies and stage breakdowns under the default config
        are summarized into workload-level statistics.
        """
        cfg = self._space.default()
        lats, scans, computes, shuffles, spills, skews, shuffle_fracs = [], [], [], [], [], [], []
        for p in self.model.profiles:
            lat, _failed, bd = self.model.query_latency(cfg, p)
            lats.append(lat)
            scans.append(bd["scan"])
            computes.append(bd["compute"])
            shuffles.append(bd["shuffle"])
            spills.append(bd["spill_ratio"])
            skews.append(p.skew)
            shuffle_fracs.append(p.shuffle_frac)
        lats = np.asarray(lats)
        log_l = np.log(np.maximum(lats, 1e-6))
        total = lats.sum()
        parts = np.asarray([scans, computes, shuffles])  # (3, m)
        part_frac = parts.sum(axis=1) / max(parts.sum(), 1e-9)

        def stats(x: np.ndarray) -> List[float]:
            return [
                float(np.mean(x)), float(np.std(x)),
                float(np.percentile(x, 25)), float(np.percentile(x, 50)),
                float(np.percentile(x, 75)), float(np.max(x)), float(np.min(x)),
            ]

        feats: List[float] = []
        feats += stats(log_l)                               # 7: latency distribution
        feats += stats(np.log(np.maximum(np.asarray(shuffles), 1e-6)))  # 7: shuffle time dist
        feats += list(part_frac)                            # 3: scan/compute/shuffle split
        feats += [float(np.log(total)), float(len(lats))]   # 2
        feats += stats(np.asarray(spills))                  # 7: memory pressure dist
        feats += [float(np.mean(skews)), float(np.max(skews))]          # 2
        feats += [float(np.mean(shuffle_fracs)), float(np.max(shuffle_fracs))]  # 2
        feats += [
            float(self.model.hw.nodes),
            float(self.model.hw.cores),
            float(np.log(self.model.hw.ram_gb)),
            float(np.log(self.model.data_gb)),
        ]                                                   # 4
        assert len(feats) == 34, len(feats)
        return feats
