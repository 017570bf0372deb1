"""LOFTune (Li et al., TKDE'25) — low-overhead Spark SQL tuning.

Mechanisms reproduced (per §2.1/§7.1/§7.2 of MFTune): similar-workload
identification (meta-features in place of its multi-task SQL
representation encoder), an aggressive warm start that deploys the top-k
configurations of the most similar tasks at initialization, and a
workload-aware performance simulator fitted on *all* historical data (a
pooled surrogate over [config ++ meta-features]) used to screen
candidates. As MFTune's §7.2 analysis notes, its historical utilization
concentrates in the initialization phase; afterwards it runs standard BO
on its own observations with pooled-simulator screening.

Port of ``repro.baselines.loftune``: the pooled simulator and the BO forest
predict on the tuner's device (K1); the screening sorts are numpy's on the
host copies.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .. import obs as _obs
from ..core.knowledge import KnowledgeBase
from ..core.surrogate import ProbabilisticRandomForest, make_forest
from .common import BaselineTuner, Budget, Config

__all__ = ["LOFTune"]


class LOFTune(BaselineTuner):
    name = "loftune"

    def __init__(self, workload, kb: Optional[KnowledgeBase] = None, seed: int = 0,
                 warm_k: int = 5, device=None):
        super().__init__(workload, kb, seed, device=device)
        self.warm_k = warm_k
        self._pooled: Optional[ProbabilisticRandomForest] = None
        self._target_meta = workload.meta_features()

    # ------------------------------------------------- workload-aware simulator
    def _fit_pooled(self) -> None:
        if self._pooled is not None:
            return
        Xs: List[np.ndarray] = []
        ys: List[float] = []
        for t in self.kb.source_tasks(self.wl.task_id):
            if t.meta_features is None:
                continue
            mf = np.asarray(t.meta_features, dtype=float)
            obs = t.full_fidelity()
            if not obs:
                continue
            perf = np.array([o.performance for o in obs])
            # per-task z-normalized target: the simulator predicts *relative*
            # quality so different task scales can pool
            z = (perf - perf.mean()) / (perf.std() + 1e-9)
            Xe = self.space.encode_many([o.config for o in obs])  # one pass
            for xe, zi in zip(Xe, z):
                Xs.append(np.concatenate([xe, mf]))
                ys.append(float(zi))
        if len(ys) >= 10:
            self._pooled = make_forest(seed=self.seed, n_trees=12, device=self.device).fit(
                np.array(Xs), np.array(ys)
            )

    def _meta_distance(self, a, b) -> float:
        a = np.asarray(a, dtype=float)
        b = np.asarray(b, dtype=float)
        return float(np.linalg.norm((a - b) / (np.abs(a) + np.abs(b) + 1e-9)))

    # ------------------------------------------------------------------ warm
    def initialize(self, budget: Budget) -> None:
        with _obs.span("warm_start", tuner=self.name):
            self._initialize(budget)

    def _initialize(self, budget: Budget) -> None:
        sources = [t for t in self.kb.source_tasks(self.wl.task_id) if t.meta_features is not None]
        if self._target_meta is not None and sources:
            sources.sort(key=lambda t: self._meta_distance(self._target_meta, t.meta_features))
            warm: List[Config] = []
            for t in sources[:3]:
                obs = sorted(t.full_fidelity(), key=lambda o: o.performance)
                for o in obs[: self.warm_k]:
                    warm.append(o.config)
            # screen warm candidates with the pooled simulator
            self._fit_pooled()
            if self._pooled is not None and warm and self._target_meta is not None:
                Z = self._with_meta(self.space.encode_many(warm))
                order = np.argsort(self._pooled.predict_mean(Z))
                warm = [warm[i] for i in order]
            for cfg in warm[: self.warm_k]:
                if budget.exhausted:
                    return
                self.evaluate_full(budget, cfg)
        for cfg in self.space.lhs_sample(self.rng, 3):
            if budget.exhausted:
                return
            self.evaluate_full(budget, cfg)

    def _with_meta(self, X: np.ndarray) -> np.ndarray:
        """[config-encoding ++ target meta-features] rows, one broadcast."""
        mf = np.asarray(self._target_meta, dtype=float)
        return np.concatenate([X, np.broadcast_to(mf, (len(X), len(mf)))], axis=1)

    # ------------------------------------------------------------------ loop
    def propose(self, budget: Budget) -> Config:
        model = self.fit_surrogate()
        pool = self.space.sample(self.rng, 192)
        if model is None:
            return pool[0]
        # pooled-simulator pre-screen: keep the better half of the pool
        # (columnar: the pool is encoded once and sliced, never re-encoded)
        self._fit_pooled()
        if self._pooled is not None and self._target_meta is not None:
            Z = self._with_meta(pool.unit())
            order = np.argsort(self._pooled.predict_mean(Z))
            pool = pool.take(order[: len(pool) // 2])
        return self.ei_pick(model, pool)
