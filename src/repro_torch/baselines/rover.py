"""Rover (Shen et al., KDD'23) — generalized transfer learning for Spark.

Mechanisms reproduced (per §2.1/§4.2/§7.1 of MFTune): adaptive similarity
weights over historical workloads (meta-feature prediction early, surrogate
agreement later — MFTune §4.2 explicitly extends Rover's scheme), used to
*weight the BO acquisition function* across source surrogates. No search
space compression, no multi-fidelity, no Phase-2 warm start; the best
historical config seeds the search (Rover's safe exploration).

Port of ``repro.baselines.rover``: the target and source forests descend
together through one fused plane (K1), their EI matrix is ranked row by
row by the radix rank (K2), and numpy's ``argmin`` of the host copy of the
aggregate picks the candidate.

Rover adds the target's record to ``kb`` and mirrors every full
evaluation into it, so each run needs a knowledge base no earlier run
touched.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import obs as _obs
from ..core.acquisition import aggregate_ranks, score_sources
from ..core.knowledge import KnowledgeBase, TaskRecord
from ..core.similarity import SimilarityEngine
from .common import BaselineTuner, Budget, Config

__all__ = ["Rover"]


class Rover(BaselineTuner):
    name = "rover"

    def __init__(self, workload, kb: Optional[KnowledgeBase] = None, seed: int = 0,
                 device=None):
        super().__init__(workload, kb, seed, device=device)
        self.target = TaskRecord(
            task_id=workload.task_id,
            queries=list(workload.queries),
            meta_features=workload.meta_features(),
        )
        self.kb.tasks.setdefault(self.target.task_id, self.target)
        self.sim = SimilarityEngine(self.space, self.kb, seed=seed, device=self.device)

    def initialize(self, budget: Budget) -> None:
        with _obs.span("warm_start", tuner=self.name):
            self._initialize(budget)

    def _initialize(self, budget: Budget) -> None:
        # seed with the best config of the most similar source, then LHS
        weights = self.sim.compute(self.target)
        best_tid = None
        best_w = 0.0
        for tid, w in weights.weights.items():
            if tid != "__target__" and w > best_w:
                best_tid, best_w = tid, w
        if best_tid is not None:
            b = self.kb.get(best_tid).best()
            if b is not None and not budget.exhausted:
                self.evaluate_full(budget, b.config)
        for cfg in self.space.lhs_sample(self.rng, 4):
            if budget.exhausted:
                return
            self.evaluate_full(budget, cfg)

    def evaluate_full(self, budget: Budget, cfg, query_indices=None):
        o = super().evaluate_full(budget, cfg, query_indices)
        # mirror observations into the target record for the similarity engine
        if query_indices is None:
            self.target.observations.append(o)
        return o

    def propose(self, budget: Budget) -> Config:
        pool = self.space.sample(self.rng, 192)
        ok = self._ok()
        if len(ok) < 2:
            return pool[0]
        weights = self.sim.compute(self.target)
        X = self.space.encode_many(pool)
        # target surrogate always participates
        models = [self.fit_surrogate(ok)]
        incs = [min(o.performance for o in ok)]
        wts = [max(weights.weights.get("__target__", 0.0), 0.25)]
        for tid, w in weights.weights.items():
            if tid == "__target__" or w <= 0:
                continue
            sm = self.sim.source_model(tid)
            if sm is None:
                continue
            src_best = self.kb.get(tid).best()
            models.append(sm)
            incs.append(src_best.performance if src_best else 0.0)
            wts.append(w)
        # one fused pass: shared forest descent (K1) + EI matrix + ranks (K2)
        agg = aggregate_ranks(score_sources(models, X, incs), wts)
        return pool[int(np.argmin(agg.cpu().numpy()))]
