"""LOCAT (Xin et al., SIGMOD'22) — low-overhead online configuration tuning.

Key mechanisms reproduced (per its paper and §2.1/§7.1 of MFTune):
  * IICP: iteratively identifies important configuration parameters from
    accumulated observations (permutation importance on the surrogate) and
    shrinks the search space to the top knobs, tightening over time.
  * QCSA: after sufficient observations, compresses the *workload*: selects
    the query subset that preserves the aggregate ranking on observed data,
    then fully replaces the original workload with the compressed one
    (MFTune's §2.1 critique). New compressed-run incumbents trigger one
    full-workload validation run (how a deployment would consume the
    recommendation) — charged to the budget.

No historical-task knowledge is used (history-free method).

Port of ``repro.baselines.locat``: the permutation importance draws the
reference's permutations and scores all permuted copies in one forest
prediction (one K1 launch on the card, see
:func:`~repro_torch.baselines.common.permutation_importance`).
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.fidelity import QueryStats, greedy_query_subset
from .common import BaselineTuner, Budget, permutation_importance

__all__ = ["LOCAT"]


class LOCAT(BaselineTuner):
    name = "locat"

    def __init__(self, workload, kb=None, seed: int = 0,
                 compress_after: int = 12, shrink_every: int = 8, keep_frac: float = 0.6,
                 qcsa_delta: float = 0.4, device=None):
        super().__init__(workload, kb, seed, device=device)
        self.compress_after = compress_after
        self.shrink_every = shrink_every
        self.keep_frac = keep_frac
        self.qcsa_delta = qcsa_delta
        self.active_space = self.space
        self.query_subset: Optional[List[int]] = None
        self._compressed_best: float = float("inf")

    # ------------------------------------------------------------------ IICP
    def _maybe_shrink_space(self) -> None:
        ok = self._ok()
        if len(ok) < self.shrink_every or len(ok) % self.shrink_every != 0:
            return
        model = self.fit_surrogate(ok)
        if model is None:
            return
        X = self.space.encode_many([o.config for o in ok])
        imp = permutation_importance(model, X, range(X.shape[1]),
                                     np.random.default_rng(self.seed))
        k = max(int(len(self.space.names) * self.keep_frac), 8)
        order = np.argsort(-imp)
        keep = [self.space.names[i] for i in order[:k]]
        self.active_space = self.space.restrict(keep=keep)

    # ------------------------------------------------------------------ QCSA
    def _maybe_compress_workload(self) -> None:
        if self.query_subset is not None:
            return
        full = [o for o in self._ok() if o.per_query_perf is not None]
        if len(full) < self.compress_after:
            return
        perf = np.array([o.per_query_perf for o in full])
        cost = np.array([o.per_query_cost for o in full])
        stats = [QueryStats(task_id=self.wl.task_id, perf=perf, cost=cost, weight=1.0)]
        subset, _tau, _r = greedy_query_subset(stats, self.qcsa_delta)
        if subset:
            self.query_subset = subset

    # ------------------------------------------------------------------ loop
    def step(self, budget: Budget) -> None:
        with self.stage("bo_recommend", mode="baseline"):
            self._maybe_shrink_space()
            self._maybe_compress_workload()
            model = self.fit_surrogate(space=self.space)
            # columnar: sample the shrunk space, lift into the full space with
            # defaults, and score without materializing dicts
            pool = self.space.complete_batch(self.active_space.sample(self.rng, 192))
            cfg = self.ei_pick(model, pool) if model is not None else pool[0]
        if self.query_subset is None:
            self.evaluate_full(budget, cfg)
            return
        # compressed-workload evaluation (replaces the original workload)
        o = self.evaluate_full(budget, cfg, query_indices=self.query_subset)
        if not o.failed and o.performance < self._compressed_best:
            self._compressed_best = o.performance
            if not budget.exhausted:
                self.evaluate_full(budget, cfg)  # deployment validation run
