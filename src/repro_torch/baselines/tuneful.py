"""Tuneful (Fekry et al., KDD'20).

Mechanisms reproduced (per §2.1/§7.1/§7.4.2 of MFTune):
  * Incremental significance analysis: every ``shrink_every`` iterations,
    remove 40% of the remaining knobs ranked least important (the paper's
    "Decrease" SC baseline is exactly this mechanism).
  * Multi-task GP transfer: a GP is fitted on the observations of the most
    similar historical task and combined with a GP on the current task's
    observations (similarity- and data-weighted posterior mixing).

Port of ``repro.baselines.tuneful``: the GPs are host numpy (see
:class:`~repro_torch.core.surrogate.GaussianProcess`); the importance
forest predicts on the tuner's device (K1, all permuted copies in one
call); the GP posterior's EI goes through the port's
``expected_improvement`` and numpy's ``argmax`` of the host copy picks.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from ..core.acquisition import expected_improvement
from ..core.knowledge import KnowledgeBase
from ..core.similarity import kendall_tau
from ..core.surrogate import GaussianProcess
from .common import BaselineTuner, Budget, Config, permutation_importance

__all__ = ["Tuneful"]


class Tuneful(BaselineTuner):
    name = "tuneful"

    def __init__(self, workload, kb: Optional[KnowledgeBase] = None, seed: int = 0,
                 shrink_every: int = 10, drop_frac: float = 0.4, device=None):
        super().__init__(workload, kb, seed, device=device)
        self.shrink_every = shrink_every
        self.drop_frac = drop_frac
        self.active_space = self.space
        self._source_gp: Optional[GaussianProcess] = None
        self._source_tau: float = 0.0
        self._source_fitted = False

    # ----------------------------------------------------------------- MTGP
    def _fit_source(self) -> None:
        """Pick the most similar source task by Kendall tau on current obs."""
        if self._source_fitted:
            return
        ok = self._ok()
        if len(ok) < 5:
            return
        self._source_fitted = True
        X = self.space.encode_many([o.config for o in ok])
        y = np.array([o.performance for o in ok])
        best_tau, best_task = 0.0, None
        for t in self.kb.source_tasks(self.wl.task_id):
            obs = t.full_fidelity()
            if len(obs) < 8:
                continue
            Xs = self.space.encode_many([o.config for o in obs])
            ys = np.array([o.performance for o in obs])
            try:
                gp = GaussianProcess().fit(Xs[:48], ys[:48])
            except RuntimeError:
                continue
            tau, _ = kendall_tau(gp.predict_mean(X), y)
            if tau > best_tau:
                best_tau, best_task = tau, gp
        if best_task is not None:
            self._source_gp = best_task
            self._source_tau = best_tau

    # -------------------------------------------------------- space shrinking
    def _maybe_shrink(self) -> None:
        ok = self._ok()
        if len(ok) < self.shrink_every or len(ok) % self.shrink_every != 0:
            return
        if len(self.active_space.names) <= 10:
            return
        model = self.fit_surrogate(ok)
        if model is None:
            return
        X = self.space.encode_many([o.config for o in ok])
        rng = np.random.default_rng(self.seed)
        names = self.active_space.names
        cols = [self.space.names.index(name) for name in names]
        imp = dict(zip(names, permutation_importance(model, X, cols, rng).tolist()))
        keep_n = max(int(len(names) * (1 - self.drop_frac)), 10)
        keep = sorted(imp, key=lambda n: -imp[n])[:keep_n]
        self.active_space = self.space.restrict(keep=keep)

    # ------------------------------------------------------------------ loop
    def propose(self, budget: Budget) -> Config:
        self._maybe_shrink()
        self._fit_source()
        ok = self._ok()
        # columnar: shrunk-space pool lifted to full space, encoded once
        pool = self.space.complete_batch(self.active_space.sample(self.rng, 192))
        if len(ok) < 2:
            return pool[0]
        X = self.space.encode_many([o.config for o in ok])
        y = np.array([o.performance for o in ok])
        try:
            gp_t = GaussianProcess().fit(X, y)
        except RuntimeError:
            return pool[0]
        Xp = self.space.encode_many(pool)
        mu_t, var_t = gp_t.predict(Xp)
        if self._source_gp is not None and self._source_tau > 0:
            # similarity-weighted posterior mixing; target weight grows with data
            w_s = self._source_tau * max(1.0 - len(ok) / 40.0, 0.1)
            mu_s, var_s = self._source_gp.predict(Xp)
            # source predictions are on a different latency scale: rank-match
            # by z-scoring both means before mixing
            zs = (mu_s - mu_s.mean()) / (mu_s.std() + 1e-9)
            zt = (mu_t - mu_t.mean()) / (mu_t.std() + 1e-9)
            z = (1 - w_s) * zt + w_s * zs
            mu = z * (mu_t.std() + 1e-9) + mu_t.mean()
            var = var_t
        else:
            mu, var = mu_t, var_t
        ei = expected_improvement(torch.from_numpy(mu).to(self.device), var, float(y.min()))
        return pool[int(np.argmax(ei.cpu().numpy()))]
