"""TopTune (Wei et al., ICDE'25) — projection-based DBMS tuning.

Mechanisms reproduced (per §2.1/§7.1/§7.4.2 of MFTune): a HeSBO-style
random hash projection embeds the continuous knobs into a low-dimensional
synthetic space where BO runs; categorical and continuous knobs are tuned
*alternately*; bucketization coarsens the projected ranges. History-free.

Port of ``repro.baselines.toptune``: the projection, the buckets and every
draw are host numpy; the synthetic-space forest predicts on the tuner's
device (K1).
"""

from __future__ import annotations

from typing import Any, Dict, List

import numpy as np

from ..core.acquisition import ei_scores
from ..core.space import BoolKnob, CatKnob, FloatKnob, IntKnob
from ..core.surrogate import make_forest
from .common import BaselineTuner, Budget, Config

__all__ = ["TopTune"]


class TopTune(BaselineTuner):
    name = "toptune"

    def __init__(self, workload, kb=None, seed: int = 0, d_low: int = 16, n_buckets: int = 16,
                 device=None):
        super().__init__(workload, kb, seed, device=device)
        self.d_low = d_low
        self.n_buckets = n_buckets
        rng = np.random.default_rng(seed)
        self.num_names = [k.name for k in self.space.knobs if isinstance(k, (FloatKnob, IntKnob))]
        self.cat_names = [k.name for k in self.space.knobs if isinstance(k, (CatKnob, BoolKnob))]
        names = self.space.names
        self._num_idx = np.array([names.index(n) for n in self.num_names], dtype=np.int64)
        # HeSBO: each original dim hashes to one synthetic dim with a sign
        self.h = rng.integers(0, d_low, len(self.num_names))
        self.sgn = rng.choice([-1.0, 1.0], len(self.num_names))
        self._phase = 0  # alternate: 0 = continuous (projected), 1 = categorical
        self._cat_state: Dict[str, Any] = {
            n: self.space.by_name[n].default_value() for n in self.cat_names
        }
        self._low_obs: List[np.ndarray] = []
        self._low_y: List[float] = []

    # --------------------------------------------------------- projection map
    def _lift(self, z: np.ndarray) -> Config:
        """Synthetic point z in [0,1]^d_low -> full config (continuous part).

        One vectorized hash-gather + bucketization + whole-row decode;
        categorical knobs are then overwritten from the alternating-phase
        state.
        """
        u = np.full(self.space.dim, 0.5)
        uz = z[self.h]
        uz = np.where(self.sgn < 0, 1.0 - uz, uz)
        u[self._num_idx] = (np.floor(uz * self.n_buckets) + 0.5) / self.n_buckets
        cfg = self.space.decode(u)
        cfg.update(self._cat_state)
        return cfg

    def propose(self, budget: Budget) -> Config:
        self._phase ^= 1
        if self._phase == 1 and self.cat_names:
            # categorical phase: mutate categorical knobs around incumbent
            best = self.best()
            base = dict(self._cat_state)
            if best is not None:
                base = {n: best.config.get(n, base[n]) for n in self.cat_names}
            name = self.cat_names[int(self.rng.integers(len(self.cat_names)))]
            knob = self.space.by_name[name]
            choices = knob.active_choices() if hasattr(knob, "active_choices") else (False, True)
            base[name] = choices[int(self.rng.integers(len(choices)))]
            self._cat_state = base
            best_cfg = best.config if best is not None else self.space.default()
            cfg = dict(best_cfg)
            cfg.update(base)
            return cfg
        # continuous phase: BO in the synthetic space
        if len(self._low_y) >= 2:
            model = make_forest(seed=self.seed, device=self.device).fit(
                np.array(self._low_obs), np.array(self._low_y)
            )
            pool = self.rng.random((192, self.d_low))
            scores = ei_scores(model, pool, float(np.min(self._low_y)))
            z = pool[int(np.argmax(scores))]
        else:
            z = self.rng.random(self.d_low)
        self._pending_z = z
        return self._lift(z)

    def step(self, budget: Budget) -> None:
        with self.stage("bo_recommend", mode="baseline"):
            cfg = self.propose(budget)
        if cfg is None or budget.exhausted:
            return
        o = self.evaluate_full(budget, cfg)
        if self._phase == 0 and hasattr(self, "_pending_z"):
            if not o.failed:
                self._low_obs.append(self._pending_z)
                self._low_y.append(o.performance)
