"""Shared machinery for the SOTA baseline tuners (paper §7.1).

Every baseline is a full-fidelity iterative tuner: propose a config,
evaluate the entire workload, record. The accounting (budget charging,
best-so-far trajectory of *successful full evaluations*) is identical to
MFTune's so end-to-end comparisons are apples-to-apples.

Port of ``repro.baselines.common``. The tuner loop, every random draw and
every argmax stay on the host in the reference's order; ``device`` (default
the CUDA card) reaches every forest a tuner fits, so each PRF prediction
descends through kernel K1 there and comes back to the host for numpy's
selection.
"""

from __future__ import annotations

import time as _time
from contextlib import contextmanager
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

from .. import obs as _obs
from ..core.acquisition import ei_scores
from ..core.knowledge import KnowledgeBase, Observation
from ..core.mftune import TrajectoryPoint, TuningResult
from ..core.space import ConfigSpace
from ..core.surrogate import make_forest
from ..device import DeviceLike, resolve_device
from ..tuneapi import Budget, Workload

Config = Dict[str, Any]

__all__ = ["BaselineTuner", "RandomSearch", "VanillaBO", "permutation_importance"]


def permutation_importance(model, X: np.ndarray, cols: Sequence[int],
                           rng: np.random.Generator) -> np.ndarray:
    """Mean absolute change of ``model``'s mean prediction over the rows of
    ``X`` when column ``j`` is permuted, for each ``j`` of ``cols``.

    The permutations are drawn from ``rng`` column by column, in the
    reference's order; the base rows and every permuted copy are then
    stacked into one prediction call, so the forest descends once (one K1
    launch on the card) instead of once a column. A row's leaf stats and
    ensemble combine depend on that row alone, so each block's means are
    those of a call of its own.
    """
    n = len(X)
    blocks = [X]
    for j in cols:
        Xp = X.copy()
        Xp[:, j] = rng.permutation(Xp[:, j])
        blocks.append(Xp)
    pred = model.predict_mean(np.concatenate(blocks))
    base = pred[:n]
    return np.array([float(np.abs(pred[(i + 1) * n:(i + 2) * n] - base).mean())
                     for i in range(len(cols))])


class BaselineTuner:
    name = "baseline"

    def __init__(self, workload: Workload, kb: Optional[KnowledgeBase] = None, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.wl = workload
        self.kb = kb or KnowledgeBase()
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.space: ConfigSpace = workload.space
        self.obs: List[Observation] = []
        self._trajectory: List[TrajectoryPoint] = []
        # same per-run registry shape as MFTune, so an end-to-end comparison
        # reports stage breakdowns for every method through one vocabulary
        self.metrics = _obs.Metrics()

    @contextmanager
    def stage(self, key: str, **args):
        """Span + ``overhead/<key>`` counter around one tuner stage — the
        shared Tracer entry point every baseline proposal routes through."""
        t0 = _time.perf_counter()
        with _obs.span(key, tuner=self.name, **args) as sp:
            try:
                yield sp
            finally:
                self.metrics.counter("overhead/" + key).add(
                    _time.perf_counter() - t0
                )

    # ------------------------------------------------------------- accounting
    def _ok(self) -> List[Observation]:
        return [o for o in self.obs if not o.failed]

    def best(self):
        ok = self._ok()
        return min(ok, key=lambda o: o.performance) if ok else None

    def evaluate_full(self, budget: Budget, cfg: Config, query_indices=None) -> Observation:
        cfg = dict(self.space.default(), **cfg)
        res = self.wl.evaluate(cfg, query_indices=query_indices)
        budget.charge(res.elapsed, label=f"{self.name}-eval")
        o = Observation(
            config=cfg,
            performance=res.aggregate if not res.failed else float("inf"),
            fidelity=1.0 if query_indices is None else 0.0,
            per_query_perf=list(res.per_query_latency) if not res.failed else None,
            per_query_cost=list(res.per_query_cost) if not res.failed else None,
            failed=res.failed,
            elapsed=res.elapsed,
            time=budget.now,
        )
        if query_indices is None:
            m = self.metrics
            m.counter("eval/failed" if o.failed else "eval/ok").add()
            m.counter("budget/full_fidelity_s").add(res.elapsed)
            m.histogram("eval/elapsed_s").observe(res.elapsed)
            self.obs.append(o)
            if not o.failed:
                b = self.best()
                if b is o:
                    self._trajectory.append(
                        TrajectoryPoint(time=budget.now, best=o.performance, config=cfg,
                                        fidelity=1.0, wall_time=_time.time(), rung=None)
                    )
        return o

    # ---------------------------------------------------------------- running
    def initialize(self, budget: Budget) -> None:
        """Default: small LHS init."""
        with _obs.span("cold_start", tuner=self.name):
            for cfg in self.space.lhs_sample(self.rng, 5):
                if budget.exhausted:
                    return
                self.evaluate_full(budget, cfg)

    def propose(self, budget: Budget) -> Optional[Config]:
        raise NotImplementedError

    def step(self, budget: Budget) -> None:
        with self.stage("bo_recommend", mode="baseline"):
            cfg = self.propose(budget)
        if cfg is not None and not budget.exhausted:
            self.evaluate_full(budget, cfg)

    def run(self, budget: Budget) -> TuningResult:
        self.initialize(budget)
        it = 0
        while not budget.exhausted:
            with _obs.span("iteration", tuner=self.name, i=it, mode="full_fidelity"):
                self.step(budget)
            it += 1
        b = self.best()
        m = self.metrics
        tracer = _obs.get_tracer()
        if tracer is not None:
            tracer.emit_metrics(m, scope=f"{self.name}:{self.wl.task_id}")
        return TuningResult(
            best_config=b.config if b else None,
            best_performance=b.performance if b else float("inf"),
            trajectory=self._trajectory,
            n_evaluations=len(self.obs),
            n_full_evaluations=len(self.obs),
            mfo_activation_time=None,
            overheads=m.counters_view("overhead/", coerce_int=False),
            metrics=m.snapshot(),
        )

    # ------------------------------------------------------------------ utils
    def fit_surrogate(self, obs: Optional[Sequence[Observation]] = None, space=None):
        obs = list(obs) if obs is not None else self._ok()
        space = space or self.space
        if len(obs) < 2:
            return None
        with _obs.span("surrogate_fit", source=f"baseline:{self.name}", n_obs=len(obs)):
            X = space.encode_many([o.config for o in obs])
            y = np.array([o.performance for o in obs])
            return make_forest(seed=self.seed, device=self.device).fit(X, y)

    def ei_pick(self, model, pool: Sequence[Config], space=None) -> Config:
        """Best-EI pick: the pool's unit encoding is scored on the model's
        device (K1 and EI), and numpy's ``argmax`` of the host copy picks the
        first maximum; only the winner materializes."""
        space = space or self.space
        ok = self._ok()
        best = min(o.performance for o in ok) if ok else 0.0
        with _obs.span("acquisition", pool=len(pool), sources=1, k=1):
            scores = ei_scores(model, space.encode_many(pool), best)
        return pool[int(np.argmax(scores))]


class RandomSearch(BaselineTuner):
    name = "random"

    def propose(self, budget: Budget) -> Config:
        return self.space.sample(self.rng, 1)[0]


class VanillaBO(BaselineTuner):
    name = "bo"

    def propose(self, budget: Budget) -> Config:
        model = self.fit_surrogate()
        pool = self.space.sample(self.rng, 192)
        if model is None:
            return pool[0]
        return self.ei_pick(model, pool)
