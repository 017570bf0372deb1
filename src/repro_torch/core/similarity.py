"""Similarity identification and weighting (paper §4.2).

Similarity S(i, T) between source task i and target T is the Kendall-tau
coefficient between the source surrogate's predictions and the ground-truth
performance on the target's observations (Eq. 2). Because Eq. 2 is noisy
when |D_T| is small, the initial phase predicts pairwise similarity from
34-d task meta-features with a GBRT regressor trained on historical
pairwise surrogate-agreement labels; a transition mechanism switches to
Eq. 2 once the majority of source tasks have tau p-values < 0.05.

Weighting: sources with non-positive similarity are dropped; the rest are
normalized to weights. The target task participates with a weight derived
from its surrogate's out-of-sample (k-fold) Kendall tau.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy import stats

from ..device import DeviceLike, resolve_device
from .gbm import GradientBoostedTrees
from .knowledge import KnowledgeBase, TaskRecord
from .space import ConfigSpace
from .surrogate import Surrogate, make_forest

__all__ = [
    "kendall_tau",
    "surrogate_for_task",
    "eq2_similarity",
    "MetaSimilarityModel",
    "SimilarityEngine",
    "TaskWeights",
]


def kendall_tau(a: Sequence[float], b: Sequence[float]) -> Tuple[float, float]:
    """Kendall tau-b and its p-value; (0, 1) for degenerate inputs."""
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    if len(a) < 2 or np.all(a == a[0]) or np.all(b == b[0]):
        return 0.0, 1.0
    res = stats.kendalltau(a, b)
    tau = float(res.statistic) if np.isfinite(res.statistic) else 0.0
    p = float(res.pvalue) if np.isfinite(res.pvalue) else 1.0
    return tau, p


def surrogate_for_task(
    space: ConfigSpace,
    task: TaskRecord,
    fidelity: Optional[float] = None,
    seed: int = 0,
    device: DeviceLike = None,
) -> Optional[Surrogate]:
    """Fit a PRF on a task's observations in the given space encoding."""
    if fidelity is None:
        obs = task.successful()
    else:
        obs = task.at_fidelity(fidelity)
    if len(obs) < 2:
        return None
    X = space.encode_many([o.config for o in obs])
    y = np.array([o.performance for o in obs])
    return make_forest(seed=seed, device=device).fit(X, y)


def eq2_similarity(
    space: ConfigSpace,
    source_model: Surrogate,
    target: TaskRecord,
    target_Xy: Optional[Tuple[np.ndarray, np.ndarray]] = None,
) -> Tuple[float, float]:
    """S(i,T) = KendallTau^{D_T}(M_i, Y)  (Eq. 2). Returns (tau, p).

    ``target_Xy`` lets callers that score many sources against the same
    target encode the target observations once (see SimilarityEngine).
    """
    if target_Xy is None:
        obs = target.full_fidelity()
        if len(obs) < 3:
            return 0.0, 1.0
        X = space.encode_many([o.config for o in obs])
        y = np.array([o.performance for o in obs])
    else:
        X, y = target_Xy
        if len(y) < 3:
            return 0.0, 1.0
    pred = source_model.predict_mean(X)
    return kendall_tau(pred, y)


class MetaSimilarityModel:
    """GBRT over concatenated meta-feature pairs (paper's LightGBM role).

    Trained on labels KendallTau^{D_rand}(M_i, M_j): agreement of the two
    source surrogates' predictions on random configurations.
    """

    def __init__(self, seed: int = 0, n_random: int = 64, device: DeviceLike = None):
        self.seed = seed
        self.n_random = n_random
        self.device = resolve_device(device)
        self.model: Optional[GradientBoostedTrees] = None

    @staticmethod
    def _pair_features(fi: np.ndarray, fj: np.ndarray) -> np.ndarray:
        # symmetric encoding: |diff| and elementwise product stabilize learning
        return np.concatenate([np.abs(fi - fj), fi * fj])

    def fit(self, space: ConfigSpace, kb: KnowledgeBase, task_ids: Sequence[str]) -> "MetaSimilarityModel":
        rng = np.random.default_rng(self.seed)
        tasks = [kb.get(t) for t in task_ids if kb.get(t).meta_features is not None]
        models: Dict[str, Surrogate] = {}
        for t in tasks:
            m = surrogate_for_task(space, t, seed=self.seed, device=self.device)
            if m is not None:
                models[t.task_id] = m
        tasks = [t for t in tasks if t.task_id in models]
        if len(tasks) < 2:
            return self
        Xrand = space.encode_many(space.sample(rng, self.n_random))
        feats, labels = [], []
        for i in range(len(tasks)):
            pi = models[tasks[i].task_id].predict_mean(Xrand)
            for j in range(len(tasks)):
                if i == j:
                    continue
                pj = models[tasks[j].task_id].predict_mean(Xrand)
                tau, _ = kendall_tau(pi, pj)
                feats.append(
                    self._pair_features(
                        np.asarray(tasks[i].meta_features), np.asarray(tasks[j].meta_features)
                    )
                )
                labels.append(tau)
        self.model = GradientBoostedTrees(seed=self.seed).fit(np.array(feats), np.array(labels))
        return self

    def predict(self, f_target: Sequence[float], f_source: Sequence[float]) -> float:
        if self.model is None:
            return 0.0
        x = self._pair_features(np.asarray(f_target, dtype=float), np.asarray(f_source, dtype=float))
        return float(self.model.predict(x[None, :])[0])


@dataclass
class TaskWeights:
    """Normalized transfer weights; target weight included under key ``__target__``."""

    weights: Dict[str, float]
    similarities: Dict[str, float]
    used_meta: bool  # True while the meta-feature predictor was in charge

    def for_task(self, task_id: str) -> float:
        return self.weights.get(task_id, 0.0)

    @property
    def source_ids(self) -> List[str]:
        return [k for k in self.weights if k != "__target__"]


class SimilarityEngine:
    """Implements §4.2 end-to-end: prediction warm start -> Eq. 2 -> weights."""

    def __init__(
        self,
        space: ConfigSpace,
        kb: KnowledgeBase,
        seed: int = 0,
        p_threshold: float = 0.05,
        cv_folds: int = 4,
        device: DeviceLike = None,
    ):
        self.space = space
        self.kb = kb
        self.seed = seed
        self.p_threshold = p_threshold
        self.cv_folds = cv_folds
        self.device = resolve_device(device)
        self.meta_model: Optional[MetaSimilarityModel] = None
        self._source_models: Dict[str, Surrogate] = {}

    # --------------------------------------------------------------- helpers
    def _ensure_meta_model(self, target: TaskRecord) -> None:
        if self.meta_model is not None:
            return
        ids = [t.task_id for t in self.kb.source_tasks(target.task_id)]
        self.meta_model = MetaSimilarityModel(seed=self.seed, device=self.device).fit(
            self.space, self.kb, ids
        )

    def source_model(self, task_id: str) -> Optional[Surrogate]:
        if task_id not in self._source_models:
            m = surrogate_for_task(
                self.space, self.kb.get(task_id), seed=self.seed, device=self.device
            )
            if m is None:
                return None
            self._source_models[task_id] = m
        return self._source_models[task_id]

    def target_self_weight(self, target: TaskRecord) -> float:
        """Out-of-sample Kendall tau of the target surrogate via k-fold CV."""
        obs = target.full_fidelity()
        if len(obs) < self.cv_folds + 1:
            return 0.0
        X = self.space.encode_many([o.config for o in obs])
        y = np.array([o.performance for o in obs])
        n = len(y)
        folds = np.arange(n) % self.cv_folds
        preds = np.zeros(n)
        for f in range(self.cv_folds):
            tr, te = folds != f, folds == f
            if tr.sum() < 2 or te.sum() < 1:
                return 0.0
            m = make_forest(seed=self.seed, device=self.device).fit(X[tr], y[tr])
            preds[te] = m.predict_mean(X[te])
        tau, _ = kendall_tau(preds, y)
        return max(tau, 0.0)

    # ------------------------------------------------------------------ main
    def compute(self, target: TaskRecord) -> TaskWeights:
        sources = self.kb.source_tasks(target.task_id)
        sims: Dict[str, float] = {}
        pvals: Dict[str, float] = {}
        # encode the target's observations once; every source model scores
        # the same matrix (the per-source re-encode was a per-knob loop)
        obs = target.full_fidelity()
        target_Xy = (
            (self.space.encode_many([o.config for o in obs]),
             np.array([o.performance for o in obs]))
            if len(obs) >= 3 else None
        )
        for s in sources:
            m = self.source_model(s.task_id)
            if m is None:
                continue
            tau, p = eq2_similarity(self.space, m, target, target_Xy=target_Xy)
            sims[s.task_id] = tau
            pvals[s.task_id] = p

        # transition mechanism: majority of sources significant -> trust Eq. 2
        n_sig = sum(1 for p in pvals.values() if p < self.p_threshold)
        use_eq2 = len(pvals) > 0 and n_sig > len(pvals) / 2

        if not use_eq2:
            # warm-start phase: predict similarity from meta-features
            if target.meta_features is not None:
                self._ensure_meta_model(target)
                for s in sources:
                    if s.task_id in sims or True:  # overwrite with predictions
                        if s.meta_features is not None and self.meta_model is not None:
                            sims[s.task_id] = self.meta_model.predict(
                                target.meta_features, s.meta_features
                            )
            # if no meta features either, fall back to whatever Eq. 2 gave us

        # filter negatives, normalize
        pos = {k: v for k, v in sims.items() if v > 0}
        self_w = self.target_self_weight(target)
        total = sum(pos.values()) + self_w
        weights: Dict[str, float] = {}
        if total > 0:
            for k, v in pos.items():
                weights[k] = v / total
            if self_w > 0:
                weights["__target__"] = self_w / total
        elif target.full_fidelity():
            weights["__target__"] = 1.0
        return TaskWeights(weights=weights, similarities=sims, used_meta=not use_eq2)
