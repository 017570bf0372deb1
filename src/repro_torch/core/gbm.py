"""Gradient-boosted regression trees (LightGBM stand-in, paper §4.2).

Used only for the meta-feature pairwise-similarity regressor that
warm-starts similarity identification. Least-squares boosting with
shallow CART trees and shrinkage; numpy-only.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .surrogate import RegressionTree

__all__ = ["GradientBoostedTrees"]


class GradientBoostedTrees:
    def __init__(
        self,
        n_estimators: int = 60,
        learning_rate: float = 0.1,
        max_depth: int = 3,
        subsample: float = 0.8,
        min_samples_leaf: int = 2,
        seed: int = 0,
    ):
        self.n_estimators = n_estimators
        self.learning_rate = learning_rate
        self.max_depth = max_depth
        self.subsample = subsample
        self.min_samples_leaf = min_samples_leaf
        self.seed = seed
        self.trees: List[RegressionTree] = []
        self.base_: float = 0.0

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GradientBoostedTrees":
        X = np.atleast_2d(np.asarray(X, dtype=float))
        y = np.asarray(y, dtype=float)
        rng = np.random.default_rng(self.seed)
        self.base_ = float(y.mean()) if len(y) else 0.0
        pred = np.full(len(y), self.base_)
        self.trees = []
        n = len(y)
        for _ in range(self.n_estimators):
            resid = y - pred
            if np.abs(resid).max() < 1e-12:
                break
            m = max(2, int(self.subsample * n))
            idx = rng.choice(n, size=m, replace=False) if m < n else np.arange(n)
            tree = RegressionTree(
                max_depth=self.max_depth,
                min_samples_split=2 * self.min_samples_leaf,
                min_samples_leaf=self.min_samples_leaf,
                max_features=X.shape[1],
                rng=np.random.default_rng(rng.integers(2**63)),
            )
            tree.fit(X[idx], resid[idx])
            step, _ = tree.predict(X)
            pred = pred + self.learning_rate * step
            self.trees.append(tree)
        return self

    def predict(self, X: np.ndarray) -> np.ndarray:
        X = np.atleast_2d(np.asarray(X, dtype=float))
        pred = np.full(len(X), self.base_)
        for tree in self.trees:
            step, _ = tree.predict(X)
            pred = pred + self.learning_rate * step
        return pred
