"""Weighted kernel density estimation and minimal α-mass regions (paper §5.2).

Continuous knobs: Gaussian-kernel weighted KDE (Eq. 4) with Silverman's
rule-of-thumb bandwidth; the promising range is the *smallest* union of
grid cells capturing at least α of the probability mass (Eq. 5), returned
as a union of closed intervals.

Categorical knobs: the discrete analogue (Eq. 6) — normalized weighted
frequencies; the promising subset is the smallest set of categories whose
cumulative mass reaches α.
"""

from __future__ import annotations

from typing import Any, Dict, List, Sequence, Tuple

import numpy as np

from .space import Intervals

__all__ = [
    "silverman_bandwidth",
    "WeightedKDE",
    "alpha_mass_region",
    "alpha_mass_categories",
]


def silverman_bandwidth(samples: np.ndarray, weights: np.ndarray) -> float:
    """Silverman's rule of thumb with weighted moments.

    h = 0.9 * min(sigma, IQR/1.34) * n_eff^{-1/5}, with Kish effective
    sample size for weighted data.
    """
    samples = np.asarray(samples, dtype=float)
    weights = np.asarray(weights, dtype=float)
    w = weights / weights.sum()
    mu = float((w * samples).sum())
    sigma = float(np.sqrt(max((w * (samples - mu) ** 2).sum(), 1e-18)))
    # weighted IQR via weighted quantiles
    order = np.argsort(samples)
    cw = np.cumsum(w[order])
    q25 = samples[order][np.searchsorted(cw, 0.25)]
    q75 = samples[order][np.searchsorted(cw, min(0.75, cw[-1] - 1e-12))]
    iqr = float(q75 - q25)
    spread = min(sigma, iqr / 1.34) if iqr > 0 else sigma
    n_eff = float(weights.sum() ** 2 / np.maximum((weights**2).sum(), 1e-18))
    h = 0.9 * spread * n_eff ** (-0.2)
    if not np.isfinite(h) or h <= 0:
        h = max(1e-3 * (samples.max() - samples.min()), 1e-9)
    return float(h)


class WeightedKDE:
    """Gaussian weighted KDE, Eq. 4."""

    def __init__(self, samples: Sequence[float], weights: Sequence[float], bandwidth: float | None = None):
        self.samples = np.asarray(samples, dtype=float)
        self.weights = np.asarray(weights, dtype=float)
        if len(self.samples) == 0:
            raise ValueError("empty KDE")
        if self.weights.sum() <= 0:
            self.weights = np.ones_like(self.samples)
        self.h = bandwidth if bandwidth is not None else silverman_bandwidth(self.samples, self.weights)

    def __call__(self, x: np.ndarray) -> np.ndarray:
        x = np.atleast_1d(np.asarray(x, dtype=float))
        z = (x[:, None] - self.samples[None, :]) / self.h
        k = np.exp(-0.5 * z**2) / np.sqrt(2 * np.pi)
        dens = (self.weights[None, :] * k).sum(axis=1) / (self.h * self.weights.sum())
        return dens


def alpha_mass_region(
    kde: WeightedKDE,
    lo: float,
    hi: float,
    alpha: float,
    grid_size: int = 512,
) -> Intervals:
    """Smallest union of grid cells with cumulative density mass >= alpha.

    Implements the solution procedure of Eq. 5: evaluate g-hat on a grid,
    sort cells by density descending, accumulate mass until alpha is
    reached, return the covered cells merged into intervals.
    """
    if hi <= lo:
        return Intervals([(lo, hi)])
    edges = np.linspace(lo, hi, grid_size + 1)
    mids = 0.5 * (edges[:-1] + edges[1:])
    dens = kde(mids)
    cell_mass = dens * (edges[1] - edges[0])
    total = cell_mass.sum()
    if total <= 0:
        return Intervals([(lo, hi)])
    mass = cell_mass / total
    order = np.argsort(-dens, kind="stable")
    cum = np.cumsum(mass[order])
    k = int(np.searchsorted(cum, alpha)) + 1
    chosen = np.zeros(grid_size, dtype=bool)
    chosen[order[:k]] = True
    # merge chosen cells into intervals
    ivs: List[Tuple[float, float]] = []
    i = 0
    while i < grid_size:
        if chosen[i]:
            j = i
            while j + 1 < grid_size and chosen[j + 1]:
                j += 1
            ivs.append((float(edges[i]), float(edges[j + 1])))
            i = j + 1
        else:
            i += 1
    return Intervals(ivs)


def alpha_mass_categories(
    values: Sequence[Any], weights: Sequence[float], alpha: float
) -> List[Any]:
    """Discrete analogue, Eq. 6: smallest category set with mass >= alpha."""
    mass: Dict[Any, float] = {}
    for v, w in zip(values, weights):
        mass[v] = mass.get(v, 0.0) + float(w)
    total = sum(mass.values())
    if total <= 0:
        return list(mass.keys())
    items = sorted(mass.items(), key=lambda kv: -kv[1])
    out, cum = [], 0.0
    for v, m in items:
        out.append(v)
        cum += m / total
        if cum >= alpha:
            break
    return out
