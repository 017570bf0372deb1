"""Density-based search-space compression (paper §5).

Step 1 (§5.1): per source task, promising configs G_i = better-than-median;
SHAP attributions over the source surrogate decide which knob *values*
helped (negative attribution on latency); each kept value carries weight
v(x) = w_i * (f_med - f(x)) / f_med   (Eq. 3).

Step 2 (§5.2): a knob whose promising set is weighted-majority-empty is
dropped (sum_i w_i * 1[P_j^i = empty] > 0.5); otherwise the union of
promising value sets feeds a weighted KDE whose minimal alpha-mass region
becomes the knob's restricted range (Eq. 4-5); categoricals use the
discrete analogue (Eq. 6).

The compressed space adapts every iteration as similarities sharpen.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs as _obs
from ..device import DeviceLike, resolve_device
from .kde import WeightedKDE, alpha_mass_categories, alpha_mass_region
from .knowledge import TaskRecord
from .shapley import shapley_values_batch
from .similarity import TaskWeights, surrogate_for_task
from .space import BoolKnob, CatKnob, ConfigSpace, FloatKnob, IntKnob, Intervals

__all__ = ["PromisingRegion", "extract_promising_regions", "compress_space", "SpaceCompressor"]


@dataclass
class PromisingRegion:
    """Per-task promising value sets: knob name -> list of (value, weight)."""

    task_id: str
    weight: float
    values: Dict[str, List[Tuple[Any, float]]] = field(default_factory=dict)
    n_good: int = 0
    importance: Dict[str, float] = field(default_factory=dict)  # sum |phi_j|

    def is_empty(self, knob: str, share_floor: float = 0.5) -> bool:
        """The paper's P_j = {} drop criterion, smoothed: a knob counts as
        empty for this task if no promising values were attributed to it OR
        its aggregate |SHAP| share is below ``share_floor``x the uniform
        share (exact-zero attributions are rare with a sampled explainer,
        so literal emptiness almost never fires; see DESIGN.md §9)."""
        if not self.values.get(knob):
            return True
        total = sum(self.importance.values())
        if total <= 0:
            return False
        share = self.importance.get(knob, 0.0) / total
        return share < share_floor / max(len(self.importance), 1)


def extract_promising_regions(
    space: ConfigSpace,
    task: TaskRecord,
    task_weight: float,
    seed: int = 0,
    n_permutations: int = 16,
    max_configs: int = 32,
    device: DeviceLike = None,
) -> Optional[PromisingRegion]:
    """§5.1 for one source task (or the target acting as its own source).

    All promising configs are explained in one batched masked-evaluation
    pass (``shapley_values_batch``). The source surrogate is fitted for ``device``, where its Shapley
    chains are walked (kernel K3).
    """
    obs = task.full_fidelity()
    if len(obs) < 4:
        return None
    perf = np.array([o.performance for o in obs])
    f_med = float(np.median(perf))
    if f_med <= 0:
        return None
    good = [o for o in obs if o.performance < f_med]
    if not good:
        return None
    # cap SHAP cost: explain the best configs first
    good = sorted(good, key=lambda o: o.performance)[:max_configs]

    model = surrogate_for_task(space, task, seed=seed, device=device)
    if model is None:
        return None
    X_all = space.encode_many([o.config for o in obs])
    # independent child streams for the background subsample and the Shapley
    # permutation draws — seeding both with the raw `seed` made them the
    # *same* stream, coupling the background choice to the permutations
    bg_seed, perm_seed = np.random.SeedSequence(seed).spawn(2)
    bg_rng = np.random.default_rng(bg_seed)
    background = X_all if len(X_all) <= 16 else X_all[bg_rng.choice(len(X_all), 16, replace=False)]
    f = lambda Z: model.predict_mean(Z)

    region = PromisingRegion(task_id=task.task_id, weight=task_weight, n_good=len(good))
    rng = np.random.default_rng(perm_seed)
    X_good = space.encode_many([o.config for o in good])  # one columnar pass
    with _obs.span("shapley_attribution", task=task.task_id,
                   n_configs=len(good), perms=n_permutations):
        phis = shapley_values_batch(
            f, X_good, background, n_permutations=n_permutations, rng=rng,
            model=model,
        )
    # Eq. 3 keeps values with negative SHAP. We additionally require the
    # attribution to clear a noise floor (5% of the config's largest
    # |phi|): irrelevant knobs fluctuate around +-eps and would otherwise
    # never be dropped by the majority-empty rule (DESIGN.md §9). Note the
    # proportional residual correction in `shapley_values_batch` keeps a knob the
    # surrogate ignores at phi == 0.0 exactly (the old uniform resid/d
    # spread pushed such knobs past this floor and let them dodge the
    # majority-empty drop rule).
    abs_phis = np.abs(phis)
    thrs = np.where(abs_phis.max(axis=1) > 0, 0.05 * abs_phis.max(axis=1), 0.0)
    names = [k.name for k in space.knobs]
    region.importance = dict(zip(names, abs_phis.sum(axis=0).astype(float)))
    for phi, thr, o in zip(phis, thrs, good):
        v = task_weight * (f_med - o.performance) / f_med  # Eq. 3 weight
        for j in np.flatnonzero(phi < -thr):  # value significantly reduced latency
            knob = space.knobs[j]
            region.values.setdefault(knob.name, []).append(
                (o.config.get(knob.name, knob.default_value()), float(v))
            )
    # ensure every knob key exists (possibly empty) so the drop rule sees it
    for knob in space.knobs:
        region.values.setdefault(knob.name, [])
    return region


def compress_space(
    space: ConfigSpace,
    regions: Sequence[PromisingRegion],
    alpha: float = 0.65,
    drop_threshold: float = 0.5,
    min_points_for_kde: int = 3,
    range_cache: Optional["OrderedDict"] = None,
) -> ConfigSpace:
    """§5.2: knob drop rule + KDE range compression -> new ConfigSpace.

    ``range_cache`` (an OrderedDict managed by :class:`SpaceCompressor`)
    memoizes the per-knob KDE fit + alpha-mass region keyed by the exact
    (knob, alpha, promising pairs) fingerprint: source-task regions are
    frozen and task weights are stable between weight refreshes, so
    successive compression calls mostly re-derive identical unions.
    """
    if not regions:
        return space
    total_w = sum(r.weight for r in regions)
    if total_w <= 0:
        return space

    keep: List[str] = []
    ranges: Dict[str, Intervals] = {}
    cat_subsets: Dict[str, Sequence[Any]] = {}

    for knob in space.knobs:
        empty_mass = sum(r.weight for r in regions if r.is_empty(knob.name)) / total_w
        if empty_mass > drop_threshold:
            continue  # knob not worth tuning (paper's drop rule)
        keep.append(knob.name)

        # P_j = union over tasks (Eq. union in §5.2)
        pairs: List[Tuple[Any, float]] = []
        for r in regions:
            pairs.extend(r.values.get(knob.name, []))
        if not pairs:
            continue
        vals = [p[0] for p in pairs]
        wts = [max(p[1], 1e-9) for p in pairs]

        key = None
        if range_cache is not None:
            key = (knob.name, float(alpha), tuple(vals), tuple(wts))
            hit = range_cache.get(key)
            if hit is not None:
                _obs.count("kde_cache/hits")
                range_cache.move_to_end(key)
                kind, payload = hit
                if kind == "range":
                    ranges[knob.name] = payload
                elif kind == "cats":
                    cat_subsets[knob.name] = payload
                continue  # "skip" payloads re-derive nothing
            _obs.count("kde_cache/misses")

        if isinstance(knob, (FloatKnob, IntKnob)):
            xs = np.asarray(vals, dtype=float)
            if len(xs) < min_points_for_kde or np.ptp(xs) == 0:
                entry = ("skip", None)  # too little signal; keep the full range
            else:
                kde = WeightedKDE(xs, np.asarray(wts))
                region = alpha_mass_region(kde, float(knob.lo), float(knob.hi), alpha)
                ranges[knob.name] = region
                entry = ("range", region)
        elif isinstance(knob, (CatKnob, BoolKnob)):
            kept = alpha_mass_categories(vals, wts, alpha)
            cat_subsets[knob.name] = kept
            entry = ("cats", kept)
        else:
            entry = ("skip", None)
        if range_cache is not None and key is not None:
            range_cache[key] = entry
            while len(range_cache) > _RANGE_CACHE_MAX:
                range_cache.popitem(last=False)

    return space.restrict(keep=keep, ranges=ranges, cat_subsets=cat_subsets)


_RANGE_CACHE_MAX = 512


class SpaceCompressor:
    """Stateful wrapper used by the controller: caches per-task regions.

    Regions for *source* tasks depend only on (task observations, weight);
    observations of historical tasks are frozen, so regions are cached and
    only re-scaled when weights change. The target task's own region is
    recomputed as its observation set grows. KDE fits / alpha-mass regions
    are additionally memoized across ``compress`` calls (see
    ``compress_space``'s ``range_cache``).
    """

    def __init__(
        self,
        space: ConfigSpace,
        alpha: float = 0.65,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.space = space
        self.alpha = alpha
        self.seed = seed
        self.device = resolve_device(device)
        self._cache: Dict[str, PromisingRegion] = {}
        self._range_cache: "OrderedDict" = OrderedDict()

    def _region(self, task: TaskRecord, weight: float, refresh: bool = False) -> Optional[PromisingRegion]:
        _obs.count(
            "region_cache/misses"
            if refresh or task.task_id not in self._cache
            else "region_cache/hits"
        )
        if refresh or task.task_id not in self._cache:
            # drop any stale entry *before* recomputing: if the recompute
            # returns None (e.g. the target briefly falls below 4 full-
            # fidelity observations) the old region must not survive to be
            # silently served by the next non-refresh call
            self._cache.pop(task.task_id, None)
            r = extract_promising_regions(
                self.space, task, 1.0, seed=self.seed, device=self.device,
            )
            if r is None:
                return None
            self._cache[task.task_id] = r
        base = self._cache[task.task_id]
        # re-scale cached unit-weight region by the current task weight
        scaled = PromisingRegion(task_id=base.task_id, weight=weight, n_good=base.n_good,
                                 importance=dict(base.importance))
        for k, pairs in base.values.items():
            scaled.values[k] = [(v, w * weight) for v, w in pairs]
        return scaled

    def compress(
        self,
        weights: TaskWeights,
        tasks: Dict[str, TaskRecord],
        target: Optional[TaskRecord] = None,
    ) -> ConfigSpace:
        regions: List[PromisingRegion] = []
        for tid, w in weights.weights.items():
            if w <= 0:
                continue
            if tid == "__target__":
                if target is not None:
                    r = self._region(target, w, refresh=True)
                    if r:
                        regions.append(r)
            elif tid in tasks:
                r = self._region(tasks[tid], w)
                if r:
                    regions.append(r)
        if not regions:
            return self.space
        return compress_space(
            self.space, regions, alpha=self.alpha, range_cache=self._range_cache
        )
