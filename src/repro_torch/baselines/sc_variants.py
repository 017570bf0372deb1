"""Search-space-compression strategy baselines (paper §7.4.2, Fig. 6).

Each is a callable with the ``MFTuneOptions.compressor`` signature
``(space, weights, tasks, target) -> ConfigSpace`` so it can replace
MFTune's density-based SC component in-place:

  Box      (Perrone et al. '19): minimal axis-aligned box containing the
           best observed config of every previous task.
  Decrease (Tuneful): every 10 target observations, drop 40% of remaining
           knobs by importance rank; no range compression.
  Project  (LlamaTune/TopTune): dimensionality reduction to a random knob
           subset with bucketized (quantized) ranges.
  Vote     (OpAdvisor): per knob, each source votes the [min,max] boundary
           box of its better-than-median configs; the range with majority
           weighted votes wins. Sensitive to outliers by construction.

Port of ``repro.baselines.sc_variants``. Box, Project and Vote are host
numpy over the knowledge base's records. Decrease fits the target's forest
on ``device`` (default the CUDA card) and scores all of its permuted
copies in one prediction (one K1 launch on the card).
"""

from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np

from ..core.knowledge import TaskRecord
from ..core.similarity import TaskWeights, surrogate_for_task
from ..core.space import BoolKnob, CatKnob, ConfigSpace, FloatKnob, IntKnob, Intervals
from ..device import DeviceLike, resolve_device
from .common import permutation_importance

__all__ = ["BoxCompressor", "DecreaseCompressor", "ProjectCompressor", "VoteCompressor"]


def _good_configs(task: TaskRecord) -> List[dict]:
    obs = task.full_fidelity()
    if len(obs) < 2:
        return []
    perf = np.array([o.performance for o in obs])
    med = float(np.median(perf))
    return [o.config for o in obs if o.performance < med]


class BoxCompressor:
    def __call__(self, space: ConfigSpace, weights: TaskWeights, tasks: Dict[str, TaskRecord],
                 target: Optional[TaskRecord] = None) -> ConfigSpace:
        bests = []
        for t in tasks.values():
            b = t.best()
            if b is not None:
                bests.append(b.config)
        if not bests:
            return space
        ranges: Dict[str, Intervals] = {}
        cat_subsets: Dict[str, List[Any]] = {}
        for knob in space.knobs:
            vals = [c.get(knob.name, knob.default_value()) for c in bests]
            if isinstance(knob, (FloatKnob, IntKnob)):
                ranges[knob.name] = Intervals([(float(min(vals)), float(max(vals)))])
            else:
                cat_subsets[knob.name] = sorted(set(vals), key=repr)
        return space.restrict(ranges=ranges, cat_subsets=cat_subsets)


class DecreaseCompressor:
    def __init__(self, every: int = 10, drop_frac: float = 0.4, min_knobs: int = 10, seed: int = 0,
                 device: DeviceLike = None):
        self.device = resolve_device(device)
        self.every = every
        self.drop_frac = drop_frac
        self.min_knobs = min_knobs
        self.seed = seed
        self._keep: Optional[List[str]] = None
        self._last_n = 0

    def __call__(self, space: ConfigSpace, weights: TaskWeights, tasks: Dict[str, TaskRecord],
                 target: Optional[TaskRecord] = None) -> ConfigSpace:
        if target is None:
            return space
        obs = target.full_fidelity()
        n = len(obs)
        if self._keep is None:
            self._keep = list(space.names)
        if n >= self.every and n // self.every > self._last_n // self.every and len(self._keep) > self.min_knobs:
            model = surrogate_for_task(space, target, seed=self.seed, device=self.device)
            if model is not None:
                X = space.encode_many([o.config for o in obs])
                rng = np.random.default_rng(self.seed)
                cols = [space.names.index(name) for name in self._keep]
                imp = dict(zip(self._keep,
                               permutation_importance(model, X, cols, rng).tolist()))
                keep_n = max(int(len(self._keep) * (1 - self.drop_frac)), self.min_knobs)
                self._keep = sorted(imp, key=lambda k: -imp[k])[:keep_n]
        self._last_n = n
        return space.restrict(keep=self._keep)


class ProjectCompressor:
    def __init__(self, d_low: int = 16, n_buckets: int = 16, seed: int = 0):
        self.d_low = d_low
        self.n_buckets = n_buckets
        self.seed = seed

    def __call__(self, space: ConfigSpace, weights: TaskWeights, tasks: Dict[str, TaskRecord],
                 target: Optional[TaskRecord] = None) -> ConfigSpace:
        rng = np.random.default_rng(self.seed)  # fixed projection across calls
        keep = list(rng.choice(space.names, size=min(self.d_low, len(space.names)), replace=False))
        ranges: Dict[str, Intervals] = {}
        for knob in space.knobs:
            if knob.name not in keep or not isinstance(knob, (FloatKnob, IntKnob)):
                continue
            # bucketized range: quantize into n_buckets cells (keeps full span
            # but coarse — "lacks granularity to exclude low-potential subspaces")
            edges = np.linspace(float(knob.lo), float(knob.hi), self.n_buckets + 1)
            ranges[knob.name] = Intervals([(float(edges[0]), float(edges[-1]))])
        return space.restrict(keep=keep, ranges=ranges)


class VoteCompressor:
    def __init__(self, vote_threshold: float = 0.5):
        self.vote_threshold = vote_threshold

    def __call__(self, space: ConfigSpace, weights: TaskWeights, tasks: Dict[str, TaskRecord],
                 target: Optional[TaskRecord] = None) -> ConfigSpace:
        boxes: List[tuple] = []  # (weight, {knob: (lo, hi) or set})
        for tid, w in weights.weights.items():
            rec = tasks.get(tid) if tid != "__target__" else target
            if rec is None or w <= 0:
                continue
            good = _good_configs(rec)
            if not good:
                continue
            box: Dict[str, Any] = {}
            for knob in space.knobs:
                vals = [c.get(knob.name, knob.default_value()) for c in good]
                if isinstance(knob, (FloatKnob, IntKnob)):
                    box[knob.name] = (float(min(vals)), float(max(vals)))
                else:
                    box[knob.name] = set(map(repr, vals))
            boxes.append((w, box))
        if not boxes:
            return space
        total_w = sum(w for w, _ in boxes)
        ranges: Dict[str, Intervals] = {}
        cat_subsets: Dict[str, List[Any]] = {}
        for knob in space.knobs:
            if isinstance(knob, (FloatKnob, IntKnob)):
                # grid votes: a cell is kept if boxes covering it weigh > threshold
                grid = np.linspace(float(knob.lo), float(knob.hi), 65)
                mids = 0.5 * (grid[:-1] + grid[1:])
                votes = np.zeros(len(mids))
                for w, box in boxes:
                    lo, hi = box[knob.name]
                    votes += w * ((mids >= lo) & (mids <= hi))
                keep_cells = votes / total_w >= self.vote_threshold
                if keep_cells.any():
                    ivs = []
                    i = 0
                    while i < len(mids):
                        if keep_cells[i]:
                            j = i
                            while j + 1 < len(mids) and keep_cells[j + 1]:
                                j += 1
                            ivs.append((float(grid[i]), float(grid[j + 1])))
                            i = j + 1
                        else:
                            i += 1
                    ranges[knob.name] = Intervals(ivs)
            else:
                counts: Dict[str, float] = {}
                for w, box in boxes:
                    for v in box[knob.name]:
                        counts[v] = counts.get(v, 0.0) + w
                kept_reprs = {v for v, cw in counts.items() if cw / total_w >= self.vote_threshold}
                if kept_reprs:
                    choices = knob.active_choices() if hasattr(knob, "active_choices") else (False, True)
                    kept = [c for c in choices if repr(c) in kept_reprs]
                    if kept:
                        cat_subsets[knob.name] = kept
        return space.restrict(ranges=ranges, cat_subsets=cat_subsets)
