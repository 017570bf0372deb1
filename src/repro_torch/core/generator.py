"""Candidate configuration generation (paper §6.2).

BO candidates come from a *combined* surrogate: one PRF per source task
plus one PRF per fidelity level of the current task. Because surrogate
output scales differ across tasks, acquisition (EI) scores are combined by
weighted rank aggregation R(x) = sum_i w_i R_i(x); the top-n by aggregate
rank are recommended. Candidate pool = random samples + mutations of the
current incumbents (OpenBox-style "sampling and mutation").

Two-phase warm start: Phase 1 picks the single best config of the most
similar source task for one immediate full-fidelity evaluation; Phase 2
maintains G_ws = union of better-than-median configs of all sources ranked
by v(.) (Eq. 3) and injects a few of them at the start of each SH inner
loop — as many as will survive to full fidelity, so they cannot evict each
other.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs as _obs
from ..device import DeviceLike, resolve_device
from .acquisition import (
    aggregate_ranks,
    get_acquisition_backend,
    get_acquisition_pool,
    score_sources,
)
from .knowledge import TaskRecord
from .similarity import TaskWeights, surrogate_for_task
from .space import ConfigBatch, ConfigSpace
from .surrogate import Surrogate, make_forest

Config = Dict[str, Any]

__all__ = [
    "CandidateColumns",
    "CandidateGenerator",
    "SurrogateStore",
    "WarmStartQueue",
    "phase1_config",
]


class CandidateColumns(Sequence):
    """Provisioned candidates: warm-start dicts + one columnar BO batch.

    Indexes like a list of Config dicts (what ``HyperbandRunner`` needs),
    but the BO rows stay columnar until first touched — and each row
    materializes at most once (memoized), so rung bookkeeping can reference
    candidates purely by index column across rungs without re-building
    dicts, and the batch's canonical value matrix / unit encoding remain
    available to downstream consumers (``.batch``).
    """

    __slots__ = ("head", "batch", "_limit", "_memo")

    def __init__(self, head: Sequence[Config], batch: ConfigBatch, limit: Optional[int] = None):
        self.head = list(head)
        self.batch = batch
        n = len(self.head) + len(batch)
        self._limit = n if limit is None else min(int(limit), n)
        self._memo: Dict[int, Config] = {}

    def __len__(self) -> int:
        return self._limit

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self[j] for j in range(*i.indices(len(self)))]
        i = int(i)
        if i < 0:
            i += self._limit
        if not 0 <= i < self._limit:
            raise IndexError(i)
        if i < len(self.head):
            return self.head[i]
        j = i - len(self.head)
        got = self._memo.get(j)
        if got is None:
            got = self.batch[j]
            self._memo[j] = got
        return got


def phase1_config(weights: TaskWeights, tasks: Dict[str, TaskRecord]) -> Optional[Config]:
    """Best config of the best similar source task (Phase 1 warm start)."""
    best_tid, best_sim = None, 0.0
    for tid, w in weights.weights.items():
        if tid != "__target__" and w > best_sim:
            best_tid, best_sim = tid, w
    if best_tid is None:
        return None
    best_obs = tasks[best_tid].best()
    return dict(best_obs.config) if best_obs else None


class WarmStartQueue:
    """Phase 2 warm start: ranked G_ws, consumed a few at a time."""

    def __init__(self):
        self._items: List[Tuple[float, Config]] = []
        self._served: set = set()

    def rebuild(self, weights: TaskWeights, tasks: Dict[str, TaskRecord]) -> None:
        items: List[Tuple[float, Config]] = []
        for tid, w in weights.weights.items():
            if tid == "__target__" or w <= 0 or tid not in tasks:
                continue
            obs = tasks[tid].full_fidelity()
            if len(obs) < 2:
                continue
            perf = np.array([o.performance for o in obs])
            f_med = float(np.median(perf))
            if f_med <= 0:
                continue
            for o in obs:
                if o.performance < f_med:
                    v = w * (f_med - o.performance) / f_med  # Eq. 3 priority
                    items.append((v, dict(o.config)))
        items.sort(key=lambda t: -t[0])
        self._items = items

    def take(self, n: int) -> List[Config]:
        out: List[Config] = []
        for v, cfg in self._items:
            key = tuple(sorted((k, repr(val)) for k, val in cfg.items()))
            if key in self._served:
                continue
            self._served.add(key)
            out.append(cfg)
            if len(out) >= n:
                break
        return out


@dataclass
class SurrogateSource:
    """A weighted surrogate participating in the combined ranking."""

    name: str
    model: Surrogate
    weight: float
    incumbent: float  # best observed value for its own data (EI reference)


class SurrogateStore:
    """Keyed surrogate cache with rung-to-rung reuse and LRU eviction.

    One entry per source name (``task:<tid>`` / ``fid:<delta>:<tid>``),
    fingerprinted by the observation count the model was fitted on: a
    fidelity surrogate is only refit when its rung gained observations, so
    evaluations at one Hyperband rung never invalidate the other rungs'
    models. Replacing a stale fingerprint drops the old model immediately;
    the LRU cap bounds memory across many tasks/brackets.
    """

    def __init__(self, max_entries: int = 64):
        self.max_entries = max_entries
        self._entries: "OrderedDict[str, Tuple[int, Surrogate, float]]" = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def __len__(self) -> int:
        return len(self._entries)

    def get(
        self,
        name: str,
        fingerprint: int,
        build: Callable[[], Optional[Tuple[Surrogate, float]]],
    ) -> Optional[Tuple[Surrogate, float]]:
        """Return the cached (model, incumbent) for ``name`` if its
        fingerprint still matches, else (re)build and cache it."""
        entry = self._entries.get(name)
        if entry is not None and entry[0] == fingerprint:
            self._entries.move_to_end(name)
            self.hits += 1
            return entry[1], entry[2]
        built = build()
        if built is None:
            return None
        self.misses += 1
        self._entries[name] = (fingerprint, built[0], built[1])
        self._entries.move_to_end(name)
        while len(self._entries) > self.max_entries:
            self._entries.popitem(last=False)
            self.evictions += 1
        return built


class CandidateGenerator:
    def __init__(
        self,
        space: ConfigSpace,
        seed: int = 0,
        pool_size: int = 256,
        cache_entries: int = 64,
        device: DeviceLike = None,
    ):
        self.space = space                # full space: defines the surrogate encoding
        self.sample_space = space         # possibly compressed: defines the sampling region
        self.seed = seed
        self.pool_size = pool_size
        self.device = resolve_device(device)  # where fitted surrogates score
        self._rng = np.random.default_rng(seed)
        self._store = SurrogateStore(max_entries=cache_entries)
        # encoded-exclusion cache: recommend is called once per bracket with
        # the (append-only, heavily overlapping) list of already-evaluated
        # configs; canonical row keys are cached per config-dict identity so
        # each config is encoded once per tuning run instead of per call.
        self._key_cache: Dict[int, bytes] = {}
        self._key_refs: List[Config] = []  # keeps dicts alive => ids stay valid
        self._propose_eng: Any = None  # lazy ProposeEngine

    def set_sample_space(self, space: ConfigSpace) -> None:
        """Install the compressed space; candidates are sampled from it and
        completed with defaults for dropped knobs before encoding."""
        self.sample_space = space

    @property
    def cache_stats(self) -> Dict[str, int]:
        s = self._store
        return {"hits": s.hits, "misses": s.misses, "evictions": s.evictions, "size": len(s)}

    # ------------------------------------------------------------ surrogates
    def build_sources(
        self,
        weights: TaskWeights,
        tasks: Dict[str, TaskRecord],
        target: TaskRecord,
        fidelities: Sequence[float],
    ) -> List[SurrogateSource]:
        sources: List[SurrogateSource] = []
        # historical tasks (cached: source observations are frozen, so the
        # fingerprint only changes if the task record itself grows)
        for tid, w in weights.weights.items():
            if tid == "__target__" or w <= 0 or tid not in tasks:
                continue

            def build_task(task=tasks[tid], tid=tid):
                with _obs.span("surrogate_fit", source=f"task:{tid}",
                               n_obs=len(task.observations)):
                    m = surrogate_for_task(
                        self.space, task, seed=self.seed, device=self.device
                    )
                    if m is None:
                        return None
                    obs = task.full_fidelity()
                    return m, (min(o.performance for o in obs) if obs else 0.0)

            got = self._store.get(f"task:{tid}", len(tasks[tid].observations), build_task)
            if got is None:
                continue
            sources.append(
                SurrogateSource(name=f"task:{tid}", model=got[0], weight=w, incumbent=got[1])
            )
        # current task, one surrogate per fidelity level with observations;
        # rung-to-rung reuse: only the rung whose observation count changed
        # is refit, the other fidelity surrogates come from the store
        w_t = weights.weights.get("__target__", 0.0)
        for d in fidelities:
            all_obs = target.at_fidelity(d, include_failed=True)
            ok_obs = [o for o in all_obs if not o.failed]
            if len(ok_obs) < 2:
                continue

            def build_fid(all_obs=all_obs, ok_obs=ok_obs, d=d):
                # failed evaluations (OOM / early-stop) enter the fit at a
                # crash-cost penalty instead of being hidden: with log-space
                # sampling a large pool fraction can sit in the failure
                # region, and a surrogate that never sees failures keeps
                # recommending into it (SMAC-style imputation)
                with _obs.span("surrogate_fit", source=f"fid:{d:.3f}",
                               n_obs=len(all_obs)):
                    penalty = 2.0 * max(o.performance for o in ok_obs)
                    X = self.space.encode_many([o.config for o in all_obs])
                    y = np.array(
                        [penalty if o.failed else o.performance for o in all_obs]
                    )
                    m = make_forest(seed=self.seed, device=self.device).fit(X, y)
                    return m, float(min(o.performance for o in ok_obs))

            got = self._store.get(f"fid:{d:.6f}:{target.task_id}", len(all_obs), build_fid)
            if got is None:
                continue
            # full fidelity of the target carries the target weight; lower
            # fidelities share it, scaled by their level (closer to full =
            # more trustworthy), mirroring MFES-style fidelity weighting.
            wt = w_t * (d if w_t > 0 else 0.0)
            if w_t <= 0:
                # with no established target weight (early phase) the current
                # task's own data is still the only guidance; give it mass.
                wt = d
            sources.append(
                SurrogateSource(name=f"fid:{d:.3f}", model=got[0], weight=wt, incumbent=got[1])
            )
        return sources

    # ------------------------------------------------------------- candidates
    def _candidate_pool(self, incumbents: Sequence[Config]) -> ConfigBatch:
        """Random samples + incumbent mutations as one columnar batch.

        Sampling and mutation run in the (possibly compressed) sample space;
        the batch is then lifted into the full space (dropped knobs take
        full-space defaults) so every candidate is a valid configuration —
        all without materializing Config dicts.
        """
        ss = self.sample_space
        n_mut = min(self.pool_size // 4, 16 * max(len(incumbents), 1))
        with _obs.span("pool_gen", pool_size=self.pool_size,
                       mutations=n_mut if incumbents else 0):
            pool = ss.sample(self._rng, self.pool_size - n_mut if incumbents else self.pool_size)
            proj = None
            if incumbents:
                bases = ConfigBatch.from_configs(
                    ss, [incumbents[i % len(incumbents)] for i in range(n_mut)]
                )
                proj = ss.project_many(bases)
                muts = ss.mutate_many(proj, self._rng)
                pool = ConfigBatch.concat([pool, muts])
            full = self.space.complete_batch(pool)
            return full

    def _config_keys(self, cfgs: Sequence[Config]) -> List[bytes]:
        """Canonical row keys for config dicts, cached per dict identity."""
        out: List[Optional[bytes]] = []
        missing: List[Config] = []
        missing_pos: List[int] = []
        for c in cfgs:
            k = self._key_cache.get(id(c))
            if k is None:
                missing.append(c)
                missing_pos.append(len(out))
            out.append(k)
        if missing:
            keys = ConfigBatch.from_configs(self.space, missing).row_keys()
            if len(self._key_refs) > 8192:  # bound memory across long runs
                self._key_cache.clear()
                self._key_refs.clear()
            for c, key, pos in zip(missing, keys, missing_pos):
                self._key_cache[id(c)] = key
                self._key_refs.append(c)
                out[pos] = key
        return out  # type: ignore[return-value]

    def recommend(
        self,
        n: int,
        sources: Sequence[SurrogateSource],
        incumbents: Sequence[Config] = (),
        exclude: Sequence[Config] = (),
    ) -> List[Config]:
        """Top-n candidates by weighted rank-aggregated EI (§6.2).

        The pool stays columnar end-to-end: one unit-cube encoding, uploaded
        once, feeds all sources in a fused device pass (shared packed-forest
        descent + EI matrix + rank aggregation); only the returned top-n
        materialize as dicts. With the ``fused`` acquisition backend the
        fused propose step (``core/propose.py``) takes the call instead.
        """
        active = [s for s in sources if s.weight > 0]
        return self._recommend_pool_batch(n, active, incumbents, exclude).materialize()

    def recommend_batch(
        self,
        n: int,
        sources: Sequence[SurrogateSource],
        incumbents: Sequence[Config] = (),
        exclude: Sequence[Config] = (),
    ) -> ConfigBatch:
        """``recommend`` returning the top-n as one columnar ``ConfigBatch``.

        Identical selection (materializing the batch yields the same dicts
        in the same order as ``recommend``), but no dict materialization —
        rung-table provisioning consumes the index columns directly.
        """
        active = [s for s in sources if s.weight > 0]
        return self._recommend_pool_batch(n, active, incumbents, exclude)

    # -------------------------------------------------------- fused propose
    @property
    def propose_engine(self):
        """The lazy :class:`ProposeEngine` of this generator."""
        if self._propose_eng is None:
            from .propose import ProposeEngine

            self._propose_eng = ProposeEngine(self.space, seed=self.seed,
                                              pool_size=self.pool_size)
        return self._propose_eng

    def _exclude(self, pool: ConfigBatch, exclude: Sequence[Config]) -> ConfigBatch:
        """``pool`` without the rows of ``exclude`` (exact canonical row
        match; the exclusion keys are cached across calls)."""
        if len(exclude):
            seen = set(self._config_keys(exclude))
            keep = np.array([k not in seen for k in pool.row_keys()], dtype=bool)
            if keep.any() and not keep.all():
                pool = pool.take(np.flatnonzero(keep))
        return pool

    def _recommend_fused(
        self,
        n: int,
        active: Sequence[SurrogateSource],
        incumbents: Sequence[Config],
        exclude: Sequence[Config],
    ) -> Optional[ConfigBatch]:
        """The recommend call through the fused propose step, or None where
        it does not apply (sources that are not fitted PRFs of one tree
        count), so the staged path takes it. Pool mode ``host`` scores the
        generator's own pool (deduplicated against ``exclude``): the
        selection is the staged path's bit for bit. Pool mode ``device``
        draws the pool on the device and decodes the top n + margin rows,
        dropping the excluded ones (other draws than the host pool's)."""
        eng = self.propose_engine
        models = [s.model for s in active]
        if not eng.fusable(models):
            return None
        incs = [s.incumbent for s in active]
        ws = [s.weight for s in active]
        if get_acquisition_pool() == "host":
            pool = self._exclude(self._candidate_pool(incumbents), exclude)
            return pool.take(eng.score_topk(models, pool.unit(), incs, ws, n))
        _, units, _ = eng.propose(models, incs, ws, n, sample_space=self.sample_space)
        batch = self.space.decode_many(units)
        if not len(exclude):
            return batch.take(np.arange(min(n, len(batch))))
        seen = set(self._config_keys(exclude))
        keep = [i for i, key in enumerate(batch.row_keys()) if key not in seen][:n]
        return batch.take(np.asarray(keep, dtype=np.int64))

    def _recommend_pool_batch(
        self,
        n: int,
        active: Sequence[SurrogateSource],
        incumbents: Sequence[Config],
        exclude: Sequence[Config],
    ) -> ConfigBatch:
        """Staged path: host pool → dedup → device score → stable top-n (or
        the fused step, where the backend is ``fused`` and it applies)."""
        if active and get_acquisition_backend() == "fused":
            got = self._recommend_fused(n, active, incumbents, exclude)
            if got is not None:
                return got
        pool = self._exclude(self._candidate_pool(incumbents), exclude)
        if not active:
            order = self._rng.permutation(len(pool))
            return pool.take(order[:n])
        with _obs.span("acquisition", pool=len(pool), sources=len(active), k=n):
            X = pool.unit_tensor(self.device)
            scores = score_sources([s.model for s in active], X,
                                   [s.incumbent for s in active])
            agg = aggregate_ranks(scores, [s.weight for s in active]).cpu().numpy()
            order = np.argsort(agg, kind="stable")
            return pool.take(order[:n])
