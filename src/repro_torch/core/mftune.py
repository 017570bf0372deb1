"""MFTune controller (paper §4.1 workflow, §6.3 MFO process).

Per-iteration workflow (Fig. 2):
  (1) similarity of source tasks vs. the current task (meta-feature
      prediction early, Eq. 2 after the transition mechanism fires),
  (2) density-based search-space compression from similar-task observations,
  (3) candidate generation = two-phase warm start + combined-rank BO,
  (4) multi-fidelity evaluation via Hyperband successive halving over
      query-subset proxies (Alg. 2), with median-cost early stopping —
      each rung's survivors are evaluated in one batched
      ``Workload.evaluate_many`` call (the vectorized sparksim grid path),
  (5) results recorded into the knowledge base.

Degradation paths (§6.3): with no same-query-set history, run full-fidelity
BO (with transfer + compression) until the transition mechanism admits the
current task as a source for fidelity partitioning; with no history at all,
start as vanilla BO and self-transfer once enough observations accumulate.

Ablation switches reproduce the paper's variants: w/o MF, data-volume or
early-stop proxies (Fig. 5a), SC strategy replacement (Fig. 6), and the
warm-start phase grid (Table 3).

Port of ``repro.core.mftune``: the controller is the reference's host
loop; ``device`` (default the CUDA card) reaches every surrogate it builds,
so surrogate descent (K1), rank aggregation (K2) and the Shapley chain
walk (K3) run there. ``acquisition_backend="fused"`` routes each recommend
call through the fused propose step (``core/propose.py``: one CUDA graph
per pool bucket on the card, Q1/K1, Q2 and K2), with the pool from the
host (``acquisition_pool="host"``, the staged path's selections bit for
bit) or drawn on the device (``"device"``); the default ``"staged"`` is the
staged path. The reference's ``surrogate_backend`` and ``shapley_backend``
options are not carried.
"""

from __future__ import annotations

import time as _time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np

from .. import obs
from ..device import DeviceLike, resolve_device
from ..tuneapi import Budget, EvalResult, Workload
from .compression import SpaceCompressor
from .fidelity import (
    FidelityPartition,
    collect_query_stats,
    early_stop_subset,
    partition_fidelities,
)
from .generator import CandidateColumns, CandidateGenerator, WarmStartQueue, phase1_config
from .hyperband import HyperbandRunner, Rung, RungTable
from .knowledge import KnowledgeBase, Observation, TaskRecord
from .similarity import SimilarityEngine, TaskWeights
from .space import ConfigSpace

Config = Dict[str, Any]

__all__ = ["MFTuneOptions", "MFTune", "TuningResult"]


@dataclass
class MFTuneOptions:
    R: float = 9.0
    eta: int = 3
    alpha: float = 0.65                  # cumulative density threshold (§7.1: 0.65)
    seed: int = 0
    enable_mfo: bool = True              # False => "MFTune w/o MF"
    enable_sc: bool = True               # False => "w/o SC"
    enable_transfer: bool = True         # False => ignore history entirely
    enable_warmstart_p1: bool = True
    enable_warmstart_p2: bool = True
    fidelity_mode: str = "sql_selection"  # | "data_volume" | "early_stop"
    init_lhs: int = 5                     # LHS initialization size (cold paths)
    min_target_obs_for_partition: int = 8
    sc_refresh_every: int = 1             # iterations between SC refreshes
    early_stop_factor: float = 1.0
    compressor: Optional[Callable[..., ConfigSpace]] = None  # SC strategy override (Fig. 6)
    acquisition_backend: Optional[str] = None  # None = module default; "staged" = the
                                               # staged path, "fused" = the fused step
    acquisition_pool: Optional[str] = None     # the fused step's pool: "device" = drawn
                                               # on the device, "host" = the staged
                                               # pool uploaded (identical selections)


@dataclass
class TrajectoryPoint:
    time: float                      # virtual budget seconds at improvement
    best: float
    config: Config
    fidelity: float
    wall_time: float = 0.0           # time.time() at improvement (0.0 = unset)
    rung: Optional[int] = None       # fidelity-level index into the bracket's
                                     # delta ladder (top level for full-fid BO)


@dataclass
class TuningResult:
    best_config: Optional[Config]
    best_performance: float
    trajectory: List[TrajectoryPoint]
    n_evaluations: int
    n_full_evaluations: int
    mfo_activation_time: Optional[float]
    overheads: Dict[str, float] = field(default_factory=dict)
    surrogate_cache: Dict[str, int] = field(default_factory=dict)  # store hit/miss counters
    plane_cache: Dict[str, int] = field(default_factory=dict)      # fused-plane LRU counters
    rung_tables: List["RungTable"] = field(default_factory=list)   # per-bracket promotion
                                                                   # state
    metrics: Dict[str, Any] = field(default_factory=dict)          # full registry snapshot
                                                                   # (obs.Metrics.snapshot())


class MFTune:
    def __init__(
        self,
        workload: Workload,
        kb: Optional[KnowledgeBase] = None,
        options: Optional[MFTuneOptions] = None,
        device: DeviceLike = None,
    ):
        self.device = resolve_device(device)
        self.wl = workload
        self.kb = kb or KnowledgeBase()
        self.opt = options or MFTuneOptions()
        self.space: ConfigSpace = workload.space
        self.rng = np.random.default_rng(self.opt.seed)

        # target task record
        if workload.task_id in self.kb.tasks:
            self.target = self.kb.get(workload.task_id)
        else:
            self.target = TaskRecord(
                task_id=workload.task_id,
                queries=list(workload.queries),
                meta_features=workload.meta_features(),
            )
            self.kb.add_task(self.target, persist=False)

        self.sim = SimilarityEngine(self.space, self.kb, seed=self.opt.seed, device=self.device)
        self.compressor = SpaceCompressor(
            self.space, alpha=self.opt.alpha, seed=self.opt.seed,
            device=self.device,
        )
        self.gen = CandidateGenerator(self.space, seed=self.opt.seed, device=self.device)
        self.ws_queue = WarmStartQueue()
        self.hb = HyperbandRunner(
            R=self.opt.R, eta=self.opt.eta, early_stop_factor=self.opt.early_stop_factor,
            seed=self.opt.seed,
        )
        self.partition: Optional[FidelityPartition] = None
        self._mfo_activation_time: Optional[float] = None
        self._trajectory: List[TrajectoryPoint] = []
        self._n_eval = 0
        self._n_full = 0
        # per-run metrics registry: the single sink that TuningResult's
        # overheads / surrogate_cache / plane_cache fields are views over
        self.metrics = obs.Metrics()
        self._deltas = [r.delta for r in self.hb.brackets[0].rungs]  # e.g. [1/9, 1/3, 1]
        self._delta_rung = {round(d, 6): i for i, d in enumerate(self._deltas)}

    # ------------------------------------------------------------------ utils
    def _charge_overhead(self, key: str, t0: float) -> None:
        self.metrics.counter("overhead/" + key).add(_time.perf_counter() - t0)

    def _best(self) -> Tuple[Optional[Config], float]:
        best = self.target.best()
        if best is None:
            return None, float("inf")
        return best.config, best.performance

    # -------------------------------------------------------------- evaluate
    def _fidelity_params(self, delta: float) -> Tuple[Optional[List[int]], float]:
        """Map a fidelity delta to (query subset, data fraction)."""
        subset: Optional[List[int]] = None
        data_fraction = 1.0
        m = len(self.wl.queries)
        if delta < 1.0:
            mode = self.opt.fidelity_mode
            if mode == "sql_selection":
                assert self.partition is not None
                subset = self.partition.queries_for(delta) or None
            elif mode == "early_stop":
                subset = early_stop_subset(m, delta)
            elif mode == "data_volume":
                subset = None
                data_fraction = delta
            else:
                raise ValueError(mode)
        return subset, data_fraction

    def _record(
        self,
        budget: Budget,
        config: Config,
        delta: float,
        subset: Optional[List[int]],
        res: EvalResult,
    ) -> Tuple[float, bool, float]:
        """Charge the budget and record one evaluation result."""
        budget.charge(res.elapsed, label=f"eval@{delta:.3f}")
        self._n_eval += 1
        # a NaN aggregate is neither failed nor inf: it would poison the rung
        # promotion sort and target.best(), so coerce non-finite to failure
        failed = bool(res.failed) or not np.isfinite(res.aggregate)
        perf = res.aggregate if not failed else float("inf")
        # best-so-far *before* this observation enters the KB: the trajectory
        # gains a point only on strict improvement (ties used to duplicate)
        _, prev_best = self._best()
        ob = Observation(
            config=config,
            performance=perf,
            fidelity=delta,
            per_query_perf=list(res.per_query_latency) if delta >= 1.0 and not failed else None,
            per_query_cost=list(res.per_query_cost) if delta >= 1.0 and not failed else None,
            query_subset=list(subset) if subset is not None else None,
            failed=failed,
            elapsed=res.elapsed,
            time=budget.now,
        )
        self.kb.record(self.target.task_id, ob)
        m = self.metrics
        m.counter("eval/failed" if failed else "eval/ok").add()
        m.counter(
            "budget/full_fidelity_s" if delta >= 1.0 else "budget/low_fidelity_s"
        ).add(res.elapsed)
        m.counter(f"budget/fidelity@{delta:.3f}_s").add(res.elapsed)
        m.histogram("eval/elapsed_s").observe(res.elapsed)
        if delta >= 1.0:
            self._n_full += 1
            if not failed and perf < prev_best:
                self._trajectory.append(
                    TrajectoryPoint(
                        time=budget.now, best=perf, config=config, fidelity=1.0,
                        wall_time=_time.time(),
                        rung=self._delta_rung.get(round(delta, 6)),
                    )
                )
        return perf, failed, res.elapsed

    def _evaluate(
        self, budget: Budget, config: Config, delta: float, cost_cap: Optional[float]
    ) -> Tuple[float, bool, float]:
        """Evaluate config at fidelity delta; record observation; charge budget."""
        config = dict(self.space.default(), **config)
        subset, data_fraction = self._fidelity_params(delta)
        with obs.span("evaluate", delta=delta, n=1, cap=cost_cap) as sp:
            res = self.wl.evaluate(
                config, query_indices=subset, cost_cap=cost_cap, data_fraction=data_fraction
            )
            out = self._record(budget, config, delta, subset, res)
            sp.set(cost=out[2], failed=out[1])
        return out

    def _evaluate_many(
        self, budget: Budget, configs: List[Config], delta: float, cost_cap: Optional[float]
    ) -> List[Tuple[float, bool, float]]:
        """Rung-level batched evaluation through ``Workload.evaluate_many``.

        All configs are evaluated in one workload call; budget charging and
        observation recording then replay sequentially, and configs past the
        point of budget exhaustion are dropped (a result prefix), matching
        the scalar rung loop's between-config should_stop checks.
        """
        configs = [dict(self.space.default(), **c) for c in configs]
        subset, data_fraction = self._fidelity_params(delta)
        with obs.span("evaluate", delta=delta, n=len(configs), cap=cost_cap) as sp:
            results = self.wl.evaluate_many(
                configs, query_indices=subset, cost_cap=cost_cap, data_fraction=data_fraction
            )
            out: List[Tuple[float, bool, float]] = []
            for config, res in zip(configs, results):
                if budget.exhausted:
                    break
                out.append(self._record(budget, config, delta, subset, res))
            sp.set(recorded=len(out),
                   cost=float(sum(r[2] for r in out)),
                   failures=int(sum(1 for r in out if r[1])))
        return out

    # ----------------------------------------------------------- components
    def _weights(self) -> TaskWeights:
        t0 = _time.perf_counter()
        with obs.span("similarity") as sp:
            if not self.opt.enable_transfer:
                w = TaskWeights(weights={}, similarities={}, used_meta=False)
                tgt = self.sim.target_self_weight(self.target)
                if tgt > 0:
                    w.weights["__target__"] = 1.0
            else:
                w = self.sim.compute(self.target)
            sp.set(sources=len(w.weights), used_meta=w.used_meta)
        self._charge_overhead("similarity", t0)
        return w

    def _compress(self, weights: TaskWeights) -> None:
        if not self.opt.enable_sc:
            return
        t0 = _time.perf_counter()
        with obs.span("space_compression") as sp:
            tasks = {t.task_id: t for t in self.kb.source_tasks(self.target.task_id)}
            if self.opt.compressor is not None:
                compressed = self.opt.compressor(
                    space=self.space, weights=weights, tasks=tasks, target=self.target
                )
            else:
                compressed = self.compressor.compress(weights, tasks, target=self.target)
            if len(compressed) > 0:
                self.gen.set_sample_space(compressed)
            sp.set(knobs=len(compressed))
        self._charge_overhead("space_compression", t0)

    def _try_partition(self, weights: TaskWeights) -> None:
        """Derive the fidelity partition once sources (or self) allow it."""
        if self.partition is not None or self.opt.fidelity_mode != "sql_selection":
            return
        t0 = _time.perf_counter()
        with obs.span("fidelity_partition") as sp:
            sources = self.kb.same_query_sources(self.target) if self.opt.enable_transfer else []
            stats = collect_query_stats(sources, weights.weights)
            # degradation (§6.3): the current task becomes its own source once
            # enough of its observations carry query vectors AND its own
            # surrogate has established out-of-sample rank fidelity (positive
            # k-fold tau -> a "__target__" weight). The former gate on the
            # meta/Eq.2 transition deadlocked when history existed but stayed
            # dissimilar: used_meta never flipped, so self-partition never fired.
            if not stats:
                full = self.target.with_query_vectors()
                if (
                    len(full) >= self.opt.min_target_obs_for_partition
                    and weights.weights.get("__target__", 0.0) > 0
                ):
                    stats = collect_query_stats([self.target], {self.target.task_id: 1.0})
            if stats:
                deltas = [d for d in self._deltas if d < 1.0]
                self.partition = partition_fidelities(stats, deltas)
            sp.set(partitioned=self.partition is not None)
        self._charge_overhead("fidelity_partition", t0)

    def _mfo_ready(self) -> bool:
        if not self.opt.enable_mfo:
            return False
        if self.opt.fidelity_mode == "sql_selection":
            return self.partition is not None
        return True  # DV / early-stop proxies need no partition

    # ------------------------------------------------------------------ main
    def run(self, budget: Budget) -> TuningResult:
        from contextlib import ExitStack

        from .acquisition import acquisition_backend, acquisition_pool

        with ExitStack() as stack:
            if self.opt.acquisition_backend is not None:
                stack.enter_context(acquisition_backend(self.opt.acquisition_backend))
            if self.opt.acquisition_pool is not None:
                stack.enter_context(acquisition_pool(self.opt.acquisition_pool))
            return self._run(budget)

    def _run(self, budget: Budget) -> TuningResult:
        from .acquisition import plane_cache_stats

        opt = self.opt
        plane0 = plane_cache_stats()
        # ---------------- Phase 1 warm start (once, full fidelity)
        with obs.span("warm_start") as sp:
            weights = self._weights()
            if opt.enable_warmstart_p1 and opt.enable_transfer:
                tasks = {t.task_id: t for t in self.kb.source_tasks(self.target.task_id)}
                cfg1 = phase1_config(weights, tasks)
                if cfg1 is not None and not budget.exhausted:
                    self._evaluate(budget, cfg1, 1.0, None)
                    sp.set(phase1=True)

        # ---------------- cold-start init if nothing else to go on
        if not weights.weights and not self.target.full_fidelity():
            # anchor on the vendor default first: a feasible reference that
            # floors the result at parity with the default and prices an
            # early-stop cap for the LHS probes — without it, exploratory
            # draws (log-geometry sampling reaches deep into the low-memory
            # OOM region on large inputs) each burn 4x-timeout charges
            with obs.span("cold_start", init_lhs=opt.init_lhs):
                cap = None
                if not budget.exhausted:
                    _, d_failed, d_cost = self._evaluate(
                        budget, dict(self.wl.default_config()), 1.0, None
                    )
                    if not d_failed:
                        cap = opt.early_stop_factor * d_cost
                for cfg in self.space.lhs_sample(self.rng, opt.init_lhs):
                    if budget.exhausted:
                        break
                    self._evaluate(budget, cfg, 1.0, cap)
            weights = self._weights()

        # ---------------- iterative tuning
        it = 0
        while not budget.exhausted:
            it += 1
            with obs.span("iteration", i=it) as sp:
                weights = self._weights()
                if it % max(opt.sc_refresh_every, 1) == 0:
                    self._compress(weights)
                self._try_partition(weights)

                if self._mfo_ready():
                    if self._mfo_activation_time is None:
                        self._mfo_activation_time = budget.now
                    sp.set(mode="mfo")
                    self._run_mfo_bracket(budget, weights)
                else:
                    sp.set(mode="bo")
                    self._run_bo_step(budget, weights)

        best_cfg, best_perf = self._best()
        # absorb the remaining side channels into the registry, then expose
        # the legacy TuningResult fields as views over it
        m = self.metrics
        m.absorb_counters("surrogate_store/", self.gen.cache_stats)
        plane_now = plane_cache_stats()
        m.absorb_counters("plane_cache/", {
            **{k: plane_now[k] - plane0[k] for k in ("hits", "misses", "evictions")},
            "entries": plane_now["entries"],
            "max_entries": plane_now["max_entries"],
        })
        tracer = obs.get_tracer()
        if tracer is not None:
            tracer.emit_metrics(m, scope=self.target.task_id)
        return TuningResult(
            best_config=best_cfg,
            best_performance=best_perf,
            trajectory=self._trajectory,
            n_evaluations=self._n_eval,
            n_full_evaluations=self._n_full,
            mfo_activation_time=self._mfo_activation_time,
            overheads=m.counters_view("overhead/", coerce_int=False),
            surrogate_cache=m.counters_view("surrogate_store/"),
            rung_tables=list(self.hb.tables),
            plane_cache=m.counters_view("plane_cache/"),
            metrics=m.snapshot(),
        )

    # --------------------------------------------------------------- BO step
    def _sources_for_gen(self, weights: TaskWeights):
        tasks = (
            {t.task_id: t for t in self.kb.source_tasks(self.target.task_id)}
            if self.opt.enable_transfer
            else {}
        )
        return self.gen.build_sources(weights, tasks, self.target, self._deltas)

    def _run_bo_step(self, budget: Budget, weights: TaskWeights) -> None:
        t0 = _time.perf_counter()
        with obs.span("bo_recommend", mode="bo_step") as sp:
            sources = self._sources_for_gen(weights)
            incumbent_cfg, _ = self._best()
            # `is not None`: an all-defaults {} incumbent is falsy but real
            incumbents = [incumbent_cfg] if incumbent_cfg is not None else []
            evaluated = [o.config for o in self.target.observations]
            cands = self.gen.recommend(1, sources, incumbents=incumbents, exclude=evaluated)
            sp.set(sources=len(sources), candidates=len(cands))
        self._charge_overhead("bo_recommend", t0)
        if cands:
            self._evaluate(budget, cands[0], 1.0, None)

    # -------------------------------------------------------------- MFO step
    def _run_mfo_bracket(self, budget: Budget, weights: TaskWeights) -> None:
        bracket = self.hb.next_bracket()
        opt = self.opt

        def provide(n: int, rungs: List[Rung]) -> Sequence[Config]:
            t0 = _time.perf_counter()
            with obs.span("bo_recommend", mode="provide", n=n) as sp:
                ws: List[Config] = []
                multi_rung = len(rungs) > 1
                if opt.enable_warmstart_p2 and opt.enable_transfer and multi_rung:
                    tasks = {t.task_id: t for t in self.kb.source_tasks(self.target.task_id)}
                    self.ws_queue.rebuild(weights, tasks)
                    # as many as survive to full fidelity in this inner loop
                    ws = self.ws_queue.take(rungs[-1].n)
                sources = self._sources_for_gen(weights)
                incumbent_cfg, _ = self._best()
                # `is not None`: an all-defaults {} incumbent is falsy but real
                incumbents = [incumbent_cfg] if incumbent_cfg is not None else []
                evaluated = [o.config for o in self.target.observations]
                sp.set(warm_starts=len(ws), sources=len(sources))
                # rung-table provisioning: BO candidates stay one columnar
                # batch; the table indexes (ws rows + batch rows) by column
                # and materializes dicts only when an evaluation needs them
                bo_batch = self.gen.recommend_batch(
                    max(n - len(ws), 0), sources, incumbents=incumbents, exclude=evaluated + ws
                )
                self._charge_overhead("bo_recommend", t0)
                return CandidateColumns(ws, bo_batch, limit=n)

        def evaluate(cfg: Config, delta: float, cap: Optional[float]):
            return self._evaluate(budget, cfg, delta, cap)

        def evaluate_batch(cfgs: List[Config], delta: float, cap: Optional[float]):
            return self._evaluate_many(budget, cfgs, delta, cap)

        def on_result(cfg, delta, perf, failed, elapsed):
            pass  # recording happens inside _evaluate / _evaluate_many

        with obs.span("mfo_bracket", s=bracket.s, n_rungs=len(bracket.rungs)):
            self.hb.run_bracket(
                bracket,
                provide_candidates=provide,
                evaluate=evaluate,
                on_result=on_result,
                should_stop=lambda: budget.exhausted,
                evaluate_batch=evaluate_batch,
            )
