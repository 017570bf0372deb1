"""The 32-task grid and historical-data generation (paper §7.1).

Tasks = {tpch, tpcds} x {100, 600} GB x hardware scenarios A..H. Histories
are produced by running vanilla Bayesian optimization (PRF surrogate + EI,
LHS init — exactly the paper's historical-data protocol) for 50
observations per task, storing full per-query latency/cost vectors so that
fidelity partitioning has the data it needs. Generation is cached on disk
through the KnowledgeBase JSON format.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence

import numpy as np

from ..core.acquisition import ei_scores
from ..device import DeviceLike, resolve_device
from ..core.knowledge import KnowledgeBase, Observation, TaskRecord
from ..core.surrogate import make_forest
from .knobs import spark_space
from .workload import SparkWorkload, make_task_id

__all__ = ["TaskSpec", "all_task_specs", "generate_history", "build_knowledge_base"]


@dataclass(frozen=True)
class TaskSpec:
    benchmark: str
    data_gb: int
    hardware: str

    @property
    def task_id(self) -> str:
        return make_task_id(self.benchmark, self.data_gb, self.hardware)

    def workload(self, seed: int = 1234) -> SparkWorkload:
        return SparkWorkload(self.benchmark, self.data_gb, self.hardware, seed=seed)


def all_task_specs() -> List[TaskSpec]:
    specs = []
    for bench in ("tpch", "tpcds"):
        for gb in (100, 600):
            for hw in "ABCDEFGH":
                specs.append(TaskSpec(bench, gb, hw))
    return specs


def generate_history(
    wl: SparkWorkload, n_obs: int = 50, n_init: int = 8, seed: int = 0,
    device: DeviceLike = None,
) -> TaskRecord:
    """Vanilla BO (PRF + EI) history with per-query vectors; the surrogate
    scores its candidate pools on ``device``."""
    device = resolve_device(device)
    rng = np.random.default_rng(seed)
    space = wl.space
    rec = TaskRecord(
        task_id=wl.task_id,
        queries=list(wl.queries),
        meta_features=wl.meta_features(),
        descriptor={"benchmark": wl.benchmark, "data_gb": wl.data_gb, "hardware": wl.hardware},
    )
    clock = 0.0

    def run(cfg) -> None:
        nonlocal clock
        res = wl.evaluate(cfg)
        clock += res.elapsed
        rec.observations.append(
            Observation(
                config=dict(cfg),
                performance=res.aggregate if not res.failed else float("inf"),
                fidelity=1.0,
                per_query_perf=list(res.per_query_latency) if not res.failed else None,
                per_query_cost=list(res.per_query_cost) if not res.failed else None,
                failed=res.failed,
                elapsed=res.elapsed,
                time=clock,
            )
        )

    for cfg in space.lhs_sample(rng, n_init):
        run(cfg)
    while len(rec.observations) < n_obs:
        ok = [o for o in rec.observations if not o.failed]
        if len(ok) >= 2:
            X = space.encode_many([o.config for o in ok])
            y = np.array([o.performance for o in ok])
            model = make_forest(seed=seed, device=device).fit(X, y)
            # columnar pool: sampled, encoded and scored without dicts;
            # only the EI winner materializes for evaluation
            pool = space.sample(rng, 192)
            scores = ei_scores(model, pool.unit_tensor(device), float(y.min()))
            cfg = pool[int(np.argmax(scores))]
        else:
            cfg = space.sample(rng, 1)[0]
        run(cfg)
    return rec


def build_knowledge_base(
    root: Optional[str] = None,
    specs: Optional[Sequence[TaskSpec]] = None,
    n_obs: int = 50,
    seed: int = 0,
    verbose: bool = False,
    device: DeviceLike = None,
) -> KnowledgeBase:
    """Load-or-generate histories for the task grid; cached under ``root``."""
    kb = KnowledgeBase(root)
    specs = list(specs) if specs is not None else all_task_specs()
    for i, spec in enumerate(specs):
        if spec.task_id in kb.tasks and len(kb.get(spec.task_id).observations) >= n_obs:
            continue
        if verbose:
            print(f"[sparksim] generating history {spec.task_id} ({i + 1}/{len(specs)})", flush=True)
        rec = generate_history(spec.workload(), n_obs=n_obs, seed=seed + i, device=device)
        kb.add_task(rec, persist=root is not None)
    return kb
