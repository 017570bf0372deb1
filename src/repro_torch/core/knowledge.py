"""Knowledge database (paper §4.1 component 2).

Stores, per task: observations (config, aggregate performance, per-query
performance/cost vectors, fidelity, timestamps), the 34-d meta-feature
vector, and the task descriptor (benchmark, scale, hardware, query list).
Persists to a directory of JSON files so tuning sessions can accumulate
history across runs — and so a restarted tuner resumes exactly.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field, asdict
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

__all__ = ["Observation", "TaskRecord", "KnowledgeBase"]

Config = Dict[str, Any]


@dataclass
class Observation:
    config: Config
    performance: float                      # aggregate objective (latency; lower=better)
    fidelity: float = 1.0                   # delta in (0, 1]
    per_query_perf: Optional[List[float]] = None   # aligned to task.queries (only for evaluated subset at full fid; else subset order)
    per_query_cost: Optional[List[float]] = None
    query_subset: Optional[List[int]] = None        # indices into task.queries that were run
    failed: bool = False
    elapsed: float = 0.0                    # evaluation cost charged to the budget
    time: float = 0.0                       # virtual timestamp at completion

    def to_json(self) -> Dict[str, Any]:
        d = asdict(self)
        return d

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "Observation":
        return Observation(**d)


@dataclass
class TaskRecord:
    task_id: str
    queries: List[str]                      # query names, defines per-query vector order
    meta_features: Optional[List[float]] = None
    descriptor: Dict[str, Any] = field(default_factory=dict)
    observations: List[Observation] = field(default_factory=list)

    # ------------------------------------------------------------------ views
    def full_fidelity(self) -> List[Observation]:
        return [o for o in self.observations if o.fidelity >= 1.0 and not o.failed]

    def at_fidelity(
        self, delta: float, tol: float = 1e-6, include_failed: bool = False
    ) -> List[Observation]:
        return [
            o
            for o in self.observations
            if abs(o.fidelity - delta) <= tol and (include_failed or not o.failed)
        ]

    def successful(self) -> List[Observation]:
        return [o for o in self.observations if not o.failed]

    def best(self) -> Optional[Observation]:
        full = self.full_fidelity()
        return min(full, key=lambda o: o.performance) if full else None

    def with_query_vectors(self) -> List[Observation]:
        """Observations carrying full per-query performance vectors."""
        m = len(self.queries)
        return [
            o
            for o in self.observations
            if not o.failed and o.per_query_perf is not None and len(o.per_query_perf) == m
        ]

    def to_json(self) -> Dict[str, Any]:
        return {
            "task_id": self.task_id,
            "queries": self.queries,
            "meta_features": self.meta_features,
            "descriptor": self.descriptor,
            "observations": [o.to_json() for o in self.observations],
        }

    @staticmethod
    def from_json(d: Dict[str, Any]) -> "TaskRecord":
        return TaskRecord(
            task_id=d["task_id"],
            queries=list(d["queries"]),
            meta_features=d.get("meta_features"),
            descriptor=d.get("descriptor", {}),
            observations=[Observation.from_json(o) for o in d.get("observations", [])],
        )


class KnowledgeBase:
    """In-memory task store with optional directory persistence."""

    def __init__(self, root: Optional[str] = None):
        self.root = root
        self.tasks: Dict[str, TaskRecord] = {}
        if root:
            os.makedirs(root, exist_ok=True)
            for fn in sorted(os.listdir(root)):
                if fn.endswith(".json"):
                    with open(os.path.join(root, fn)) as f:
                        rec = TaskRecord.from_json(json.load(f))
                    self.tasks[rec.task_id] = rec

    # ---------------------------------------------------------------- access
    def add_task(self, rec: TaskRecord, persist: bool = True) -> None:
        self.tasks[rec.task_id] = rec
        if persist:
            self.save_task(rec.task_id)

    def get(self, task_id: str) -> TaskRecord:
        return self.tasks[task_id]

    def source_tasks(self, target_id: str) -> List[TaskRecord]:
        return [t for tid, t in sorted(self.tasks.items()) if tid != target_id]

    def same_query_sources(self, target: TaskRecord) -> List[TaskRecord]:
        """Source tasks whose query set is identical to the target's (§6.1)."""
        tq = list(target.queries)
        return [t for t in self.source_tasks(target.task_id) if list(t.queries) == tq]

    def record(self, task_id: str, obs: Observation, persist: bool = False) -> None:
        self.tasks[task_id].observations.append(obs)
        if persist:
            self.save_task(task_id)

    # ----------------------------------------------------------- persistence
    def save_task(self, task_id: str) -> None:
        if not self.root:
            return
        rec = self.tasks[task_id]
        path = os.path.join(self.root, f"{task_id}.json")
        fd, tmp = tempfile.mkstemp(dir=self.root, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(rec.to_json(), f, default=_np_default)
            os.replace(tmp, path)  # atomic commit
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)

    def save_all(self) -> None:
        for tid in self.tasks:
            self.save_task(tid)


def _np_default(o):
    if isinstance(o, (np.integer,)):
        return int(o)
    if isinstance(o, (np.floating,)):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (np.bool_,)):
        return bool(o)
    raise TypeError(f"not JSON serializable: {type(o)}")
