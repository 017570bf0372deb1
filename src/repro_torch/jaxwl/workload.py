"""jaxwl: the LM stack's own distributed configuration as an MFTune
workload, the reference's ``jaxwl/workload.py`` ported.

Queries = (arch x shape) cells. The latency of a query under a
configuration is the three-term H100 roofline step time of the cell's step
on the chosen mesh with that runtime configuration, as the port's dry-run
(``launch/dryrun.py::run_cell``) models it: the step traced on fake tensors
and rated against the H100 SXM data sheet (the reference rates compiled
HLO against a TPU v5e). An evaluation traces the step (seconds), so results
are cached by (cell, canonical config) in a file of the port's own
(``.cache/jaxwl_torch/evals.json`` by default).
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional, Sequence, Tuple

from .. import obs
from ..core.space import BoolKnob, CatKnob, ConfigSpace, FloatKnob
from ..tuneapi import EvalResult, Workload

__all__ = ["CellWorkload", "runtime_space", "CACHE_PATH"]

Config = Dict[str, Any]
CACHE_PATH = ".cache/jaxwl_torch/evals.json"


def runtime_space() -> ConfigSpace:
    """Tunable runtime knobs that change the compiled program."""
    return ConfigSpace([
        CatKnob("remat", ("none", "dots", "full"), default="full"),
        BoolKnob("seq_shard", default=True),
        BoolKnob("fsdp", default=True),
        CatKnob("attn_chunk", (512, 1024, 2048, 4096), default=1024),
        CatKnob("scan_unroll", (1, 2), default=1),
        FloatKnob("capacity_factor", 1.0, 2.0, default=1.25),
        CatKnob("opt_state_dtype", ("float32", "bfloat16"), default="float32"),
        BoolKnob("act_shard", default=True),
    ])


class CellWorkload(Workload):
    def __init__(
        self,
        cells: Sequence[Tuple[str, str]],
        multi_pod: bool = False,
        cache_path: str = CACHE_PATH,
    ):
        self.cells = list(cells)
        self.multi_pod = multi_pod
        self._space = runtime_space()
        self.task_id = "jaxwl-" + "-".join(f"{a}.{s}" for a, s in self.cells)
        self.cache_path = cache_path
        self._cache: Dict[str, float] = {}
        if cache_path and os.path.exists(cache_path):
            with open(cache_path) as f:
                self._cache = json.load(f)

    @property
    def queries(self) -> List[str]:
        return [f"{a}:{s}" for a, s in self.cells]

    @property
    def space(self) -> ConfigSpace:
        return self._space

    # ------------------------------------------------------------------ eval
    @staticmethod
    def _canon(cfg: Config) -> str:
        return json.dumps({k: cfg[k] for k in sorted(cfg)}, default=str)

    def _key(self, cell: Tuple[str, str], cfg: Config) -> str:
        return f"{cell[0]}|{cell[1]}|{'mp' if self.multi_pod else 'sp'}|{self._canon(cfg)}"

    def _overrides(self, cfg: Config, shape_kind: str) -> Dict[str, Any]:
        ov = dict(cfg)
        # decode/prefill cells never remat and ignore seq_shard-for-carries
        if shape_kind != "train":
            ov["remat"] = "none"
            ov["seq_shard"] = False
        return ov

    def _eval_cell(self, cell: Tuple[str, str], cfg: Config) -> Optional[float]:
        key = self._key(cell, cfg)
        if key in self._cache:
            return self._cache[key]
        from ..configs import SHAPES
        from ..launch.dryrun import run_cell

        shape = SHAPES[cell[1]]
        try:
            r = run_cell(cell[0], cell[1], self.multi_pod, self._overrides(cfg, shape.kind))
        except Exception:
            self._cache[key] = -1.0
            self._persist()
            return None
        if r.get("status") != "ok":
            self._cache[key] = -1.0
            self._persist()
            return None
        t = float(r["roofline"]["step_time_s"])
        self._cache[key] = t
        self._persist()
        return t

    def _persist(self) -> None:
        if not self.cache_path:
            return
        os.makedirs(os.path.dirname(self.cache_path) or ".", exist_ok=True)
        with open(self.cache_path + ".tmp", "w") as f:
            json.dump(self._cache, f)
        os.replace(self.cache_path + ".tmp", self.cache_path)

    def evaluate(
        self,
        config: Config,
        query_indices: Optional[Sequence[int]] = None,
        cost_cap: Optional[float] = None,
        data_fraction: float = 1.0,
    ) -> EvalResult:
        cfg = dict(self._space.default(), **config)
        idx = list(query_indices) if query_indices is not None else range(len(self.cells))
        with obs.span("workload_eval", task=self.task_id, n=1, queries=len(idx)) as sp:
            lats: List[float] = []
            total = 0.0
            for qi in idx:
                t = self._eval_cell(self.cells[qi], cfg)
                if t is None or t < 0:
                    obs.count("workload/compile_error")
                    sp.set(failed=True, reason="compile_error")
                    return EvalResult(per_query_latency=lats + [float("inf")],
                                      per_query_cost=lats + [0.0], failed=True,
                                      failure_reason="compile_error")
                if cost_cap is not None and total + t > cost_cap:
                    obs.count("workload/early_stop")
                    sp.set(failed=True, reason="early_stop")
                    return EvalResult(per_query_latency=lats + [t],
                                      per_query_cost=lats + [max(cost_cap - total, 0.0)],
                                      failed=True, failure_reason="early_stop")
                lats.append(t)
                total += t
            obs.count("workload/ok")
            sp.set(failed=False, reason="ok")
            return EvalResult(per_query_latency=lats, per_query_cost=list(lats))

    def evaluate_many(
        self,
        configs: Sequence[Config],
        query_indices: Optional[Sequence[int]] = None,
        cost_cap=None,
        data_fraction: float = 1.0,
    ) -> List[EvalResult]:
        """Batched evaluation for traced cells.

        A rung batch reduces to one trace per unique (config, cap) pair:
        duplicates share the first pair's EvalResult outright, and distinct
        configs go through the scalar path, whose (cell, canonical-config)
        cache memoizes the trace itself.
        """
        caps = self._per_config_caps(cost_cap, len(configs))
        memo: Dict[Tuple[str, Optional[float]], EvalResult] = {}
        out: List[EvalResult] = []
        for cfg, cap in zip(configs, caps):
            key = (self._canon(dict(self._space.default(), **cfg)), cap)
            if key not in memo:
                memo[key] = self.evaluate(
                    cfg, query_indices=query_indices, cost_cap=cap,
                    data_fraction=data_fraction,
                )
            else:
                obs.count("workload/batch_dedup")
            out.append(memo[key])
        return out

    def meta_features(self) -> Optional[List[float]]:
        return None
