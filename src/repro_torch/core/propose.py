"""The host side of the fused propose step (counterpart of
``repro.core.propose``).

:class:`ProposeEngine` keeps what the step (``repro_torch.kernels.
forest_eval.propose``) needs on the device: each fused ``ForestPlane``'s
arena, node table, QuickScorer tables and per-source denormalisation
stats (an LRU by plane identity), and each sample space's transform
tables mapped onto the full space's columns (an LRU by space identity). It
owns the device pool's ``torch.Generator`` and records every reference-
style static signature it ran (``compiled``).

Two pool modes (``acquisition.set_acquisition_pool``):

* ``device``: the pool is drawn on the device from the engine's generator;
  only the top k + margin rows come back. The draws differ from the host
  pool's (and from the reference's JAX key), so fixed-seed runs differ
  from the staged path's;
* ``host``: the generator's numpy pool is uploaded and only scoring and
  selection run on the device, so the chosen indices are the staged
  path's, bit for bit.

On the card each call replays a CUDA graph: one per (mode, pool bucket,
descent), captured on its own stream on first use with static buffers
for the pool, the sources' stats and the plane's tables. The kernels read
the source count, trees per source, valid rows and table shapes from
small device tensors, so a graph serves every plane whose tables fit its
buffers; a plane that does not fit, or a device-pool graph whose sample
space changed, captures that graph anew (``captures`` counts them). A
call copies its inputs into the buffers, replays, and copies the k
indices (and rows) back, with one synchronisation at the end. The launch
counts of ``kernels.counts`` are Python counters that a capture does not
run, so each replay adds the launches its capture recorded. On the CPU the
step runs eagerly through the plain versions.
"""

from __future__ import annotations

from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs
from ..kernels import counts
from ..kernels.forest_eval import propose as P
from ..kernels.forest_eval.ops import NodeTable, forest_eval_records, uniform_plan
from ..kernels.launch import n_sms
from .surrogate import ForestPlane, ProbabilisticRandomForest

__all__ = ["DESCENTS", "QS_AUTO_MIN", "ProposeEngine"]

_CONST_SIG = (4, False, False, False, False, 1)  # dropped knob: unit default

DESCENTS = ("auto", "qs", "forest")

# descent="auto" takes the QuickScorer descent (Q1) at pool buckets of at
# least this many candidates, K1 below. The CPU keeps the reference's XLA:CPU
# crossover. On the card Q1's per_tree route beats K1 `tiled` at every
# bucket of the sweep, from 256 (0.005043 against 0.005293 ms, by trace in
# turns) to 131072 (0.153730 against 0.235805 ms), at 12 sources x 10 trees
# and 60 knobs on an NVIDIA H100 80GB HBM3 at 700.00 W
# (scripts/propose_scaling.py, PERF.md), so auto takes Q1 from the smallest
# bucket.
QS_AUTO_MIN = {"cpu": 32768, "cuda": 256}

_DEPTH_CAP = 1 << 16   # K1 walks each tree for its own levels, at most this many
_INF_BITS = int(np.array(np.inf).view(np.int64))


def _pow2(n: int) -> int:
    return 1 << (max(int(n), 1) - 1).bit_length()


def _grow(caps: Dict[str, int], need: Dict[str, int]) -> Dict[str, int]:
    """A graph slot's buffer sizes for ``need``: source and tree rows
    exactly, table sizes as powers of two, never below ``caps``."""
    return {k: max(v if k in ("S", "T") else _pow2(v), caps.get(k, 0)) for k, v in need.items()}


class _PlaneEntry:
    """One plane on its device: the K1 arena and node table, the (3, S)
    stats (y_mean, y_std, Python's y_std ** 2) and, built on first use,
    the QuickScorer tables."""

    def __init__(self, plane: ForestPlane, dim: int):
        self.plane = plane
        self.dim = dim
        self.S = len(plane.forests)
        self.tps = plane.uniform_tree_count
        self.T = int(plane.roots.shape[0])
        cuda = plane.device.type == "cuda"
        self.nodes: Optional[NodeTable] = plane.node_table() if cuda else None
        self.arena = P.Arena(plane.feat, plane.thr, plane.child, plane.mean, plane.var,
                             plane.roots, plane.depth, self.nodes)
        self.ystats = torch.stack([plane.y_means, plane.y_stds, plane.y_std_sqs])
        self.ystats_host = torch.tensor([[f.y_mean for f in plane.forests],
                                         [f.y_std for f in plane.forests],
                                         [f.y_std**2 for f in plane.forests]],
                                        dtype=torch.float64)
        self._qs: Optional[Tuple[Optional[P.QSTables], str]] = None
        self._qs_plans: Dict[tuple, P.QSPlan] = {}

    def qs(self, merged: bool = True) -> Tuple[Optional[P.QSTables], str]:
        """The plane's QuickScorer tables (or None and the reason), built on
        first use; without ``merged`` the per-tree records may come alone,
        which is all the per_tree route reads (the merged tables cost as
        much host time again, a new plane each tuner iteration)."""
        qs = None if self._qs is None else self._qs[0]
        if self._qs is None or (merged and qs is not None and qs.tables is None):
            p = self.plane
            host, reason = P.build_qs_plan_ex(*(t.cpu().numpy() for t in (
                p.feat, p.thr, p.child, p.mean, p.var, p.roots)), self.dim, merged)
            self._qs = (None if host is None else P.qs_tables(host, p.device), reason)
        return self._qs

    def qs_plan(self, bucket: int, sms: int, route: Optional[str] = None) -> P.QSPlan:
        """Q1's plan for a pool bucket (``route="merged"`` forces that
        route; ``"per_tree"`` raises where the plane cannot take it)."""
        key = (bucket, sms, route)
        if key not in self._qs_plans:
            plan = P.qs_plan(self.qs(merged=False)[0], bucket, self.dim, sms)
            if route == "merged":
                plan = P.QSPlan("merged", reason="forced")
            elif route is not None and plan.route != route:
                raise ValueError(f"Q1's {route} route cannot take this plane: {plan.reason}")
            self._qs_plans[key] = plan
        return self._qs_plans[key]


@dataclass(eq=False)
class _Slot:
    """One captured graph and its static buffers."""

    descent: str
    caps: Dict[str, int]
    stream: "torch.cuda.Stream"
    buf: Dict[str, torch.Tensor] = field(default_factory=dict)
    host: Dict[str, torch.Tensor] = field(default_factory=dict)
    graph: Optional["torch.cuda.CUDAGraph"] = None
    out: Tuple[torch.Tensor, ...] = ()
    launches: Dict[str, int] = field(default_factory=dict)
    routes: Dict[str, int] = field(default_factory=dict)
    plan: object = None
    plane: Optional[_PlaneEntry] = None
    tables: object = None


class ProposeEngine:
    def __init__(self, space, seed: int = 0, pool_size: int = 256, margin: int = 64,
                 arena_cache: int = 8):
        self.space = space
        self.seed = seed
        self.pool_size = pool_size
        self.margin = margin
        self._gen: Optional[torch.Generator] = None
        self._arena_cache: "OrderedDict[int, _PlaneEntry]" = OrderedDict()
        self._arena_cache_max = arena_cache
        self._tables_cache: "OrderedDict[tuple, tuple]" = OrderedDict()
        # every reference-style static signature run (the reference's jit
        # cache keys); the graphs are keyed by (mode, bucket, descent)
        self.compiled: set = set()
        self.graphs: Dict[tuple, _Slot] = {}
        self.captures = 0
        self.replays = 0
        # where True, every card call runs its copies and replay under
        # torch.cuda.set_sync_debug_mode("error"): no host sync before the
        # one that collects the result
        self.check_sync = False
        # forces Q1's route on the card ("per_tree" or "merged"; None: the
        # plan's)
        self.qs_route: Optional[str] = None

    # ----------------------------------------------------------- availability
    @staticmethod
    def available() -> bool:
        """True: the port's step needs only torch (each call raises where
        its device is missing)."""
        return True

    @staticmethod
    def fusable(models: Sequence) -> bool:
        """True when the fused step applies: fitted PRFs with one tree count
        (the per-source slice contract)."""
        if not models:
            return False
        if not all(isinstance(m, ProbabilisticRandomForest) and m.trees for m in models):
            return False
        return len({len(m.trees) for m in models}) == 1

    # ---------------------------------------------------------------- uploads
    def _plane(self, models: Sequence) -> ForestPlane:
        from .acquisition import _plane_for
        return _plane_for([m.pack() for m in models])

    def _arena_for(self, plane: ForestPlane) -> _PlaneEntry:
        key = id(plane)
        hit = self._arena_cache.get(key)
        if hit is not None and hit.plane is plane:
            self._arena_cache.move_to_end(key)
            return hit
        entry = _PlaneEntry(plane, self.space.dim)
        self._arena_cache[key] = entry
        while len(self._arena_cache) > self._arena_cache_max:
            self._arena_cache.popitem(last=False)
        return entry

    def _tables_for(self, sample_space, device: torch.device) -> tuple:
        """(sig, cols) for draws over ``sample_space`` on ``device``, mapped
        onto the full space's column order: a dropped knob is a constant
        column at its unit default. Restrictions keep a knob's lo/hi/log,
        so the sample space's unit transform is the full space's."""
        key = (id(sample_space), str(device))
        hit = self._tables_cache.get(key)
        if hit is not None and hit[0] is sample_space:
            self._tables_cache.move_to_end(key)
            return hit
        sig_ss, cols_ss = sample_space.plane().device_tables()
        pos = {name: i for i, name in enumerate(sample_space.names)}
        fplane = self.space.plane()
        unit_default = fplane.encode_values(np.atleast_2d(fplane.default_row.copy()))[0]

        def to(a):
            return torch.from_numpy(np.ascontiguousarray(a)).to(device)

        sig: List[tuple] = []
        cols: List[tuple] = []
        for j, name in enumerate(self.space.names):
            i = pos.get(name)
            if i is None:
                sig.append(_CONST_SIG)
                cols.append((to(np.array([unit_default[j]])),))
            else:
                sig.append(sig_ss[i])
                cols.append(tuple(to(a) for a in cols_ss[i]))
        entry = (sample_space, tuple(sig), tuple(cols))
        self._tables_cache[key] = entry
        while len(self._tables_cache) > self._arena_cache_max:
            self._tables_cache.popitem(last=False)
        return entry

    def _generator(self, device: torch.device) -> torch.Generator:
        if self._gen is None or self._gen.device != device:
            self._gen = torch.Generator(device=device)
            self._gen.manual_seed(self.seed)
        return self._gen

    def _descent(self, descent: str, bucket: int, entry: _PlaneEntry) -> str:
        if descent not in DESCENTS:
            raise ValueError(f"unknown descent {descent!r}; expected one of {DESCENTS}")
        kind = entry.plane.device.type
        if descent == "forest" or (descent == "auto" and bucket < QS_AUTO_MIN[kind]):
            return "forest"
        qs, reason = entry.qs(merged=kind != "cuda")   # the card's plan reads the records alone
        if qs is None and descent == "qs":
            raise ValueError(f"no QuickScorer plan: {reason}")
        return "forest" if qs is None else "qs"

    @staticmethod
    def _check_uniform(plane: ForestPlane, what: str) -> int:
        tps = plane.uniform_tree_count
        if tps is None:
            raise ValueError(f"{what} requires a uniform tree count per source")
        return tps

    # ---------------------------------------------------------------- propose
    def propose(self, models: Sequence, incumbents: Sequence[float],
                weights: Sequence[float], n: int, sample_space=None, descent: str = "auto",
                pool_size: Optional[int] = None, steps: Optional[int] = None):
        """Device-pool mode: draw a fresh pool on the device and return the
        fused top k as ``(idx, unit_rows, agg)`` numpy arrays (k = n + margin
        rows, a power of two, for the caller's exclusion dedup). With
        ``steps`` set, that many steps, outputs stacked on a leading axis."""
        plane = self._plane(models)
        tps = self._check_uniform(plane, "propose")
        entry = self._arena_for(plane)
        dev = plane.device
        _, sig, cols = self._tables_for(sample_space or self.space, dev)
        n_pool = P.pool_bucket(pool_size or self.pool_size)
        descent = self._descent(descent, n_pool, entry)
        k = min(_pow2(n + self.margin), n_pool)
        S = entry.S
        static = ("propose", n_pool, plane.depth, S, tps, k, sig, "radix", descent, steps)
        first = static not in self.compiled
        self.compiled.add(static)
        obs.count("rank_kernel/radix")
        with obs.span("propose_step", mode="device_pool", bucket=n_pool, descent=descent,
                      rank="radix", sources=S, k=k, compile=first):
            obs.observe("propose/pool_occupancy", 1.0)
            gen = self._generator(dev)
            inc, w = self._vectors(incumbents, weights)
            if dev.type == "cuda":
                out = self._device_graph(entry, n_pool, descent, k, inc, w, steps,
                                         sample_space or self.space)
            else:
                args = (gen, cols, entry.arena, entry.ystats, inc, w)
                kw = dict(n_pool=n_pool, n_sources=S, tps=tps, k=k, sig=sig, descent=descent,
                          qs=entry.qs()[0] if descent == "qs" else None)
                out = (P.propose_step(*args, **kw) if steps is None
                       else P.propose_scan(*args, steps=steps, **kw))
            return tuple(t.numpy() for t in out)

    def score_topk(self, models: Sequence, X_unit, incumbents: Sequence[float],
                   weights: Sequence[float], n: int, descent: str = "auto") -> np.ndarray:
        """Host-pool mode: score an uploaded unit pool and return the top-n
        candidate indices, the staged path's (``score_sources`` ->
        ``aggregate_ranks`` -> stable argsort) bit for bit."""
        X_unit = np.atleast_2d(np.asarray(X_unit, dtype=float))
        plane = self._plane(models)
        tps = self._check_uniform(plane, "score_topk")
        entry = self._arena_for(plane)
        dev = plane.device
        N, D = X_unit.shape
        bucket = P.pool_bucket(N)
        descent = self._descent(descent, bucket, entry)
        k = min(_pow2(n), bucket)
        S = entry.S
        static = ("score", bucket, plane.depth, S, tps, k, "radix", descent)
        first = static not in self.compiled
        self.compiled.add(static)
        obs.count("rank_kernel/radix")
        with obs.span("propose_step", mode="host_pool", bucket=bucket, descent=descent,
                      rank="radix", sources=S, k=k, compile=first, occupancy=N / bucket):
            obs.observe("propose/pool_occupancy", N / bucket)
            inc, w = self._vectors(incumbents, weights)
            if dev.type == "cuda":
                idx = self._host_graph(entry, X_unit, bucket, descent, k, inc, w)
            else:
                Xp = torch.zeros((bucket, D), dtype=torch.float64)
                Xp[:N] = torch.from_numpy(X_unit)
                idx = P.propose_step(None, None, entry.arena, entry.ystats, inc, w,
                                     n_pool=bucket, n_sources=S, tps=tps, k=k, descent=descent,
                                     X=Xp, n_valid=N, qs=entry.qs()[0] if descent == "qs"
                                     else None)[0].numpy()
            return idx[: min(n, N)]

    @staticmethod
    def _vectors(incumbents, weights) -> Tuple[torch.Tensor, torch.Tensor]:
        """The incumbents and weights as float64 vectors on the host (the
        card's graphs copy them into their buffers)."""
        return (torch.from_numpy(np.asarray(incumbents, dtype=float).copy()),
                torch.from_numpy(np.asarray(weights, dtype=float).copy()))

    # ------------------------------------------------------------- the graphs
    def _need(self, descent: str, bucket: int, entry: _PlaneEntry) -> Dict[str, int]:
        need = {"S": entry.S, "T": entry.T}
        if descent == "forest":
            if entry.nodes is None:
                raise ValueError("the forest descent needs the plane's node table")
            lo, hi = entry.nodes.feat_range
            if lo < 0 or hi >= self.space.dim:
                raise ValueError(f"the plane splits on features {lo}..{hi} outside the "
                                 f"{self.space.dim}-dim space")
            need.update(R=entry.nodes.n_records + 1,
                        rt=_pow2(int(np.diff(entry.nodes.tree_start).max(initial=1))))
        elif self._qs_plan(bucket, entry).route == "per_tree":
            need.update(blob=entry.qs(merged=False)[0].trees.blob.numel())
        else:
            qs = entry.qs()[0]
            need.update(M=max(1, qs.thr.numel()), words=qs.tables.numel(),
                        L=max(1, qs.leaf_mean.numel()))
        return need

    def _qs_plan(self, bucket: int, entry: _PlaneEntry) -> P.QSPlan:
        return entry.qs_plan(bucket, n_sms(entry.plane.device), self.qs_route)

    def _slot(self, mode: str, bucket: int, descent: str, entry: _PlaneEntry,
              tables=None) -> _Slot:
        """The graph slot of (mode, bucket, descent), its buffers grown to
        hold ``entry`` (and its graph dropped where they grow or the sample
        space's tables changed)."""
        dev = entry.plane.device
        need = self._need(descent, bucket, entry)
        key = (mode, bucket, descent)
        slot = self.graphs.get(key)
        qplan = self._qs_plan(bucket, entry) if descent == "qs" else None
        if slot is not None and all(slot.caps.get(k, 0) >= v for k, v in need.items()) and (
                tables is None or slot.tables is tables) and (
                qplan is None or (slot.plan.route == qplan.route and P.qs_plan_fits(
                    slot.plan, entry.qs(merged=False)[0], self.space.dim))):
            return slot
        caps = _grow(slot.caps if slot is not None else {}, need)
        D = self.space.dim
        f64 = dict(dtype=torch.float64, device=dev)
        i32 = dict(dtype=torch.int32, device=dev)
        slot = _Slot(descent, caps,
                     slot.stream if slot is not None else torch.cuda.Stream(dev),
                     tables=tables)
        S_rows, T_rows = caps["S"], caps["T"]
        b = slot.buf
        b["X"] = torch.zeros((bucket, D), **f64)
        b["small"] = torch.zeros((5, S_rows), **f64)   # ystats (3 rows), inc, w
        b["meta"] = torch.zeros(3, **i32)               # S, tps, n_valid
        if descent == "forest":
            b["nodes"] = torch.zeros((caps["R"], 2), dtype=torch.int64, device=dev)
            b["stats"] = torch.zeros((caps["R"], 2), **f64)
            b["trees"] = torch.zeros((T_rows + 1, 2), **i32)
            slot.plan = uniform_plan(T_rows, bucket, D, caps["rt"], n_sms(dev))
            if slot.plan.route != "tiled":
                raise ValueError(f"K1's tiled route cannot hold trees of {caps['rt']} records "
                                 f"beside a tile of {D} features")
        elif qplan.route == "per_tree":
            slot.plan = qplan
            b["blob"] = torch.zeros(caps["blob"], dtype=torch.uint8, device=dev)
            b["tree_off"] = torch.zeros(T_rows + 1, **i32)
            b["tmeta"] = torch.zeros(2, **i32)
        else:
            slot.plan = qplan
            b["thr"] = torch.zeros(caps["M"], **f64)
            b["thr_off"] = torch.zeros(D + 1, **i32)
            b["tables"] = torch.zeros(caps["words"], dtype=torch.int64, device=dev)
            b["leaf_mean"] = torch.zeros(caps["L"], **f64)
            b["leaf_var"] = torch.zeros(caps["L"], **f64)
            b["leaf_off"] = torch.zeros(T_rows, **i32)
            b["qmeta"] = torch.zeros(2, **i32)
        pin = dict(pin_memory=True)
        slot.host["small"] = torch.zeros((5, S_rows), dtype=torch.float64, **pin)
        slot.host["meta"] = torch.zeros(3, dtype=torch.int32, **pin)
        slot.host["idx"] = torch.zeros(bucket, dtype=torch.int64, **pin)
        self.graphs[key] = slot
        return slot

    def _load(self, slot: _Slot, entry: _PlaneEntry, inc, w, n_valid: int) -> None:
        """Copy a call's inputs into the slot's buffers (no host sync): the
        sources' stats through pinned memory, the plane's tables device to
        device where the slot does not hold this plane yet."""
        b, h = slot.buf, slot.host
        S = entry.S
        h["small"].zero_()
        h["small"][:3, :S] = entry.ystats_host
        h["small"][3, :S] = inc
        h["small"][4, :S] = w
        h["meta"].copy_(torch.tensor([S, entry.tps, n_valid], dtype=torch.int32))
        b["small"].copy_(h["small"], non_blocking=True)
        b["meta"].copy_(h["meta"], non_blocking=True)
        if slot.plane is entry:
            return
        if slot.descent == "forest":
            nt = entry.nodes
            R, T, T_rows = nt.n_records, entry.T, slot.caps["T"]
            b["nodes"][:R].copy_(nt.nodes)
            b["stats"][:R].copy_(nt.stats)
            b["trees"][:T + 1].copy_(nt.trees)
            # a leaf record past the table for the padding trees to sit on
            # (fill_ with Python scalars: an indexed assignment copies a
            # host scalar, which syncs)
            b["nodes"][R, 0].fill_(_INF_BITS)
            b["nodes"][R, 1].fill_(R << 32)
            b["stats"][R].fill_(0.0)
            b["trees"][T:T_rows, 0].fill_(R)
            b["trees"][T:, 1].fill_(0)
            b["trees"][T_rows, 0].fill_(R + (T < T_rows))
        elif slot.plan.route == "per_tree":
            tt = entry.qs(merged=False)[0].trees
            b["blob"][:tt.blob.numel()].copy_(tt.blob)
            b["tree_off"][:entry.T + 1].copy_(tt.tree_off)
            b["tmeta"].copy_(tt.meta)
        else:
            qs = entry.qs()[0]
            for name in ("thr", "tables", "leaf_mean", "leaf_var"):
                src = getattr(qs, name)
                b[name][:src.numel()].copy_(src)
            b["thr_off"].copy_(qs.thr_off)
            b["leaf_off"][:entry.T].copy_(qs.leaf_off)
            b["qmeta"].copy_(qs.meta)
        slot.plane = entry

    def _body(self, slot: _Slot, X_fn):
        """The step as the graph runs it: the pool (``X_fn``), the descent
        into (T_rows, N) buffers, Q2, K2 ranks, the aggregate, K2's top-k
        order. Returns (X, perm, agg)."""
        b = slot.buf
        T_rows = slot.caps["T"]

        def body():
            X = X_fn()
            if slot.descent == "qs" and slot.plan.route == "per_tree":
                trees = P.TreeTables(b["blob"], b["tree_off"], b["tmeta"], None, 0, 0, 0)
                qs = P.QSTables(*(None,) * 7, T_rows, 0, trees)
                m, v = P.qs_leaf_stats_cuda(X, qs, T_rows, slot.plan)
            elif slot.descent == "qs":
                qs = P.QSTables(b["thr"], b["thr_off"], b["tables"], b["leaf_mean"],
                                b["leaf_var"], b["leaf_off"], b["qmeta"], T_rows, 0)
                m, v = P.qs_leaf_stats_cuda(X, qs, T_rows, slot.plan)
            else:
                m, v = forest_eval_records(b["nodes"], b["stats"], b["trees"], X, slot.plan,
                                           _DEPTH_CAP)
            small = b["small"]
            perm, agg = P.score_rows(m, v, small[:3], small[3], small[4], b["meta"])
            return X, perm, agg

        return body

    def _capture(self, slot: _Slot, body, gen: Optional[torch.Generator] = None) -> None:
        """Warm the step up twice on the slot's stream (K2's workspace then
        belongs to that stream, libraries load, K1's shared-memory attribute
        is set), then capture it. The launch counts a capture records are no
        launches: they are taken back and added at each replay instead."""
        dev = slot.buf["X"].device
        cur = torch.cuda.current_stream(dev)
        slot.stream.wait_stream(cur)
        with torch.cuda.stream(slot.stream):
            body()
            body()
        cur.wait_stream(slot.stream)
        launches, routes = dict(counts.LAUNCHES), dict(counts.ROUTE_LAUNCHES)
        graph = torch.cuda.CUDAGraph()
        if gen is not None:
            graph.register_generator_state(gen)
        with torch.cuda.graph(graph, stream=slot.stream):
            slot.out = body()
        slot.launches = {k: counts.LAUNCHES[k] - launches[k] for k in launches
                         if counts.LAUNCHES[k] != launches[k]}
        slot.routes = {k: v - routes.get(k, 0) for k, v in counts.ROUTE_LAUNCHES.items()
                       if v != routes.get(k, 0)}
        counts.LAUNCHES.update(launches)
        counts.ROUTE_LAUNCHES.clear()
        counts.ROUTE_LAUNCHES.update(routes)
        slot.graph = graph
        self.captures += 1

    def _replay(self, slot: _Slot) -> None:
        slot.graph.replay()
        for k, v in slot.launches.items():
            counts.LAUNCHES[k] += v
        for k, v in slot.routes.items():
            counts.ROUTE_LAUNCHES[k] = counts.ROUTE_LAUNCHES.get(k, 0) + v
        self.replays += 1

    def _sync_check(self):
        import contextlib

        if not self.check_sync:
            return contextlib.nullcontext()

        @contextlib.contextmanager
        def errors():
            prev = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode("error")
            try:
                yield
            finally:
                torch.cuda.set_sync_debug_mode(prev)

        return errors()

    def _host_graph(self, entry, X_unit: np.ndarray, bucket: int, descent: str, k: int,
                    inc, w) -> np.ndarray:
        slot = self._slot("host", bucket, descent, entry)
        N = X_unit.shape[0]

        X_host = torch.from_numpy(np.require(X_unit, np.float64, ["C", "W"]))

        def load():
            # straight from the pageable array: the call returns once the
            # array is staged, so no pinned copy of the pool is needed
            slot.buf["X"][:N].copy_(X_host, non_blocking=True)
            slot.buf["X"][N:].zero_()
            self._load(slot, entry, inc, w, N)

        if slot.graph is None:
            load()
            self._capture(slot, self._body(slot, lambda: slot.buf["X"]))
        with self._sync_check():
            load()
            self._replay(slot)
            _, perm, _ = slot.out
            slot.host["idx"][:k].copy_(perm[:k], non_blocking=True)
        torch.cuda.current_stream(entry.plane.device).synchronize()
        return slot.host["idx"][:k].numpy().copy()

    def _device_graph(self, entry, n_pool: int, descent: str, k: int, inc, w,
                      steps: Optional[int], sample_space):
        dev = entry.plane.device
        tables = self._tables_for(sample_space, dev)
        _, sig, cols = tables
        gen = self._generator(dev)
        slot = self._slot("device", n_pool, descent, entry, tables)
        if slot.graph is None:
            self._load(slot, entry, inc, w, n_pool)
            self._capture(slot, self._body(
                slot, lambda: P.draw_unit_pool(gen, sig, cols, n_pool)), gen)
        n = steps or 1
        out = (torch.empty((n, k), dtype=torch.int64, pin_memory=True),
               torch.empty((n, k, self.space.dim), dtype=torch.float64, pin_memory=True),
               torch.empty((n, k), dtype=torch.float64, pin_memory=True))
        with self._sync_check():
            self._load(slot, entry, inc, w, n_pool)
            for i in range(n):
                self._replay(slot)
                X, perm, agg = slot.out
                idx = perm[:k]
                for o, t in zip(out, (idx, X.index_select(0, idx), agg.index_select(0, idx))):
                    o[i].copy_(t, non_blocking=True)
        torch.cuda.current_stream(dev).synchronize()
        return out if steps is not None else tuple(o[0] for o in out)

    # --------------------------------------------------------------- summary
    def graph_stats(self) -> Dict[str, int]:
        """Graphs held, captures and replays so far."""
        return {"graphs": len(self.graphs), "captures": self.captures,
                "replays": self.replays}
