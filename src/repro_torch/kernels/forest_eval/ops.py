"""Dispatch for packed-forest evaluation (kernel K1).

``forest_eval`` returns per-tree leaf stats, each (n_trees, n_points), for
a packed node arena (see ``repro_torch.core.surrogate.PackedForest``).
Tensors on the CPU take the plain version in ``ref.py``. Tensors on the
card launch ``csrc/forest_eval.cu`` on one of two routes, picked by
:func:`forest_plan`:

- ``tiled``: a grid over (candidate tile, tree group). A block stages its
  tile of X and its trees' node records (a :class:`NodeTable`, one 16-byte
  record a node, siblings side by side) in shared memory; each thread owns
  one candidate and walks its share of the group's trees there;
- ``gather``: the first design, one thread per (tree, candidate) reading
  the arena through the read-only cache. It takes what ``tiled`` refuses:
  an arena that is no forest, a feature index outside X's width, or a tile
  or one tree that does not fit in shared memory.

There is no other route: a CUDA tensor never reaches the plain version,
and a build or launch failure raises.

The reference pads arenas and pools to power-of-two buckets to bound
XLA's compile cache; an eager port compiles nothing per shape, so the
arena and the pool go to the kernel as they are.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from types import SimpleNamespace
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch, n_sms
from .ref import forest_eval_plain

__all__ = [
    "ForestPlan",
    "NodeTable",
    "ROUTES",
    "SMEM_MAX",
    "TILE_ROWS",
    "forest_eval",
    "forest_eval_cuda",
    "forest_eval_plain",
    "forest_eval_records",
    "forest_plan",
    "pack_nodes",
    "uniform_plan",
]

ROUTES = ("tiled", "gather")
_MAX_TREES = 65535      # gridDim.y
TILE_ROWS = (128, 64, 32)   # candidates a tile, largest first
SMEM_MAX = 232448       # shared memory a block may ask for on an H100 (227 KB)
_BLOCKS_PER_SM = 1      # blocks the plan asks for at least, per SM, where trees allow
_BATCH = 4              # trees a thread walks side by side (the kernel's kBatch)
_STAGE_THREADS = 256    # threads a block has at least, to stage its tile
_MAX_THREADS = 1024
_RECORD = 16            # bytes of a node record


@dataclass(frozen=True, eq=False)
class NodeTable:
    """A forest's nodes renumbered for the ``tiled`` route.

    Records are grouped by tree (tree t owns ``[tree_start[t],
    tree_start[t + 1])``, its root first) and the two children of a node
    sit side by side, so a record needs only its left child: ``right =
    left + 1``. A leaf keeps ``thr = +inf`` and ``left = self``: ``x >
    +inf`` is false for every x, NaN included, so a leaf holds its lane.

    ``nodes`` (R, 2) int64: the bits of the float64 ``thr``, then ``feat``
    in the low and ``left`` in the high 32 bits (read on the card as one
    16-byte record). ``stats`` (R, 2) float64: (mean, var). ``trees`` (T +
    1, 2) int32: each tree's first record and its levels (the rounds after
    which every lane sits on a leaf); row T is (R, 0). ``tree_start`` and
    ``feat_range`` (the least and largest ``feat`` of a record that
    branches, (0, -1) where none does) stay on the host for the plan, and
    ``plans`` keeps each shape's :func:`forest_plan`.
    """

    nodes: torch.Tensor
    stats: torch.Tensor
    trees: torch.Tensor
    tree_start: np.ndarray
    feat_range: Tuple[int, int]
    plans: Dict[tuple, "ForestPlan"] = field(default_factory=dict, repr=False)

    @property
    def device(self) -> torch.device:
        return self.nodes.device

    @property
    def n_trees(self) -> int:
        return len(self.tree_start) - 1

    @property
    def n_records(self) -> int:
        return int(self.tree_start[-1])

    def to(self, device) -> "NodeTable":
        """The table on ``device``, its three tensors moved in one copy (a
        copy from pageable host memory waits for the card's queue)."""
        R, T1 = self.nodes.shape[0], self.trees.shape[0]
        flat = torch.cat([self.nodes.reshape(-1), self.stats.reshape(-1).view(torch.int64),
                          self.trees.reshape(-1).view(torch.int64)]).to(device)
        return NodeTable(flat[:2 * R].view(R, 2), flat[2 * R:4 * R].view(torch.float64).view(R, 2),
                         flat[4 * R:].view(torch.int32).view(T1, 2), self.tree_start,
                         self.feat_range)

    @staticmethod
    def concat(tables: Sequence["NodeTable"]) -> "NodeTable":
        """One table for several forests' tables laid end to end (a fused
        plane): each table's ``left`` and first records move by the records
        before it."""
        offs = np.cumsum([0] + [t.n_records for t in tables])
        nodes, trees = [], []
        for t, off in zip(tables, offs):
            n = t.nodes.clone()
            n[:, 1] += int(off) << 32
            nodes.append(n)
            trees.append(t.trees[:-1] + torch.tensor([int(off), 0], dtype=torch.int32,
                                                     device=t.device))
        trees.append(tables[-1].trees[-1:] + torch.tensor([int(offs[-2]), 0], dtype=torch.int32,
                                                          device=tables[-1].device))
        branching = [t.feat_range for t in tables if t.feat_range[1] >= 0]
        feat_range = ((min(r[0] for r in branching), max(r[1] for r in branching))
                      if branching else (0, -1))
        return NodeTable(torch.cat(nodes), torch.cat([t.stats for t in tables]),
                         torch.cat(trees),
                         np.concatenate([t.tree_start[:-1] + o for t, o in zip(tables, offs)]
                                        + [offs[-1:]]),
                         feat_range)


def pack_nodes(feat, thr, child, mean, var, roots) -> Optional[NodeTable]:
    """The :class:`NodeTable` of a packed arena, on the arena's device; None
    where the arena is no forest (a node reached twice from the roots, or a
    branch back to itself), which the ``tiled`` route cannot renumber.

    A level-order walk from the roots gives every reached node a record and
    the two children of each branching node two adjacent records; a stable
    sort by tree then groups each tree's records, root first, and keeps
    siblings adjacent. A node whose children are both itself is a leaf
    (its ``thr`` becomes +inf, which routes it where it already goes)."""
    n = feat.shape[0]
    T = roots.shape[0]
    dev = feat.device
    kids = child.reshape(n, 2)
    leaf = (kids[:, 0] == torch.arange(n, device=dev)) & (kids[:, 1] == torch.arange(n, device=dev))
    fronts, owners, lefts, levels = [], [], [], []
    front, owner, total = roots.to(torch.int64), torch.arange(T, device=dev), 0
    while front.numel():
        if total + front.numel() > n:
            return None
        branch = ~leaf[front]
        nxt = total + front.numel()
        here = torch.arange(total, nxt, device=dev)
        lefts.append(torch.where(branch, nxt + 2 * (torch.cumsum(branch, 0) - 1), here))
        fronts.append(front)
        owners.append(owner)
        levels.append(torch.full_like(front, len(levels)))
        total = nxt
        front = kids[front[branch]].reshape(-1)
        owner = owner[branch].repeat_interleave(2)
    if total == 0:
        orig = torch.zeros(0, dtype=torch.int64, device=dev)
        owner = level = left_lo = orig
    else:
        orig, owner = torch.cat(fronts), torch.cat(owners)
        level, left_lo = torch.cat(levels), torch.cat(lefts)
    order = torch.argsort(owner, stable=True)
    where = torch.empty_like(order)
    where[order] = torch.arange(total, device=dev)
    src = orig[order]
    is_leaf = leaf[src]
    rec_feat = torch.where(is_leaf, 0, feat[src]).to(torch.int64)
    left = where[left_lo[order]]
    rec_thr = torch.where(is_leaf, torch.full_like(thr[src], float("inf")), thr[src])
    nodes = torch.stack([rec_thr.contiguous().view(torch.int64),
                         (rec_feat & 0xFFFFFFFF) | (left << 32)], 1)
    counts = torch.bincount(owner, minlength=T)
    start = torch.cat([torch.zeros(1, dtype=torch.int64, device=dev), torch.cumsum(counts, 0)])
    depth = torch.zeros(T, dtype=torch.int64, device=dev).scatter_reduce(
        0, owner, level, "amax", include_self=True)
    trees = torch.stack([start, torch.cat([depth, depth.new_zeros(1)])], 1).to(torch.int32)
    fb = rec_feat[~is_leaf]
    feat_range = (int(fb.min()), int(fb.max())) if fb.numel() else (0, -1)
    return NodeTable(nodes, torch.stack([mean[src], var[src]], 1), trees,
                     start.cpu().numpy(), feat_range)


@dataclass(frozen=True)
class ForestPlan:
    """How K1 takes a call. ``tiled``: ``tiles`` tiles of ``rows``
    candidates (X rows in shared memory at a stride of ``xstride``
    doubles) by ``groups`` groups of ``trees`` consecutive trees; a block
    of ``threads`` threads stages them, and its first ``rows * lanes``
    walk: thread (lane, row) walks trees ``lane, lane + lanes, ...`` of its
    group, four side by side; ``smem`` bytes of shared memory (the tile,
    then the largest group's records and tree entries)."""

    route: str
    rows: int = 0
    tiles: int = 0
    trees: int = 0
    groups: int = 0
    lanes: int = 0
    threads: int = 0
    xstride: int = 0
    smem: int = 0


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _group_records(start: np.ndarray, T: int, g: int) -> int:
    """Records of the largest group of ``g`` consecutive trees (groups
    start at multiples of g)."""
    first = np.arange(0, T, g)
    return int((start[np.minimum(first + g, T)] - start[first]).max())


def _smem(x_bytes: int, start: np.ndarray, T: int, g: int) -> int:
    """Shared memory of a tiled block: the X tile, the largest group's
    records, its tree entries (8 bytes each)."""
    return x_bytes + _group_records(start, T, g) * _RECORD + 8 * min(g, T)


def forest_plan(T: int, N: int, D: int, nodes: Optional[NodeTable],
                sms: int = 132) -> ForestPlan:
    """The route and tiling of K1 for T trees, N candidates of width D and
    the arena's node table (None where there is none), on a card of
    ``sms`` SMs. A pure function of its arguments: it reads the table's
    host fields only.

    ``tiled`` where the table exists, every branching record's feature lies
    in [0, D), and a tile of 32 rows or more fits in shared memory beside
    the largest tree: the largest tile that fits and still gives a tile an
    SM (else 32 rows: at the tuner's pools, small tiles and more trees a
    block beat large tiles on an H100, ``scripts/tuner_routes.py``); trees
    grouped so tiles x groups give at least
    ``_BLOCKS_PER_SM * sms`` blocks where the trees allow, each group as
    large as that leaves and its records fit beside the tile, and a
    thread a row for every four trees of a group (as many as the block
    holds). At 131072
    candidates the tiles alone fill the card and a group holds as many
    trees as fit. ``gather`` otherwise."""
    if T <= 0 or N <= 0 or D <= 0:
        raise ValueError(f"forest_eval: T = {T}, N = {N}, D = {D} must be positive")
    if nodes is None or nodes.n_trees != T:
        return ForestPlan("gather")
    lo, hi = nodes.feat_range
    if hi >= D or lo < 0:
        return ForestPlan("gather")
    start = nodes.tree_start
    biggest = int(np.diff(start).max())
    # odd, or twice an odd number for even D (rows start on 16 bytes, for
    # 16-byte copies): a warp's rows spread over the banks
    xstride = D | 1 if D % 2 else D + 2 * (D // 2 % 2 == 0)
    for rows in TILE_ROWS:
        if rows > 32 and _cdiv(N, rows) < sms:
            continue   # tiles this large leave SMs idle: take smaller ones
        x_bytes = _cdiv(rows * xstride, 2) * 16
        if x_bytes + biggest * _RECORD + 8 <= SMEM_MAX:
            break
    else:
        return ForestPlan("gather")
    tiles = _cdiv(N, rows)
    g = max(1, T // max(1, _cdiv(_BLOCKS_PER_SM * sms, tiles)))
    while g > 1 and _smem(x_bytes, start, T, g) > SMEM_MAX:
        g -= 1
    lanes = max(1, min(_cdiv(g, _BATCH), _MAX_THREADS // rows))
    return ForestPlan("tiled", rows, tiles, g, _cdiv(T, g), lanes,
                      max(rows * lanes, _STAGE_THREADS), xstride, _smem(x_bytes, start, T, g))


def _check_arena(feat, thr, child, mean, var, roots, X) -> Tuple[int, int, int]:
    dev = X.device
    n_nodes = feat.shape[0]
    T = roots.shape[0]
    N, D = X.shape
    if T > _MAX_TREES:
        raise ValueError(f"forest_eval: {T} trees > {_MAX_TREES}")
    check("feat", feat, torch.int64, (n_nodes,), dev)
    check("thr", thr, torch.float64, (n_nodes,), dev)
    check("child", child, torch.int64, (2 * n_nodes,), dev)
    check("mean", mean, torch.float64, (n_nodes,), dev)
    check("var", var, torch.float64, (n_nodes,), dev)
    check("roots", roots, torch.int64, (T,), dev)
    check("X", X, torch.float64, (N, D), dev)
    return T, N, D


def forest_eval_cuda(feat, thr, child, mean, var, roots, X, depth: int,
                     nodes: Optional[NodeTable] = None, route: Optional[str] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the card; all tensors on one CUDA device. ``nodes`` is
    the arena's :class:`NodeTable` on that device (built here, through the
    host, where it is not given); ``route`` forces a route (default
    :func:`forest_plan`'s)."""
    T, N, D = _check_arena(feat, thr, child, mean, var, roots, X)
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"forest_eval: the CUDA kernel needs tensors on the card, got {dev}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"forest_eval: unknown route {route!r} (one of {ROUTES})")
    m_out = torch.empty((T, N), dtype=torch.float64, device=dev)
    v_out = torch.empty((T, N), dtype=torch.float64, device=dev)
    if T == 0 or N == 0:
        return m_out, v_out
    if route != "gather" and nodes is None:
        built = pack_nodes(*(t.cpu() for t in (feat, thr, child, mean, var, roots)))
        nodes = None if built is None else built.to(dev)
    if nodes is None or not D:
        plan = ForestPlan("gather")
    else:
        key = (T, N, D, n_sms(dev))
        plan = nodes.plans.get(key) or nodes.plans.setdefault(key, forest_plan(*key[:3], nodes,
                                                                                 key[3]))
    route = route or plan.route
    if route == "gather":
        launch("forest_eval", "forest_eval_launch", dev,
               (feat, thr, child, mean, var, roots, X, m_out, v_out),
               (T, N, D, int(depth)), route="gather")
        return m_out, v_out
    if plan.route != "tiled":
        raise ValueError("forest_eval: the tiled route needs a forest whose features lie in X's "
                         "width and whose tile and largest tree fit in shared memory")
    R = nodes.n_records
    check("nodes.nodes", nodes.nodes, torch.int64, (R, 2), dev)
    check("nodes.stats", nodes.stats, torch.float64, (R, 2), dev)
    return forest_eval_records(nodes.nodes, nodes.stats, nodes.trees, X, plan, depth,
                               (m_out, v_out))


def uniform_plan(T: int, N: int, D: int, records: int, sms: int = 132) -> ForestPlan:
    """:func:`forest_plan`'s ``tiled`` plan for T trees of at most
    ``records`` records each whose features lie in [0, D): it serves every
    such forest, so a CUDA graph can bake it in and replay it for any of
    them."""
    start = np.arange(T + 1, dtype=np.int64) * int(records)
    shape = SimpleNamespace(n_trees=T, feat_range=(0, D - 1), tree_start=start)
    return forest_plan(T, N, D, shape, sms)


def forest_eval_records(nodes: torch.Tensor, stats: torch.Tensor, trees: torch.Tensor,
                        X: torch.Tensor, plan: ForestPlan, depth: int,
                        out: Optional[Tuple[torch.Tensor, torch.Tensor]] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's ``tiled`` route on a node table's tensors alone (``nodes`` (R,
    2) int64, ``stats`` (R, 2) float64, ``trees`` (T + 1, 2) int32, T =
    rows of ``out``) under ``plan``, which must hold every group of
    ``plan.trees`` trees' records. No host work but the launch: a CUDA
    graph captures it. A tree walks at most ``depth`` levels."""
    dev = X.device
    N, D = X.shape
    T = trees.shape[0] - 1
    if plan.route != "tiled":
        raise ValueError(f"forest_eval: a records launch needs a tiled plan, got {plan.route}")
    if out is None:
        out = (torch.empty((T, N), dtype=torch.float64, device=dev),
               torch.empty((T, N), dtype=torch.float64, device=dev))
    check("nodes", nodes, torch.int64, (-1, 2), dev)
    check("stats", stats, torch.float64, (nodes.shape[0], 2), dev)
    check("trees", trees, torch.int32, (T + 1, 2), dev)
    check("X", X, torch.float64, (N, D), dev)
    for name, o in zip(("m_out", "v_out"), out):
        check(name, o, torch.float64, (T, N), dev)
    if T == 0 or N == 0:
        return out
    launch("forest_eval", "forest_eval_tiled_launch", dev,
           (nodes, stats, trees, X, out[0], out[1]),
           (T, N, D, int(depth), plan.rows, plan.xstride, plan.trees, plan.lanes, plan.threads,
            int(D % 2 == 0 and X.data_ptr() % 16 == 0), plan.smem),
           route="tiled")
    return out


def forest_eval(feat, thr, child, mean, var, roots, X, depth: int,
                nodes: Optional[NodeTable] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tree (mean, var) over the packed arena, each (n_trees, n_points).
    ``nodes``, the arena's node table, serves the card only."""
    if X.device.type == "cuda":
        return forest_eval_cuda(feat, thr, child, mean, var, roots, X, depth, nodes)
    if X.device.type != "cpu":
        raise ValueError(f"forest_eval: unsupported device {X.device}")
    PLAIN_CALLS["forest_eval"] += 1
    return forest_eval_plain(feat, thr, child, mean, var, roots, X, depth)
