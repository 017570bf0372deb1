"""Surrogate models for Bayesian optimization (port of ``repro.core.surrogate``).

The surrogate is a Probabilistic Random Forest (paper §3.3, the SMAC-style
forest): an ensemble of randomized regression trees over the unit-cube
encoding; the predictive mean is the mean of per-tree leaf means and the
predictive variance combines across-tree disagreement with within-leaf
empirical variance (law of total variance).

Fitting stays on the host in numpy: the level-synchronous frontier builder
is carried from the reference, so trees are bit-identical. Inference runs
on a device: ``pack()`` stacks all trees into one :class:`PackedForest`
node arena held as tensors, and :class:`ForestPlane` fuses several arenas
so every source of the combined surrogate (§6.2) is scored in one descent.
The descent is kernel K1 (``kernels/forest_eval/ops.py``): CUDA on the
card, its plain torch version on the CPU. The ensemble combine is float64
torch in numpy's reduction order (``repro_torch.numerics``), so (mean,
var) match the reference bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from .. import obs as _obs
from ..device import DeviceLike, resolve_device
from ..kernels.forest_eval.ops import NodeTable, forest_eval, pack_nodes
from ..numerics import div_scalar, reduce_sum

__all__ = [
    "RegressionTree",
    "ProbabilisticRandomForest",
    "PackedForest",
    "ForestPlane",
    "Surrogate",
    "GaussianProcess",
    "combine",
    "make_forest",
]


class Surrogate:
    """Minimal interface all surrogates implement."""

    def fit(self, X: np.ndarray, y: np.ndarray) -> "Surrogate":
        raise NotImplementedError

    def predict(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Return (mean, variance), each shape (n,)."""
        raise NotImplementedError

    def predict_mean(self, X: np.ndarray) -> np.ndarray:
        return self.predict(X)[0]


# ---------------------------------------------------------------------------
# Regression trees / random forest
# ---------------------------------------------------------------------------


@dataclass
class _Node:
    feature: int = -1            # -1 => leaf
    threshold: float = 0.0
    left: int = -1
    right: int = -1
    mean: float = 0.0
    var: float = 0.0
    n: int = 0


_MASK64 = (1 << 64) - 1
_GOLDEN = 0x9E3779B97F4A7C15


def _splitmix64(z: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer over uint64 arrays (wrapping mod 2^64)."""
    z = (z ^ (z >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    z = (z ^ (z >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return z ^ (z >> np.uint64(31))


def _child_seeds(seeds: np.ndarray, right: int) -> np.ndarray:
    """Traversal-order-independent per-node seed chain (splitmix64-style),
    derived for a whole frontier of parent seeds in one array pass.

    The reference's recursive and frontier builders both derive each
    node's feature-subset stream from this chain; the port carries the
    frontier builder.
    """
    z = np.asarray(seeds, dtype=np.uint64) + np.uint64((_GOLDEN * (right + 1)) & _MASK64)
    return _splitmix64(z) & np.uint64((1 << 63) - 1)


def _feature_subsets(seeds: np.ndarray, d: int, k: int) -> np.ndarray:
    """Per-node random k-of-d feature subsets for a whole frontier at once.

    A partial Fisher-Yates driven by a splitmix64 counter stream per node:
    k vectorized swap steps replace one ``Generator`` construction plus a
    ``permutation`` call *per node* — the dominant Python cost of a frontier
    level. Deterministic in the node seed (modulo bias at d <= 64 vs 2^64
    states is negligible).
    """
    seeds = np.asarray(seeds, dtype=np.uint64)
    W = len(seeds)
    perm = np.broadcast_to(np.arange(d), (W, d)).copy()
    rows = np.arange(W)
    state = seeds
    for i in range(min(k, d)):
        state = state + np.uint64(_GOLDEN)
        draw = _splitmix64(state)
        j = i + (draw % np.uint64(d - i)).astype(np.int64)
        pi = perm[rows, i].copy()
        perm[rows, i] = perm[rows, j]
        perm[rows, j] = pi
    return perm[:, :k]


class RegressionTree:
    """CART regression tree with random feature subsetting at each split.

    Host numpy, carried from the reference: the ``"frontier"`` builder
    grows the tree one *level* at a time — a vectorized best-split scan over
    all active nodes per depth against a shared presorted feature order —
    with the reference's op sequence, so fitted trees are bit-identical to
    the reference's.
    """

    def __init__(
        self,
        max_depth: int = 12,
        min_samples_split: int = 4,
        min_samples_leaf: int = 2,
        max_features: Optional[int] = None,
        rng: Optional[np.random.Generator] = None,
        root_seed: Optional[int] = None,
    ):
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.max_features = max_features
        self.rng = rng or np.random.default_rng()
        # explicit root of the per-node seed chain (forest fits derive all
        # tree roots in one array pass); None = draw from self.rng
        self.root_seed = root_seed
        self.nodes: List[_Node] = []

    def _n_features(self, d: int) -> int:
        k = self.max_features or max(1, int(np.ceil(d / 1.5)))
        return min(k, d)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "RegressionTree":
        X = np.asarray(X, dtype=float)
        y = np.asarray(y, dtype=float)
        self.nodes = []
        root_seed = self.root_seed if self.root_seed is not None else int(self.rng.integers(2**63))
        self._build_frontier(X, y, root_seed)
        self._freeze()
        return self

    def _new_node(self, ysub: np.ndarray) -> int:
        node = _Node()
        # raw ufunc reduces replay numpy's _mean/_var op sequence (pairwise
        # umr_sum, then the same subtract/square/divide) without the method
        # dispatch overhead — bit-identical to ysub.mean()/ysub.var(), which
        # dominates per-node cost in both builders
        n = len(ysub)
        m = np.add.reduce(ysub) / n
        dev = ysub - m
        node.mean = float(m)
        node.var = float(np.add.reduce(dev * dev) / n)
        node.n = n
        self.nodes.append(node)
        return len(self.nodes) - 1

    def _build_frontier(self, X: np.ndarray, y: np.ndarray, root_seed: int) -> None:
        """Level-synchronous builder: one vectorized split scan per depth.

        Per level, the samples of every splittable node are grouped (via one
        stable argsort against the shared presorted feature order) into
        padded (node, position) matrices, and the SSE of every candidate
        split of every node is computed in a few whole-frontier array ops.
        Per-node Python work shrinks to the feature-subset draw and the
        child bookkeeping. Arithmetic is arranged to be bit-identical to the
        recursion: padded rows reproduce each node's own cumsum sequence,
        and argmins keep the recursion's first-strict-min tie-breaking.
        """
        n, d = X.shape
        k = self._n_features(d)
        msl = self.min_samples_leaf
        mss = self.min_samples_split
        sorted_mat = np.argsort(X, axis=0, kind="stable") if n else np.zeros((0, d), np.int64)
        root_idx = np.arange(n)
        self._new_node(y[root_idx])
        # frontier entries: (nid, idx, seed, splittable) — the splittable
        # flag (count and ptp gates, same booleans as the recursion's) is
        # computed when the node is created, from the y-gather it needs
        # anyway, so the level filter does no per-node array work
        root_ok = bool(
            n >= mss and n > 0 and np.maximum.reduce(y) != np.minimum.reduce(y)
        )
        frontier: List[Tuple[int, np.ndarray, int, bool]] = [(0, root_idx, root_seed, root_ok)]
        level = 0
        cols = np.arange(d)
        # one errstate for the whole build (padded lanes divide by zero
        # before they are masked invalid) instead of one context per level
        with np.errstate(divide="ignore", invalid="ignore"):
            self._frontier_levels(X, y, frontier, sorted_mat, cols, k, msl, mss, level)

    def _frontier_levels(self, X, y, frontier, sorted_mat, cols, k, msl, mss, level) -> None:
        n, d = X.shape
        while frontier and level < self.max_depth:
            active = [t for t in frontier if t[3]]
            if not active:
                break
            W = len(active)
            counts = np.array([len(t[1]) for t in active], dtype=np.int64)
            M = int(counts.max())
            n_act = int(counts.sum())
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            slot_rep = np.repeat(np.arange(W), counts)
            cat = np.concatenate([t[1] for t in active])  # node-order sample ids
            # group every feature column by node in ONE stable argsort of the
            # (n, d) slot matrix: inactive samples carry sentinel W and sink
            # to the bottom; ties (same node) keep the presorted x-order
            slot_of = np.full(n, W, dtype=np.int64)
            slot_of[cat] = slot_rep
            gorder = np.argsort(slot_of[sorted_mat], axis=0, kind="stable")[:n_act]
            gidx = sorted_mat[gorder, cols[None, :]]  # (n_act, d)
            rowpos = np.arange(n_act) - starts[slot_rep]
            best_sse = np.full((W, d), np.inf)
            best_thr = np.zeros((W, d))
            # padded (node, position, feature) blocks: each (w, :, f) lane is
            # that node's feature-sorted value/target sequence, so the lane
            # cumsums replay the recursion's per-node cumsum bit-for-bit;
            # scatter by flat row index (node * M + position)
            dst = slot_rep * M + rowpos
            xs3 = np.zeros((W * M, d))
            ys3 = np.zeros((W * M, d))
            xs3[dst] = X[gidx, cols[None, :]]
            ys3[dst] = y[gidx]
            xs3 = xs3.reshape(W, M, d)
            ys3 = ys3.reshape(W, M, d)
            if M > 1:
                rows = np.arange(W)[:, None]
                pos = np.arange(1, M)
                nl = pos.astype(float)[None, :, None]
                cs = np.cumsum(ys3, axis=1)
                cs2 = np.cumsum(ys3**2, axis=1)
                sl = cs[:, :-1, :]
                s2l = cs2[:, :-1, :]
                tot = cs[rows[:, 0], counts - 1, :][:, None, :]
                tot2 = cs2[rows[:, 0], counts - 1, :][:, None, :]
                nr = counts[:, None, None] - nl
                sse = (s2l - sl**2 / nl) + ((tot2 - s2l) - (tot - sl) ** 2 / nr)
                valid = (
                    (pos[None, :, None] >= max(msl, 1))
                    & (pos[None, :, None] <= (counts[:, None] - max(msl, 1))[:, :, None])
                    & (xs3[:, :-1, :] < xs3[:, 1:, :])
                )
                sse = np.where(valid, sse, np.inf)
                j = np.argmin(sse, axis=1)  # (W, d): first minimum per lane
                # pos = arange(1, M), so lane argmin j maps to split position
                # j + 1; direct fancy gathers replace take_along_axis
                best_sse = sse[rows, j, cols[None, :]]
                bp = j + 1
                best_thr = 0.5 * (xs3[rows, bp - 1, cols[None, :]] + xs3[rows, bp, cols[None, :]])
            # whole-frontier feature pick + child masks: the per-node seed
            # chain and feature subsets come from one splitmix64 array
            # derivation (no per-node Generator constructions; the recursion
            # consumes the identical chain, so builders still agree
            # bit-for-bit); argmin over the perm gather keeps the
            # recursion's first-strict-min tie-breaking across features
            rows_w = np.arange(W)
            seeds_w = np.array([t[2] for t in active], dtype=np.uint64)
            lseeds = _child_seeds(seeds_w, 0)
            rseeds = _child_seeds(seeds_w, 1)
            P = _feature_subsets(seeds_w, d, k)
            FS = best_sse[rows_w[:, None], P]
            R = np.argmin(FS, axis=1)
            F = P[rows_w, R]
            split_ok = np.isfinite(FS[rows_w, R])
            THR = best_thr[rows_w, F]
            mask_flat = X[cat, np.repeat(F, counts)] <= np.repeat(THR, counts)
            next_frontier: List[Tuple[int, np.ndarray, int, bool]] = []
            for s in np.flatnonzero(split_ok):
                nid, idx, seed, _ = active[s]
                a = starts[s]
                m = mask_flat[a : a + counts[s]]
                li, ri = idx[m], idx[~m]
                if len(li) < msl or len(ri) < msl:
                    continue
                node = self.nodes[nid]
                node.feature = int(F[s])
                node.threshold = float(THR[s])
                yl, yr = y[li], y[ri]
                node.left = self._new_node(yl)
                node.right = self._new_node(yr)
                next_frontier.append((
                    node.left, li, int(lseeds[s]),
                    len(li) >= mss and np.maximum.reduce(yl) != np.minimum.reduce(yl),
                ))
                next_frontier.append((
                    node.right, ri, int(rseeds[s]),
                    len(ri) >= mss and np.maximum.reduce(yr) != np.minimum.reduce(yr),
                ))
            frontier = next_frontier
            level += 1

    def _freeze(self) -> None:
        """Pack nodes into arrays for vectorized descent."""
        n = len(self.nodes)
        self._feat = np.array([nd.feature for nd in self.nodes], dtype=np.int64)
        self._thr = np.array([nd.threshold for nd in self.nodes], dtype=float)
        self._left = np.array([nd.left for nd in self.nodes], dtype=np.int64)
        self._right = np.array([nd.right for nd in self.nodes], dtype=np.int64)
        self._mean = np.array([nd.mean for nd in self.nodes], dtype=float)
        self._var = np.array([nd.var for nd in self.nodes], dtype=float)
        # actual depth (children are appended after their parent, so one
        # forward pass assigns levels top-down)
        level = np.zeros(n, dtype=np.int64)
        depth = 0
        for i in range(n):
            if self._feat[i] >= 0:
                child_level = level[i] + 1
                level[self._left[i]] = child_level
                level[self._right[i]] = child_level
                depth = max(depth, int(child_level))
        self._depth = depth

    def predict(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """Vectorized descent: O(depth * n) per call."""
        X = np.atleast_2d(np.asarray(X, dtype=float))
        if not hasattr(self, "_feat"):
            self._freeze()
        nid = np.zeros(len(X), dtype=np.int64)
        for _ in range(self.max_depth + 1):
            feat = self._feat[nid]
            active = feat >= 0
            if not active.any():
                break
            ai = np.where(active)[0]
            f = feat[ai]
            go_left = X[ai, f] <= self._thr[nid[ai]]
            nid[ai] = np.where(go_left, self._left[nid[ai]], self._right[nid[ai]])
        return self._mean[nid], self._var[nid]


# ---------------------------------------------------------------------------
# Packed forest plane (struct-of-arrays ensemble inference on a device)
# ---------------------------------------------------------------------------


def combine(m_t: torch.Tensor, v_t: torch.Tensor, y_mean, y_std, y_std_sq
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Ensemble (mean, var) from per-tree stats over axis -2.

    ``m_t``/``v_t`` are (T, N) for one forest or (S, T, N) for S forests
    of T trees each, with ``y_mean``/``y_std``/``y_std_sq`` floats or (S,)
    tensors. ``y_std_sq`` is Python's ``y_std**2``, which is not always
    ``y_std * y_std``. Replays ``PackedForest.combine`` of the reference: numpy's
    ``mean(axis=0)`` and ``var(axis=0)`` (ddof=0, mean first, then the
    mean of squared deviations) in numpy's add order, the 1e-10 floor and
    the denormalization.
    """
    T = m_t.shape[-2]
    dim = m_t.dim() - 2
    mean = div_scalar(reduce_sum(m_t, dim), T)
    dev = m_t - mean.unsqueeze(dim)
    var = div_scalar(reduce_sum(v_t, dim), T) + div_scalar(reduce_sum(dev * dev, dim), T)
    var = torch.clamp_min(var, 1e-10)
    if isinstance(y_std, torch.Tensor):
        return mean * y_std[:, None] + y_mean[:, None], var * y_std_sq[:, None]
    return mean * y_std + y_mean, var * y_std_sq


@dataclass
class PackedForest:
    """All trees of one forest stacked into a struct-of-arrays node arena.

    Tensors on ``device``. ``feat``/``thr``/``mean``/``var`` are per-node
    (leaves: feat clamped to 0, thr = +inf); ``child`` holds the
    interleaved (left, right) pointers rebased to arena indices, with
    leaves pointing at themselves; ``roots`` holds each tree's root index.
    ``y_mean``/``y_std`` carry the fit-time target normalization. On the
    card, ``node_table()`` is the arena renumbered for K1's ``tiled`` route:
    built once on the host (from the host arrays where ``from_arrays`` has
    them), moved to the card on first use alone; a plane concatenates the
    host tables and moves the whole once.
    """

    feat: torch.Tensor        # (n_nodes,) int64
    thr: torch.Tensor         # (n_nodes,) float64
    child: torch.Tensor       # (2 * n_nodes,) int64
    mean: torch.Tensor        # (n_nodes,) float64
    var: torch.Tensor         # (n_nodes,) float64
    roots: torch.Tensor       # (n_trees,) int64
    depth: int                # max tree depth in the arena
    y_mean: float = 0.0
    y_std: float = 1.0
    _host_nodes: Optional[Tuple[Optional[NodeTable]]] = field(
        default=None, init=False, repr=False, compare=False)
    _nodes: Optional[NodeTable] = field(default=None, init=False, repr=False, compare=False)

    @property
    def device(self) -> torch.device:
        return self.feat.device

    def host_node_table(self) -> Optional[NodeTable]:
        """K1's node table of this arena on the host (None where the arena is
        no forest), built on first use."""
        if self._host_nodes is None:
            self._host_nodes = (pack_nodes(*(getattr(self, k).cpu() for k in
                                             ("feat", "thr", "child", "mean", "var", "roots"))),)
        return self._host_nodes[0]

    def node_table(self) -> Optional[NodeTable]:
        """The same on the arena's device, moved there on first use."""
        host = self.host_node_table()
        if host is not None and self._nodes is None:
            self._nodes = host.to(self.device)
        return None if host is None else self._nodes

    @property
    def n_trees(self) -> int:
        return int(self.roots.shape[0])

    @property
    def n_nodes(self) -> int:
        return int(self.feat.shape[0])

    def host_arrays(self) -> Dict[str, np.ndarray]:
        """The arena as numpy arrays (for host-side plan building)."""
        return {k: getattr(self, k).cpu().numpy()
                for k in ("feat", "thr", "child", "mean", "var", "roots")}

    @staticmethod
    def from_arrays(feat, thr, child, mean, var, roots, depth: int,
                    y_mean: float = 0.0, y_std: float = 1.0,
                    device: DeviceLike = None) -> "PackedForest":
        """Upload numpy arena arrays (the reference's field layout)."""
        dev = resolve_device(device)
        host = {k: torch.from_numpy(np.ascontiguousarray(a, dtype=dt)) for k, a, dt in (
            ("feat", feat, np.int64), ("thr", thr, np.float64), ("child", child, np.int64),
            ("mean", mean, np.float64), ("var", var, np.float64), ("roots", roots, np.int64))}
        packed = PackedForest(**{k: t.to(dev) for k, t in host.items()}, depth=int(depth),
                              y_mean=float(y_mean), y_std=float(y_std))
        if dev.type == "cuda":
            packed._host_nodes = (pack_nodes(*host.values()),)
        return packed

    @staticmethod
    def from_trees(
        trees: Sequence[RegressionTree], y_mean: float = 0.0, y_std: float = 1.0,
        device: DeviceLike = None,
    ) -> "PackedForest":
        feat, thr, child, mean, var, roots = [], [], [], [], [], []
        off = 0
        depth = 0
        for tree in trees:
            if not hasattr(tree, "_feat"):
                tree._freeze()
            n = len(tree._feat)
            leaf = tree._feat < 0
            feat.append(np.where(leaf, 0, tree._feat))
            thr.append(np.where(leaf, np.inf, tree._thr))
            self_idx = np.arange(n)
            left = np.where(leaf, self_idx, tree._left) + off
            right = np.where(leaf, self_idx, tree._right) + off
            child.append(np.stack([left, right], axis=1).reshape(-1))
            mean.append(tree._mean)
            var.append(tree._var)
            roots.append(off)
            depth = max(depth, tree._depth)
            off += n
        return PackedForest.from_arrays(
            np.concatenate(feat), np.concatenate(thr), np.concatenate(child),
            np.concatenate(mean), np.concatenate(var), np.asarray(roots),
            depth, y_mean, y_std, device=device,
        )

    # ------------------------------------------------------------- inference
    def predict_trees(self, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """Per-tree leaf stats through K1, each (n_trees, n_points)."""
        nodes = self.node_table() if X.device.type == "cuda" else None
        return forest_eval(self.feat, self.thr, self.child, self.mean, self.var,
                           self.roots, X, self.depth, nodes)

    def combine(self, m_t: torch.Tensor, v_t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return combine(m_t, v_t, self.y_mean, self.y_std, self.y_std**2)

    def predict(self, X: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        return self.combine(*self.predict_trees(X))


def as_points(X, device: torch.device) -> torch.Tensor:
    """A contiguous float64 (n, d) tensor on ``device`` from numpy or torch."""
    if isinstance(X, torch.Tensor):
        t = X.to(device=device, dtype=torch.float64)
    else:
        t = torch.from_numpy(np.ascontiguousarray(np.asarray(X, dtype=np.float64))).to(device)
    if t.dim() == 1:
        t = t[None, :]
    return t.contiguous()


class ForestPlane:
    """Several packed forests fused into one arena for multi-source predict.

    The combined surrogate (one PRF per source task plus one per fidelity
    level, §6.2) evaluates every source on the same candidate pool; fusing
    the arenas means one K1 descent over all sources' trees. Per-source
    combination still runs on each forest's own tree slice, so the output
    matches per-forest ``predict`` bit for bit.
    """

    def __init__(self, forests: Sequence[PackedForest]):
        if not forests:
            raise ValueError("ForestPlane needs at least one forest")
        self.forests = list(forests)
        self.device = forests[0].device
        if any(f.device != self.device for f in forests):
            raise ValueError("ForestPlane forests must share one device")
        offs = np.cumsum([0] + [f.n_nodes for f in forests])
        self.feat = torch.cat([f.feat for f in forests])
        self.thr = torch.cat([f.thr for f in forests])
        self.child = torch.cat([f.child + int(off) for f, off in zip(forests, offs)])
        self.mean = torch.cat([f.mean for f in forests])
        self.var = torch.cat([f.var for f in forests])
        self.roots = torch.cat([f.roots + int(off) for f, off in zip(forests, offs)])
        self.depth = max(f.depth for f in forests)
        tree_counts = np.cumsum([0] + [f.n_trees for f in forests])
        self.tree_slices = [
            (int(a), int(b)) for a, b in zip(tree_counts[:-1], tree_counts[1:])
        ]
        self.y_means, self.y_stds, self.y_std_sqs = (
            torch.tensor(v, dtype=torch.float64, device=self.device)
            for v in zip(*[(f.y_mean, f.y_std, f.y_std**2) for f in forests])
        )
        self._nodes: Optional[Tuple[Optional[NodeTable]]] = None

    def node_table(self) -> Optional[NodeTable]:
        """K1's node table of the fused arena on its device: the forests'
        host tables laid end to end and moved in one copy, on first use
        (None where one arena is no forest)."""
        if self._nodes is None:
            tables = [f.host_node_table() for f in self.forests]
            self._nodes = (None if any(t is None for t in tables)
                           else NodeTable.concat(tables).to(self.device),)
        return self._nodes[0]

    @property
    def uniform_tree_count(self) -> Optional[int]:
        """Trees per source when all sources agree, else None."""
        counts = {f.n_trees for f in self.forests}
        return next(iter(counts)) if len(counts) == 1 else None

    def predict(self, X) -> Tuple[torch.Tensor, torch.Tensor]:
        """Fused multi-source predict: (means, vars), each (S, N) on the
        plane's device."""
        X = as_points(X, self.device)
        _obs.count("forest_plane/device")
        nodes = self.node_table() if X.device.type == "cuda" else None
        m_t, v_t = forest_eval(self.feat, self.thr, self.child, self.mean, self.var,
                               self.roots, X, self.depth, nodes)
        tps = self.uniform_tree_count
        if tps is not None:
            S, N = len(self.forests), X.shape[0]
            return combine(m_t.reshape(S, tps, N), v_t.reshape(S, tps, N),
                           self.y_means, self.y_stds, self.y_std_sqs)
        parts = [f.combine(m_t[a:b], v_t[a:b])
                 for (a, b), f in zip(self.tree_slices, self.forests)]
        return torch.stack([p[0] for p in parts]), torch.stack([p[1] for p in parts])


class ProbabilisticRandomForest(Surrogate):
    """PRF surrogate: host numpy fit, device inference through K1.

    ``device=None`` means the CUDA card (raises without one); pass
    ``device="cpu"`` for the plain versions. ``predict`` takes and returns
    numpy arrays, the surrogate interface the host-side tuner uses;
    ``pack()`` gives the device arena for tensor callers.
    """

    def __init__(
        self,
        n_trees: int = 10,
        max_depth: int = 12,
        min_samples_split: int = 4,
        min_samples_leaf: int = 1,
        bootstrap: bool = True,
        seed: int = 0,
        device: DeviceLike = None,
    ):
        self.n_trees = n_trees
        self.max_depth = max_depth
        self.min_samples_split = min_samples_split
        self.min_samples_leaf = min_samples_leaf
        self.bootstrap = bootstrap
        self.seed = seed
        self.device = resolve_device(device)
        self.trees: List[RegressionTree] = []
        self._packed: Optional[PackedForest] = None
        self._y_mean = 0.0
        self._y_std = 1.0
        self.X_: Optional[np.ndarray] = None
        self.y_: Optional[np.ndarray] = None

    def fit(self, X: np.ndarray, y: np.ndarray) -> "ProbabilisticRandomForest":
        X = np.atleast_2d(np.asarray(X, dtype=float))
        y = np.asarray(y, dtype=float)
        _obs.count("surrogate/fits")
        _obs.observe("surrogate/fit_n_obs", float(len(y)))
        self.X_, self.y_ = X, y
        self._y_mean = float(y.mean()) if len(y) else 0.0
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        rng = np.random.default_rng(self.seed)
        self.trees = []
        self._packed = None
        n = len(y)
        # one PCG64 array draw seeds a splitmix64 counter stream per tree,
        # which yields every tree's bootstrap rows and the root of its
        # per-node seed chain (the reference's draws, call for call)
        tree_seeds = rng.integers(2**63, size=self.n_trees, dtype=np.uint64)
        root_seeds = _splitmix64(tree_seeds ^ np.uint64(0xD1B54A32D192ED03)) & np.uint64(
            (1 << 63) - 1
        )
        if self.bootstrap and n > 1:
            ctr = tree_seeds[:, None] + np.uint64(_GOLDEN) * np.arange(
                1, n + 1, dtype=np.uint64
            )
            boot = (_splitmix64(ctr) % np.uint64(n)).astype(np.intp)
        else:
            boot = np.broadcast_to(np.arange(n), (self.n_trees, n))
        for t in range(self.n_trees):
            tree = RegressionTree(
                max_depth=self.max_depth,
                min_samples_split=self.min_samples_split,
                min_samples_leaf=self.min_samples_leaf,
                root_seed=int(root_seeds[t]),
            )
            tree.fit(X[boot[t]], yn[boot[t]])
            self.trees.append(tree)
        return self

    def pack(self) -> PackedForest:
        """Stack all trees into one device arena (cached per fit)."""
        if not self.trees:
            raise ValueError("pack() before fit()")
        if self._packed is None:
            self._packed = PackedForest.from_trees(
                self.trees, self._y_mean, self._y_std, device=self.device
            )
        return self._packed

    def predict_tensor(self, X) -> Tuple[torch.Tensor, torch.Tensor]:
        """(mean, var) tensors on the forest's device."""
        X = as_points(X, self.device)
        if not self.trees:
            n = X.shape[0]
            return (torch.zeros(n, dtype=torch.float64, device=self.device),
                    torch.ones(n, dtype=torch.float64, device=self.device))
        return self.pack().predict(X)

    def predict(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        mean, var = self.predict_tensor(X)
        return mean.cpu().numpy(), var.cpu().numpy()


# ---------------------------------------------------------------------------
# Forest factory — the one PRF construction point the whole package shares
# ---------------------------------------------------------------------------


def make_forest(seed: int = 0, device: DeviceLike = None, **kwargs) -> ProbabilisticRandomForest:
    """Every surrogate stack in the port builds PRFs here."""
    return ProbabilisticRandomForest(seed=seed, device=device, **kwargs)


# ---------------------------------------------------------------------------
# Gaussian process (for the Tuneful MTGP baseline)
# ---------------------------------------------------------------------------


class GaussianProcess(Surrogate):
    """Exact GP with Matérn-5/2 kernel, constant mean, jitter + noise MLE-lite.

    Hyperparameters are set by a small grid search over (lengthscale, noise)
    maximizing the log marginal likelihood — adequate at these data sizes.

    The fit and the prediction stay on the host in numpy, the reference's own
    arithmetic: a Cholesky factor and triangular solves through torch round
    differently, and the Tuneful baseline that uses this GP is held to the
    reference's observation stream bit for bit. The GP takes no device.
    """

    def __init__(self, lengthscales=(0.1, 0.2, 0.5, 1.0, 2.0), noises=(1e-6, 1e-4, 1e-2)):
        self.lengthscales = lengthscales
        self.noises = noises
        self.X_: Optional[np.ndarray] = None
        self.alpha_: Optional[np.ndarray] = None
        self.L_: Optional[np.ndarray] = None
        self.ls_: float = 0.5
        self.noise_: float = 1e-4
        self._y_mean = 0.0
        self._y_std = 1.0

    @staticmethod
    def _matern52(A: np.ndarray, B: np.ndarray, ls: float) -> np.ndarray:
        d2 = np.maximum(
            (A**2).sum(1)[:, None] + (B**2).sum(1)[None, :] - 2 * A @ B.T, 0.0
        )
        r = np.sqrt(d2) / ls
        s5r = np.sqrt(5.0) * r
        return (1 + s5r + 5 * d2 / (3 * ls**2)) * np.exp(-s5r)

    def fit(self, X: np.ndarray, y: np.ndarray) -> "GaussianProcess":
        X = np.atleast_2d(np.asarray(X, dtype=float))
        y = np.asarray(y, dtype=float)
        self._y_mean = float(y.mean()) if len(y) else 0.0
        self._y_std = float(y.std()) or 1.0
        yn = (y - self._y_mean) / self._y_std
        best = (np.inf, None)
        n = len(X)
        for ls in self.lengthscales:
            K0 = self._matern52(X, X, ls)
            for noise in self.noises:
                K = K0 + (noise + 1e-8) * np.eye(n)
                try:
                    L = np.linalg.cholesky(K)
                except np.linalg.LinAlgError:
                    continue
                alpha = np.linalg.solve(L.T, np.linalg.solve(L, yn))
                nll = 0.5 * yn @ alpha + np.log(np.diag(L)).sum()
                if nll < best[0]:
                    best = (nll, (ls, noise, L, alpha))
        if best[1] is None:
            raise RuntimeError("GP fit failed")
        self.ls_, self.noise_, self.L_, self.alpha_ = best[1]
        self.X_ = X
        return self

    def predict(self, X: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        X = np.atleast_2d(np.asarray(X, dtype=float))
        Ks = self._matern52(X, self.X_, self.ls_)
        mean = Ks @ self.alpha_
        v = np.linalg.solve(self.L_, Ks.T)
        var = np.maximum(1.0 - (v**2).sum(axis=0), 1e-10)
        return mean * self._y_std + self._y_mean, var * self._y_std**2
