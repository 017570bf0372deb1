"""Bitvector chain evaluator for the batched Shapley plane (kernel K3).

The §5.1 attribution path evaluates, per (config, permutation) chain, the
(d+1) prefix-composite rows ``z_S`` (x on the prefix set S, background
elsewhere) averaged over every background row. As in the reference
(``repro/kernels/forest_eval/chain.py``) this is a QuickScorer-style
bitvector evaluation (Lucchese et al., SIGIR'15):

* Each tree's leaves get ordinals in left-to-right order, packed into
  ``W`` uint64 leaf words per tree (W = 1 up to 64 leaves, W = 2 up to
  128). Every internal node carries masks clearing its left subtree's leaf
  bits; a row's exit leaf is the lowest set bit across the ANDed words of
  all *false* nodes (``v > thr``) — word 0 scanned first.
* Per feature the split thresholds are sorted and their masks
  prefix-ANDed, so the false set of a value v with rank r = #(thr < v) is
  one table row (:meth:`ChainPlan.row_words`, on the host).
* A composite row's AND factorizes along the permutation: the prefix-AND
  of x-term words and the suffix-AND of background-term words. The walk
  over (chain, level, background row) is kernel K3:
  :func:`chain_ordinals` launches ``csrc/chain_ordinals.cu`` for tensors on
  the card and takes :func:`chain_ordinals_plain` (torch int64 bit ops)
  for tensors on the CPU. On the card the walk takes the route
  :func:`ordinals_plan` picks: ``staged`` (background and chain words
  copied into shared memory, a block a chain, or a grid of chain groups and
  tree tiles where a block cannot hold every tree) or ``per_chain``, the
  first design (one block a chain, words read from device memory), where
  one tree's background words do not fit a block.

The float tail (leaf-mean gather, the tree mean and the background mean)
runs in numpy's reduction order (``repro_torch.numerics``), so chain values
are bit-identical to the reference's ``eval_chains``. :func:`chain_values`
computes them: on the CPU :func:`chain_values_plain` (the plain walk, then
the torch tail :func:`chain_tail`); on the card the ``values`` route, K3
with the tail fused, where :func:`values_plan` lets one block hold every
tree, else the ordinals' route and :func:`chain_tail`. Each launch adds to
``counts.ROUTE_LAUNCHES["chain_ordinals/<route>"]``; no route makes a host
sync, and a CUDA tensor never reaches a plain version.

``build_chain_plan_ex`` returns ``(plan, reason)`` — ``(None, why)`` when
the encoding does not apply (a tree with more than 128 leaves, or more
than 64 features); callers fall back to the composite-tensor path.
Values must be NaN-free (threshold ranks come from ``np.searchsorted``).

:class:`PoolPlan` (``build_pool_plan_ex``) is the reference's chain-delta
pool scoring, host numpy as in the reference and with no kernel: the same
false-word tables over a fused arena route a mutation pool's candidates to
their leaves, re-ANDing only the coordinates that differ from each
candidate's base incumbent. ``ForestPlane.predict(X, "numpy", delta=...)``
takes it on the host route.
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...numerics import div_scalar, pairwise_sum, sequential_sum
from ..counts import PLAIN_CALLS
from ..launch import check, launch, n_sms

__all__ = [
    "ROUTES",
    "VALUE_ROUTES",
    "ChainPlan",
    "PoolPlan",
    "WalkPlan",
    "pack_leaf_spans",
    "build_false_tables",
    "build_chain_plan_ex",
    "build_pool_plan_ex",
    "chain_ordinals",
    "chain_ordinals_cuda",
    "chain_ordinals_plain",
    "chain_tail",
    "chain_values",
    "chain_values_cuda",
    "chain_values_plain",
    "ordinals_plan",
    "staged_plan",
    "values_plan",
    "words_tensor",
]

_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)
_PLAN_ATTR = "_chain_plan_cache"
_POOL_PLAN_ATTR = "_pool_plan_cache"

# the widest supported leaf word vector: 2 x uint64 = 128 leaves per tree
MAX_LEAF_WORDS = 2

ROUTES = ("staged", "per_chain")          # the ordinals' routes on the card
VALUE_ROUTES = ("values",) + ROUTES       # the chain values' routes


# ---------------------------------------------------------------------------
# shared packer: leaf-ordinal walk + per-feature false-set tables
# ---------------------------------------------------------------------------


def pack_leaf_spans(feat, thr, child, mean, var, roots, d):
    """Walk every tree of a packed arena, assigning leaf ordinals
    left-to-right and collecting per-feature split spans.

    Returns ``(payload, reason)`` where payload is ``None`` with a decline
    reason, or ``(nodes_by_feat, leaf_mean, leaf_var, leaf_offs, n_words)``:

    * nodes_by_feat[j] — list of ``(thr, tree, lo, mid)`` spans: the node
      splits feature j at thr, and its false mask clears leaf ordinals
      [lo, mid) of that tree.
    * leaf_mean / leaf_var — flat float64 leaf stats, ordinal-indexed via
      leaf_offs (T,).
    * n_words — uint64 leaf words per tree (1 or 2) for the widest tree.
    """
    T = len(roots)
    nodes_by_feat: List[List[Tuple[float, int, int, int]]] = [[] for _ in range(d)]
    leaf_mean: List[float] = []
    leaf_var: List[float] = []
    leaf_offs = np.empty(T, dtype=np.int64)
    n_leaves_max = 0
    for t in range(T):
        base = len(leaf_mean)
        leaf_offs[t] = base
        stack = [(int(roots[t]), False)]
        spans = {}  # node -> (lo, hi) leaf-ordinal range within this tree
        while stack:
            n, expanded = stack.pop()
            if child[2 * n] == n:  # leaf: self-loop encoding
                spans[n] = (len(leaf_mean) - base, len(leaf_mean) - base + 1)
                leaf_mean.append(float(mean[n]))
                leaf_var.append(float(var[n]))
                continue
            if not expanded:
                stack.append((n, True))
                stack.append((int(child[2 * n + 1]), False))
                stack.append((int(child[2 * n]), False))
                continue
            lo, mid = spans[int(child[2 * n])]
            _, hi = spans[int(child[2 * n + 1])]
            spans[n] = (lo, hi)
            if int(feat[n]) >= d:
                return None, (
                    f"tree {t} splits on feature {int(feat[n])} outside the "
                    f"{d}-dim space"
                )
            if hi > 64 * MAX_LEAF_WORDS:
                return None, (
                    f"tree {t} has {hi} leaves > "
                    f"{64 * MAX_LEAF_WORDS}-bit leaf words"
                )
            n_leaves_max = max(n_leaves_max, hi)
            nodes_by_feat[int(feat[n])].append((float(thr[n]), t, lo, mid))
    n_words = 1 if n_leaves_max <= 64 else 2
    return (
        nodes_by_feat,
        np.asarray(leaf_mean),
        np.asarray(leaf_var),
        leaf_offs,
        n_words,
    ), ""


def _span_mask(lo: int, mid: int, w: int) -> np.uint64:
    """uint64 word ``w`` of the mask clearing leaf ordinals [lo, mid)."""
    a = min(max(lo - 64 * w, 0), 64)
    b = min(max(mid - 64 * w, 0), 64)
    if b <= a:
        return _ONES
    return np.uint64(~(((1 << (b - a)) - 1) << a) & int(_ONES))


def build_false_tables(nodes_by_feat, T: int, n_words: int):
    """Per-feature sorted thresholds + prefix-ANDed false-set tables.

    Returns ``(thrs, tables)``: tables[j] has shape (n_thr + 1, T) for one
    leaf word, (n_thr + 1, T, n_words) otherwise — row r is the AND of the
    masks of the r smallest thresholds on that feature.
    """
    thrs, tables = [], []
    for nds in (sorted(f, key=lambda z: z[0]) for f in nodes_by_feat):
        shape = (len(nds) + 1, T) if n_words == 1 else (len(nds) + 1, T, n_words)
        tab = np.full(shape, _ONES, dtype=np.uint64)
        for r, (_, t, lo, mid) in enumerate(nds):
            tab[r + 1] = tab[r]
            if n_words == 1:
                tab[r + 1, t] &= _span_mask(lo, mid, 0)
            else:
                for w in range(n_words):
                    tab[r + 1, t, w] &= _span_mask(lo, mid, w)
        thrs.append(np.array([z[0] for z in nds]))
        tables.append(tab)
    return thrs, tables


# ---------------------------------------------------------------------------
# K3: the prefix/suffix-AND walk
# ---------------------------------------------------------------------------


def _lowbit_ordinal(acc: torch.Tensor) -> torch.Tensor:
    """Ordinal of the lowest set bit of each int64-held uint64 word, from
    the float64 exponent of the isolated bit (exact for powers of two; the
    sign mask handles bit 63, which is negative in int64). An all-zero
    word gives -1023, as in the reference; a plan's words never are."""
    low = acc & -acc
    return ((low.to(torch.float64).view(torch.int64) >> 52) & 0x7FF) - 1023


def chain_ordinals_plain(word_x: torch.Tensor, word_b: torch.Tensor,
                         perms: torch.Tensor) -> torch.Tensor:
    """(C, d+1, nb, T) int32 exit-leaf ordinals: the numpy walk
    ``ChainPlan._leaf_ordinals`` of the reference in torch ops.

    word_x (C, d, T, W) and word_b (nb, d, T, W) int64, perms (C, d)."""
    C, d, T, W = word_x.shape
    nb = word_b.shape[0]
    dev = word_x.device
    p = perms.to(torch.int64)
    rows = torch.arange(C, device=dev)
    pref = torch.empty((C, d + 1, T, W), dtype=torch.int64, device=dev)
    pref[:, 0] = -1
    for k in range(d):
        pref[:, k + 1] = pref[:, k] & word_x[rows, p[:, k]]
    idx = torch.empty((C, d + 1, nb, T), dtype=torch.int32, device=dev)
    suf = torch.full((C, nb, T, W), -1, dtype=torch.int64, device=dev)
    for k in range(d, -1, -1):
        acc = pref[:, k][:, None] & suf
        o = _lowbit_ordinal(acc[..., 0])
        if W > 1:
            o = torch.where(acc[..., 0] != 0, o, 64 + _lowbit_ordinal(acc[..., 1]))
        idx[:, k] = o.to(torch.int32)
        if k > 0:
            suf &= word_b[:, p[:, k - 1]].transpose(0, 1)
    return idx


# the card's plan: shared memory of a block and of an SM (H100), and the
# launch shape of the staged routes
SMEM_BLOCK = 232448
SMEM_SM = 233472
_SMEM_RESERVED = 1024    # the runtime's share of each block
_THREADS = 320           # the staged routes' block (csrc kThreads)
_SEGS = 8                # segments of the prefix scan (csrc kSegs)
VALUES_MAX_NB = 1024     # background rows the values route's pairwise sum takes
_BLOCKS_PER_SM = 2       # the staged routes' blocks an SM, where shared memory lets
# the most chain walks (chains x tree tiles) the staged route gives one
# block's place on an SM; past it the first design is faster
# (scripts/chain_routes.py)
STAGED_MAX_LOAD = 4
_EVAL_ROUTE: Optional[str] = None   # forces chain_values' route on the card (scripts)


class WalkPlan(NamedTuple):
    """A K3 launch on the card: block (g, tile) of a (groups, tiles) grid
    walks chains g, g + groups, ... over trees [tile * trees, ...)."""
    route: str      # "values", "staged" or "per_chain"
    trees: int      # trees of a tile
    tiles: int
    groups: int
    smem: int       # shared memory of a block, bytes


def _smem(d: int, nb: int, trees: int, W: int, T: int = 0, n_leaves: int = 0) -> int:
    """Bytes of a staged block's shared memory (csrc ``Layout::total``): the
    tile's background words, two slots of chain words, the prefix table and
    its segment totals, the walk segments' totals, two permutation slots and
    the walk's permutation. T > 0 is the values route's: one slot of chain
    words and of permutation, its rows in the walk totals' place (the larger
    of the two), leaf means, tree offsets and ordinal bytes (T rounded up
    to 4 a row)."""
    def a16(n):
        return -(-n // 16) * 16

    slots = 1 if T else 2
    row = trees * W * 8
    tot = max(_THREADS * W * 8, (d + 1) * nb * 8 if T else 0)
    n = ((nb * d + slots * d + d + 1 + _SEGS) * row + tot + n_leaves * 8
         + (slots + 1) * a16(4 * d) + a16(4 * T))
    if T:
        n += a16((d + 1) * nb * -(-T // 4) * 4)
    return n


def _per_sm(smem: int) -> int:
    """Blocks of ``smem`` bytes an SM holds, at most ``_BLOCKS_PER_SM``."""
    return max(1, min(_BLOCKS_PER_SM, SMEM_SM // (smem + _SMEM_RESERVED)))


def _groups(C: int, tiles: int, smem: int, n_sms: int) -> int:
    """Chain groups. One tile of every tree: a block a chain (at the tuner's
    shapes one chain a block beat two or three a block, the blocks sharing
    the SMs; ``scripts/chain_variants.py``). Tiled trees: one wave of
    blocks, each walking the same number of chains over a tile it copied
    once."""
    if tiles == 1:
        return max(1, C)
    cap = max(1, _per_sm(smem) * n_sms // tiles)
    return max(1, -(-C // -(-C // cap)))


def staged_plan(C: int, d: int, nb: int, T: int, W: int,
                n_sms: int) -> Optional[WalkPlan]:
    """The ``staged`` route's launch: every tree in one tile where its
    background words fit a block, else tiles that two blocks an SM hold
    (balanced; one an SM where a tree alone needs more). None where one
    tree's words do not fit a block."""
    def widest(budget):   # the most trees (up to T) whose block fits ``budget``
        return max((t for t in range(T + 1) if _smem(d, nb, t, W) <= budget), default=0)

    trees = widest(SMEM_BLOCK)
    if 1 <= trees < T:   # tiled: tiles two blocks an SM hold, where a tree fits half an SM
        trees = max(1, widest(SMEM_SM // 2 - _SMEM_RESERVED))
    if W not in (1, 2) or d < 1 or T < 1 or trees < 1:
        return None
    tiles = -(-T // trees)
    trees = -(-T // tiles)
    smem = _smem(d, nb, trees, W)
    return WalkPlan("staged", trees, tiles, _groups(C, tiles, smem, n_sms), smem)


def ordinals_plan(C: int, d: int, nb: int, T: int, W: int, n_sms: int) -> WalkPlan:
    """The ordinals' route: :func:`staged_plan`'s, or ``per_chain`` where
    that is None or would give each block's place on an SM more than
    ``STAGED_MAX_LOAD`` chain walks (chains x tiles). A pure function of its
    arguments."""
    staged = staged_plan(C, d, nb, T, W, n_sms)
    if staged is None or C * staged.tiles > STAGED_MAX_LOAD * _per_sm(staged.smem) * n_sms:
        return WalkPlan("per_chain", T, 1, C, (d + 1) * T * W * 8 + d * 4)
    return staged


def values_plan(C: int, d: int, nb: int, T: int, W: int, n_leaves: int,
                n_sms: int) -> WalkPlan:
    """The chain values' route: ``values`` where one block holds every tree
    (so each tree mean sums in tree order in one block) and nb is at most
    ``VALUES_MAX_NB``; elsewhere the ordinals' route, then the torch tail."""
    smem = _smem(d, nb, T, W, T, n_leaves)
    if W in (1, 2) and d >= 1 and T >= 1 and nb <= VALUES_MAX_NB and smem <= SMEM_BLOCK:
        return WalkPlan("values", T, 1, _groups(C, 1, smem, n_sms), smem)
    return ordinals_plan(C, d, nb, T, W, n_sms)


def chain_ordinals_cuda(word_x: torch.Tensor, word_b: torch.Tensor, perms: torch.Tensor,
                        route: Optional[str] = None,
                        x_of_chain: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K3's walk on the card; ``route`` forces one of ``ROUTES``
    (default :func:`ordinals_plan`'s). With ``x_of_chain`` (C,) int32,
    ``word_x`` holds rows (n, d, T, W) and chain c walks row x_of_chain[c]."""
    n, d, T, W = word_x.shape
    C, nb = perms.shape[0], word_b.shape[0]
    dev = word_x.device
    if W not in (1, 2):
        raise ValueError(f"chain_ordinals: {W} leaf words, expected 1 or 2")
    check("word_x", word_x, torch.int64, (C if x_of_chain is None else -1, d, T, W), dev)
    check("word_b", word_b, torch.int64, (nb, d, T, W), dev)
    check("perms", perms, torch.int32, (C, d), dev)
    if x_of_chain is not None:
        check("x_of_chain", x_of_chain, torch.int32, (C,), dev)
    if dev.type != "cuda":
        raise ValueError(f"chain_ordinals: the CUDA kernel needs tensors on the card, got {dev}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"chain_ordinals: unknown route {route!r} (one of {ROUTES})")
    out = torch.empty((C, d + 1, nb, T), dtype=torch.int32, device=dev)
    if C == 0:
        return out
    route = route or ordinals_plan(C, d, nb, T, W, n_sms(dev)).route
    if route == "per_chain":
        smem = (d + 1) * T * W * 8 + d * 4
        if smem > SMEM_BLOCK:
            raise ValueError(f"chain_ordinals: {smem} bytes of prefix words exceed shared memory")
        if x_of_chain is not None:
            word_x = word_x[x_of_chain.long()]
        launch("chain_ordinals", "chain_ordinals_launch", dev,
               (word_x, word_b, perms, out), (C, d, nb, T, W), route="per_chain")
        return out
    plan = staged_plan(C, d, nb, T, W, n_sms(dev))
    if plan is None:
        raise ValueError(f"chain_ordinals: the staged route cannot hold one tree's "
                         f"{nb} x {d} x {W} background words")
    launch("chain_ordinals", "chain_staged_launch", dev,
           (word_x, x_of_chain, word_b, perms, out),
           (C, d, nb, T, W, plan.trees, plan.groups, _THREADS), route="staged")
    return out


def chain_ordinals(word_x: torch.Tensor, word_b: torch.Tensor,
                   perms: torch.Tensor) -> torch.Tensor:
    """(C, d+1, nb, T) exit-leaf ordinals for every (chain, level, bg row)."""
    if word_x.device.type == "cuda":
        return chain_ordinals_cuda(word_x, word_b, perms)
    if word_x.device.type != "cpu":
        raise ValueError(f"chain_ordinals: unsupported device {word_x.device}")
    PLAIN_CALLS["chain_ordinals"] += 1
    return chain_ordinals_plain(word_x, word_b, perms)


def chain_tail(idx: torch.Tensor, leaf_mean: torch.Tensor, leaf_offs: torch.Tensor,
               y_std: float, y_mean: float) -> torch.Tensor:
    """(C, d+1) float64 chain values from (C, d+1, nb, T) ordinals, in the
    reference's float order: the tree mean of ``PackedForest.combine``
    over the (T, rows) block, the denorm, then the mean over background
    rows."""
    C, d1, nb, T = idx.shape
    flat = (idx.to(torch.int64) + leaf_offs).reshape(-1, T).T
    m_t = leaf_mean[flat]                                      # (T, rows)
    mean_rows = div_scalar(sequential_sum(m_t, 0), T)
    mean_rows = mean_rows * y_std + y_mean
    return div_scalar(pairwise_sum(mean_rows.reshape(C, d1, nb), 2), nb)


def chain_values_plain(words: torch.Tensor, x_of_chain: torch.Tensor, word_b: torch.Tensor,
                       perms: torch.Tensor, leaf_mean: torch.Tensor, leaf_offs: torch.Tensor,
                       y_std: float, y_mean: float) -> torch.Tensor:
    """(C, d+1) float64 chain values: the plain walk over each chain's row
    ``words[x_of_chain[c]]`` (words (n, d, T, W) int64), then
    :func:`chain_tail`."""
    idx = chain_ordinals_plain(words[x_of_chain.long()], word_b, perms)
    return chain_tail(idx, leaf_mean, leaf_offs, y_std, y_mean)


def chain_values_cuda(words: torch.Tensor, x_of_chain: torch.Tensor, word_b: torch.Tensor,
                      perms: torch.Tensor, leaf_mean: torch.Tensor, leaf_offs: torch.Tensor,
                      y_std: float, y_mean: float, route: Optional[str] = None) -> torch.Tensor:
    """Chain values on the card: the ``values`` route where
    :func:`values_plan` gives it (one launch), else the ordinals' route
    and :func:`chain_tail`; ``route`` forces one of ``VALUE_ROUTES``."""
    n, d, T, W = words.shape
    C, nb, L = perms.shape[0], word_b.shape[0], leaf_mean.shape[0]
    dev = words.device
    check("words", words, torch.int64, (n, d, T, W), dev)
    check("x_of_chain", x_of_chain, torch.int32, (C,), dev)
    check("leaf_mean", leaf_mean, torch.float64, (L,), dev)
    check("leaf_offs", leaf_offs, torch.int64, (T,), dev)
    route = route or _EVAL_ROUTE
    if route is not None and route not in VALUE_ROUTES:
        raise ValueError(f"chain_values: unknown route {route!r} (one of {VALUE_ROUTES})")
    if dev.type != "cuda":
        raise ValueError(f"chain_values: the CUDA kernel needs tensors on the card, got {dev}")
    plan = values_plan(C, d, nb, T, W, L, n_sms(dev))
    route = route or plan.route
    if route != "values":
        idx = chain_ordinals_cuda(words, word_b, perms, route=route, x_of_chain=x_of_chain)
        return chain_tail(idx, leaf_mean, leaf_offs, y_std, y_mean)
    check("word_b", word_b, torch.int64, (nb, d, T, W), dev)
    check("perms", perms, torch.int32, (C, d), dev)
    if plan.route != "values":
        raise ValueError(f"chain_values: the values route cannot hold {T} trees of {nb} x {d} "
                         f"x {W} background words and {L} leaf means in one block")
    vals = torch.empty((C, d + 1), dtype=torch.float64, device=dev)
    if C == 0:
        return vals
    launch("chain_ordinals", "chain_values_launch", dev,
           (words, x_of_chain, word_b, perms, leaf_mean, leaf_offs, vals),
           (C, d, nb, T, W, L, plan.groups, _THREADS), doubles=(y_std, y_mean), route="values")
    return vals


def chain_values(words: torch.Tensor, x_of_chain: torch.Tensor, word_b: torch.Tensor,
                 perms: torch.Tensor, leaf_mean: torch.Tensor, leaf_offs: torch.Tensor,
                 y_std: float, y_mean: float) -> torch.Tensor:
    """(C, d+1) float64 chain values E_b[f(z_{S_k})] for every (chain, level)."""
    if words.device.type == "cuda":
        return chain_values_cuda(words, x_of_chain, word_b, perms, leaf_mean, leaf_offs,
                                 y_std, y_mean)
    if words.device.type != "cpu":
        raise ValueError(f"chain_values: unsupported device {words.device}")
    PLAIN_CALLS["chain_ordinals"] += 1
    return chain_values_plain(words, x_of_chain, word_b, perms, leaf_mean, leaf_offs,
                              y_std, y_mean)


def words_tensor(words: np.ndarray, device: torch.device) -> torch.Tensor:
    """(n, d, T[, W]) uint64 words -> (n, d, T, W) int64 tensor on ``device``."""
    if words.ndim == 3:
        words = words[..., None]
    t = torch.from_numpy(np.ascontiguousarray(words).view(np.int64))
    return t.to(device)


class ChainPlan:
    """Per-forest precompute: feature threshold tables + leaf ordinals."""

    def __init__(self, forest, d: int,
                 thrs: List[np.ndarray], tables: List[np.ndarray],
                 leaf_mean: np.ndarray, leaf_offs: np.ndarray,
                 n_words: int = 1):
        self.forest = forest          # PackedForest (device, y denorm)
        self.d = d
        self.thrs = thrs              # per feature: sorted split thresholds
        self.tables = tables          # per feature: (n_thr + 1, T[, W]) prefix-ANDs
        self.n_words = n_words        # uint64 leaf words per tree (1 or 2)
        self.device = forest.device
        # flat leaf means, ordinal-indexed through the (T,) tree offsets
        self.leaf_mean = torch.from_numpy(np.asarray(leaf_mean, dtype=np.float64)).to(self.device)
        self.leaf_offs = torch.from_numpy(np.asarray(leaf_offs, dtype=np.int64)).to(self.device)

    @property
    def n_trees(self) -> int:
        return len(self.leaf_offs)

    def row_words(self, V: np.ndarray) -> np.ndarray:
        """Per-row false-node words, shape (n, d, T) or (n, d, T, W).

        ``word[i, j]`` is the AND of the masks of every node on feature j
        that row i's value makes false — rank r = #(thr < v) via
        ``searchsorted(..., 'left')``, the exact ``v > thr`` comparison of
        the packed descent.
        """
        V = np.asarray(V, dtype=float)
        shape = (len(V), self.d, self.n_trees)
        if self.n_words > 1:
            shape += (self.n_words,)
        out = np.empty(shape, dtype=np.uint64)
        for j in range(self.d):
            out[:, j] = self.tables[j][
                np.searchsorted(self.thrs[j], V[:, j], side="left")
            ]
        return out

    def eval_chains(
        self,
        X: np.ndarray,
        background: np.ndarray,
        perms: np.ndarray,
        x_of_chain: np.ndarray,
    ) -> np.ndarray:
        """Chain values for (chain, level): E_b[f(z_{S_k})], shape (C, d+1).

        perms: (C, d) permutation per chain; x_of_chain: (C,) row of X each
        chain explains. The words of X's rows and of the background rows
        are built on the host and uploaded once each, and
        :func:`chain_values` walks and reduces them on the plan's device.
        """
        dev = self.device
        words = words_tensor(self.row_words(X), dev)
        word_b = words_tensor(self.row_words(background), dev)
        perms_t = torch.from_numpy(np.ascontiguousarray(perms, dtype=np.int32)).to(dev)
        xoc = torch.from_numpy(np.ascontiguousarray(x_of_chain, dtype=np.int32)).to(dev)
        vals = chain_values(words, xoc, word_b, perms_t, self.leaf_mean, self.leaf_offs,
                            self.forest.y_std, self.forest.y_mean)
        return vals.cpu().numpy()


def build_chain_plan_ex(model, d: int) -> Tuple[Optional[ChainPlan], str]:
    """Build (and cache on the packed arena) a ChainPlan.

    ``model`` is a fitted ``ProbabilisticRandomForest`` or a
    ``PackedForest``. Returns ``(plan, "")`` on success and
    ``(None, reason)`` when the model is not a packed forest, a tree
    exceeds 64 * MAX_LEAF_WORDS leaves, or d > 64.
    """
    pack = getattr(model, "pack", None)
    if callable(pack):
        if not getattr(model, "trees", None):
            return None, "not a fitted forest"
        pf = pack()
    elif hasattr(model, "roots") and hasattr(model, "combine"):
        pf = model
    else:
        return None, "not a packable forest"
    if d > 64:
        return None, f"d={d} > 64 prefix-mask bits"
    cached = getattr(pf, _PLAN_ATTR, None)
    if cached is not None and cached[0] == d:
        return cached[1], ""

    host = pf.host_arrays()
    packed, reason = pack_leaf_spans(host["feat"], host["thr"], host["child"],
                                     host["mean"], host["var"], host["roots"], d)
    if packed is None:
        return None, reason
    nodes_by_feat, leaf_mean, _leaf_var, leaf_offs, n_words = packed
    thrs, tables = build_false_tables(nodes_by_feat, pf.n_trees, n_words)
    plan = ChainPlan(pf, d, thrs, tables, leaf_mean, leaf_offs, n_words)
    setattr(pf, _PLAN_ATTR, (d, plan))
    return plan, ""


# ---------------------------------------------------------------------------
# delta pool scoring: per-base shared-coordinate AND reuse (host numpy)
# ---------------------------------------------------------------------------


def _lowbit_ordinal_np(acc: np.ndarray) -> np.ndarray:
    """Ordinal of the lowest set bit of each uint64 (via the float64
    exponent of the isolated bit — exact for powers of two); an all-zero
    word yields a negative garbage value the caller must mask."""
    low = acc & (np.uint64(0) - acc)
    return (
        (low.astype(np.float64).view(np.uint64) >> np.uint64(52))
        - np.uint64(1023)
    ).astype(np.intp)


class PoolPlan:
    """False-word tables over a (possibly fused multi-forest) arena for
    whole-pool leaf routing with per-base delta reuse.

    Mutation pools share most coordinates with their base incumbent: a
    candidate's QuickScorer word is the AND of its d per-feature false
    words, and every unmutated coordinate contributes the *base's* word.
    Per base this plan precomputes a doubling (sparse) range-AND table
    over the feature axis — AND is idempotent, so any feature segment is
    two overlapping power-of-two lookups — and per candidate re-ANDs only
    the mutated coordinates plus one segment per gap between them. Leaf
    routing is bit-identical to the gather descent (the rank compare
    replays ``v > thr`` exactly), so ``predict`` through this plan returns
    the descent's exact leaf stats.
    """

    def __init__(self, d: int,
                 thrs: List[np.ndarray], tables: List[np.ndarray],
                 leaf_mean: np.ndarray, leaf_var: np.ndarray,
                 leaf_offs: np.ndarray, n_words: int = 1):
        self.d = d
        self.thrs = thrs
        self.tables = tables
        self.leaf_mean = leaf_mean
        self.leaf_var = leaf_var
        self.leaf_offs = leaf_offs
        self.n_words = n_words

    @property
    def n_trees(self) -> int:
        return len(self.leaf_offs)

    # same per-row false-word gather as the chain plan
    row_words = ChainPlan.row_words

    def _ordinals(self, acc: np.ndarray) -> np.ndarray:
        """Exit-leaf ordinals from ANDed word vectors (word 0 first)."""
        if self.n_words == 1:
            return _lowbit_ordinal_np(acc)
        o0 = _lowbit_ordinal_np(acc[..., 0])
        o1 = _lowbit_ordinal_np(acc[..., 1])
        return np.where(acc[..., 0] != 0, o0, 64 + o1)

    def leaf_stats(self, X: np.ndarray, bases: np.ndarray,
                   base_of: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """(m_t, v_t), each (T, N) — the descent's exact per-tree leaf stats.

        ``bases`` is the (B, d) matrix of base rows; ``base_of[i]`` names
        candidate i's base (-1 = no base: a fresh random sample, evaluated
        by the vectorized full-row AND instead). Which coordinates mutated
        is recovered by exact value comparison against the base row — a
        mutation that lands back on the base value is simply shared.
        """
        X = np.asarray(X, dtype=float)
        N = len(X)
        T = self.n_trees
        base_of = np.asarray(base_of)
        m_t = np.empty((T, N))
        v_t = np.empty((T, N))

        free = np.flatnonzero(base_of < 0)
        if free.size:
            acc = np.bitwise_and.reduce(self.row_words(X[free]), axis=1)
            flat = self._ordinals(acc) + self.leaf_offs  # (nf, T)
            m_t[:, free] = self.leaf_mean.take(flat).T
            v_t[:, free] = self.leaf_var.take(flat).T

        mut = np.flatnonzero(base_of >= 0)
        if mut.size:
            bases = np.asarray(bases, dtype=float)
            bw = self.row_words(bases)                   # (B, d, T[, W])
            # doubling range-AND table: lvl[l][:, j] = AND of the words of
            # features [j, j + 2^l); idempotence lets two overlapping
            # power-of-two segments cover any [a, b)
            lvls = [bw]
            span = 1
            while span < self.d:
                prev = lvls[-1]
                nxt = prev.copy()
                nxt[:, : self.d - span] &= prev[:, span:]
                lvls.append(nxt)
                span *= 2

            def seg(b: int, a: int, e: int) -> np.ndarray:
                lv = (e - a).bit_length() - 1
                return lvls[lv][b, a] & lvls[lv][b, e - (1 << lv)]

            for i in mut:
                b = int(base_of[i])
                changed = np.flatnonzero(X[i] != bases[b])
                acc = np.broadcast_to(_ONES, self.tables[0].shape[1:]).copy()
                prev_j = 0
                for j in changed:
                    j = int(j)
                    if j > prev_j:
                        acc &= seg(b, prev_j, j)
                    acc &= self.tables[j][
                        int(np.searchsorted(self.thrs[j], X[i, j], side="left"))
                    ]
                    prev_j = j + 1
                if prev_j < self.d:
                    acc &= seg(b, prev_j, self.d)
                flat = self._ordinals(acc) + self.leaf_offs
                m_t[:, i] = self.leaf_mean[flat]
                v_t[:, i] = self.leaf_var[flat]
        return m_t, v_t


def build_pool_plan_ex(arena, d: int) -> Tuple[Optional[PoolPlan], str]:
    """Build (and cache on the arena object) a PoolPlan.

    ``arena`` is anything carrying the packed node tensors (a PackedForest
    or a fused ForestPlane), read back to the host. Returns ``(plan, "")``
    or ``(None, reason)`` under the same decline conditions as
    :func:`build_chain_plan_ex`.
    """
    keys = ("feat", "thr", "child", "mean", "var", "roots")
    if not all(hasattr(arena, k) for k in keys):
        return None, "not a packed arena"
    if d > 64:
        return None, f"d={d} > 64 prefix-mask bits"
    cached = getattr(arena, _POOL_PLAN_ATTR, None)
    if cached is not None and cached[0] == d:
        return cached[1], cached[2]

    host = {k: np.asarray(getattr(arena, k).cpu()) for k in keys}
    packed, reason = pack_leaf_spans(*(host[k] for k in keys), d)
    if packed is None:
        plan = None
    else:
        nodes_by_feat, leaf_mean, leaf_var, leaf_offs, n_words = packed
        thrs, tables = build_false_tables(nodes_by_feat, len(host["roots"]), n_words)
        plan = PoolPlan(d, thrs, tables, leaf_mean, leaf_var,
                        leaf_offs.astype(np.intp), n_words)
        reason = ""
    setattr(arena, _POOL_PLAN_ATTR, (d, plan, reason))
    return plan, reason
