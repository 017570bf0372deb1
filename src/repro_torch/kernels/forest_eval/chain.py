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
  for tensors on the CPU.

The float tail (leaf-mean gather, the tree mean and the background mean)
runs in torch in numpy's reduction order (``repro_torch.numerics``), so
chain values are bit-identical to the reference's ``eval_chains``.

``build_chain_plan_ex`` returns ``(plan, reason)`` — ``(None, why)`` when
the encoding does not apply (a tree with more than 128 leaves, or more
than 64 features); callers fall back to the composite-tensor path.
Values must be NaN-free (threshold ranks come from ``np.searchsorted``).
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np
import torch

from ...numerics import div_scalar, pairwise_sum, sequential_sum
from ..counts import PLAIN_CALLS
from ..launch import check, launch

__all__ = [
    "ChainPlan",
    "pack_leaf_spans",
    "build_false_tables",
    "build_chain_plan_ex",
    "chain_ordinals",
    "chain_ordinals_cuda",
    "chain_ordinals_plain",
    "words_tensor",
]

_ONES = np.uint64(0xFFFFFFFFFFFFFFFF)
_PLAN_ATTR = "_chain_plan_cache"

# the widest supported leaf word vector: 2 x uint64 = 128 leaves per tree
MAX_LEAF_WORDS = 2


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


def chain_ordinals_cuda(word_x: torch.Tensor, word_b: torch.Tensor,
                        perms: torch.Tensor) -> torch.Tensor:
    """Launch K3 on the card."""
    C, d, T, W = word_x.shape
    nb = word_b.shape[0]
    dev = word_x.device
    if W not in (1, 2):
        raise ValueError(f"chain_ordinals: {W} leaf words, expected 1 or 2")
    check("word_x", word_x, torch.int64, (C, d, T, W), dev)
    check("word_b", word_b, torch.int64, (nb, d, T, W), dev)
    check("perms", perms, torch.int32, (C, d), dev)
    smem = (d + 1) * T * W * 8 + d * 4
    if smem > 232448:
        raise ValueError(f"chain_ordinals: {smem} bytes of prefix words exceed shared memory")
    out = torch.empty((C, d + 1, nb, T), dtype=torch.int32, device=dev)
    launch("chain_ordinals", "chain_ordinals_launch", dev,
           (word_x, word_b, perms, out), (C, d, nb, T, W))
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
        chain explains. The words are built on the host, the walk runs
        through K3 on the plan's device, and the float tail replays the
        reference's ops: the tree mean of ``PackedForest.combine`` over the
        (T, rows) block, the denorm, then the mean over background rows.
        """
        d, nb, T = self.d, len(background), self.n_trees
        C = len(perms)
        word_x = words_tensor(self.row_words(X)[x_of_chain], self.device)
        word_b = words_tensor(self.row_words(background), self.device)
        perms_t = torch.from_numpy(np.ascontiguousarray(perms, dtype=np.int32)).to(self.device)
        idx = chain_ordinals(word_x, word_b, perms_t)            # (C, d+1, nb, T)
        flat = (idx.to(torch.int64) + self.leaf_offs).reshape(-1, T).T
        m_t = self.leaf_mean[flat]                                 # (T, rows)
        mean_rows = div_scalar(sequential_sum(m_t, 0), T)
        mean_rows = mean_rows * self.forest.y_std + self.forest.y_mean
        vals = div_scalar(pairwise_sum(mean_rows.reshape(C, d + 1, nb), 2), nb)
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
