"""The fused BO propose step (ROADMAP item 7), in torch with two kernels.

Counterpart of ``repro/kernels/forest_eval/propose.py``. One step scores a
candidate pool against every surrogate source and returns the top k:

1. the pool: uploaded (host-pool mode, the staged path's own candidates)
   or drawn on the device (:func:`draw_unit_pool`: a uniform half and a
   per-knob stratified LHS half in unit space, replayed through the sample
   space's restriction CDFs, :func:`unit_col`);
2. the descent: per-tree leaf (mean, var), (T, N), either through K1
   (``forest``, ``ops.forest_eval``) or through QuickScorer tables (``qs``,
   :func:`qs_leaf_stats`, kernel Q1, ``csrc/qs_descent.cu``; :func:`qs_plan`
   picks its route: ``per_tree``, each tree's own tables staged in shared
   memory, or ``merged``, the tables of every tree merged by feature);
3. the combine and EI (:func:`combine_ei`, kernel Q2,
   ``csrc/combine_ei.cu``): each source's tree rows added in tree order,
   divided by T, floored at 1e-10, denormalised, then the portable Cephes
   EI; padding columns get EI = -1;
4. the ranks of each source's EI row through K2 and their weighted sum in
   source order (:func:`aggregate`);
5. the stable ascending top k of the aggregate (:func:`topk_perm`): K2 on
   the aggregate's ascending keys, each index scattered to its rank.

Q1 and Q2 have no Pallas original: the reference computes them with jnp
inside its jitted step. A tensor on the CPU takes each kernel's plain
version (the reference's jnp sequence in torch); a tensor on the card
launches the kernel or raises. Every value is bit-identical to the
reference's ``propose_step`` under ``jax.enable_x64`` with ``rank_impl=
"sort"``: the descent does no float arithmetic, the combine and EI replay
numpy's op order with IEEE division and square root and no fused
multiply-add (``--fmad=false``), and the ranks are exact integers.

Pools pad to power-of-two buckets (``pool_bucket``) as in the reference,
so the engine (``repro_torch.core.propose``) captures one CUDA graph per
bucket. Padding rows come after the real rows and get EI = -1 and an
aggregate of +inf, so every real row keeps its unpadded rank.

The device pool's draws come from a ``torch.Generator`` on the device
seeded from the engine's seed, not from the reference's JAX key: the same
seed gives the same pools, but not the reference's pools (its own device
pool diverges from its host pool the same way).
"""

from __future__ import annotations

from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...numerics import div_scalar
from ..counts import PLAIN_CALLS
from ..launch import check, launch, n_sms
from .chain import SMEM_BLOCK, _lowbit_ordinal, build_false_tables, pack_leaf_spans
from .ops import forest_eval
from .rank import ascending_keys, monotone_keys, radix_rank

__all__ = [
    "POOL_BUCKET_MIN",
    "POOL_BUCKET_MAX",
    "Arena",
    "QSPlan",
    "QSTables",
    "QS_ROUTES",
    "TreeTables",
    "aggregate",
    "build_qs_plan_ex",
    "build_tree_records",
    "combine_ei",
    "combine_ei_cuda",
    "combine_ei_plain",
    "draw_unit_pool",
    "draw_units",
    "pool_bucket",
    "propose_scan",
    "propose_step",
    "qs_leaf_stats",
    "qs_leaf_stats_cuda",
    "qs_leaf_stats_plain",
    "qs_chunk_bytes",
    "qs_leaf_stats_tree_model",
    "qs_plan",
    "qs_plan_fits",
    "qs_ring_bytes",
    "qs_tables",
    "score_rows",
    "topk_perm",
    "unit_col",
]

POOL_BUCKET_MIN = 256
POOL_BUCKET_MAX = 131072

_K_FLOAT, _K_INT, _K_CAT, _K_BOOL, _K_CONST = 0, 1, 2, 3, 4
_VAR_FLOOR = 1e-10          # the combine's variance floor (PackedForest.combine)
_QS_ROWS = 32               # candidates a block of the merged route (the kernel's kRows)
_QS_CHUNK = 128             # trees a block of the merged route (the kernel's kChunk)


def pool_bucket(n: int) -> int:
    """Power-of-two pool bucket for ``n`` candidates (>= POOL_BUCKET_MIN)."""
    return max(POOL_BUCKET_MIN, 1 << (max(int(n), 1) - 1).bit_length())


class Arena(NamedTuple):
    """A fused plane's arena for the ``forest`` descent (K1): the packed
    node arrays, the largest depth, and K1's node table on the card (None
    on the CPU)."""

    feat: torch.Tensor
    thr: torch.Tensor
    child: torch.Tensor
    mean: torch.Tensor
    var: torch.Tensor
    roots: torch.Tensor
    depth: int
    nodes: object = None


# ---------------------------------------------------------------------------
# Q1: the QuickScorer descent, merged tables or per-tree tables
# ---------------------------------------------------------------------------


class TreeTables(NamedTuple):
    """The per-tree QuickScorer layout of a fused arena (the ``per_tree``
    route), on one device.

    ``blob`` (B,) uint8: one record a tree, each a multiple of 16 bytes,
    tree t's at byte ``tree_off[t]`` (``tree_off`` (T + 1,) int32). A
    record holds, each section after the last:

    * a header of four int32: singles S, pairs P, thresholds M, leaves L;
    * S singles of 16 bytes, one for each feature j the tree splits on
      once, ascending: int32 j, 4 bytes unused, the float64 threshold;
    * P pairs of int32 ``(s, j | n << 16)``, one for each feature j the
      tree splits on n > 1 times, ascending: its n sorted thresholds start
      at threshold s, its n + 1 prefix-ANDed leaf words at word S + s + p;
    * M float64 thresholds, then L float64 leaf means and L leaf vars;
    * from the next 16-byte boundary, S + M + P leaf words of
      ``word_bytes`` (4: uint32, every tree <= 32 leaves; 8: uint64, <= 64;
      16: two uint64, word 0 first, <= 128): each single's false mask,
      then each pair's rows.

    ``meta`` (2,) int32 on the device holds (T, word_bytes) for the
    kernel; ``sizes`` (T,) int64 each record's bytes on the host (for the
    plan), ``pairs`` the (tree, feature) pairs (S + P summed) and ``words``
    the leaf words."""

    blob: torch.Tensor
    tree_off: torch.Tensor
    meta: torch.Tensor
    sizes: np.ndarray
    word_bytes: int
    pairs: int
    words: int


class QSTables(NamedTuple):
    """The QuickScorer tables of a fused arena, on one device.

    The merged layout (route ``merged``): ``thr`` (M,) float64, every
    feature's split thresholds, each feature's sorted, laid end to end;
    feature j's are ``thr[thr_off[j]:thr_off[j + 1]]`` (``thr_off`` (D + 1,)
    int32). ``tables`` int64 (uint64 bits), flat: feature j's prefix-ANDed
    false-node table has ``n_j + 1`` rows starting at row ``thr_off[j] +
    j``, a row holding T trees' W leaf words (row-major, words innermost).
    ``leaf_mean``/``leaf_var`` (L,) float64 by leaf ordinal, ``leaf_off``
    (T,) int32 each tree's first ordinal. ``meta`` (2,) int32 on the
    device holds (T, W) for the kernel; ``n_trees``/``n_words`` the same on
    the host. ``trees``: the per-tree layout (:class:`TreeTables`, route
    ``per_tree``), None where it is not built."""

    thr: torch.Tensor
    thr_off: torch.Tensor
    tables: torch.Tensor
    leaf_mean: torch.Tensor
    leaf_var: torch.Tensor
    leaf_off: torch.Tensor
    meta: torch.Tensor
    n_trees: int
    n_words: int
    trees: Optional[TreeTables] = None


def _align16(n: int) -> int:
    return (n + 15) & ~15


def _mask(lo: int, mid: int) -> int:
    """The 128-bit false mask clearing leaf ordinals [lo, mid)."""
    return ((1 << 128) - 1) & ~(((1 << (mid - lo)) - 1) << lo)


def build_tree_records(nodes_by_feat, leaf_mean, leaf_var, leaf_offs):
    """The per-tree records of :class:`TreeTables` as numpy arrays, from
    ``chain.pack_leaf_spans``' output: ``(blob, tree_off, sizes,
    word_bytes, pairs, words)``. A pair (t, j) with one threshold is a
    single: its threshold and its false mask (row 1; row 0 is all ones).
    A pair with more keeps its n sorted thresholds and n + 1 rows, row r
    the AND of the false masks of tree t's r smallest thresholds on
    feature j: the merged table's row at the global rank, restricted to
    tree t."""
    T = len(leaf_offs)
    n_leaves = np.diff(np.append(leaf_offs, len(leaf_mean)))
    widest = int(n_leaves.max(initial=1))
    wb = 4 if widest <= 32 else 8 if widest <= 64 else 16
    spans: List[dict] = [{} for _ in range(T)]
    for j, nds in enumerate(nodes_by_feat):
        for thr, t, lo, mid in nds:
            spans[t].setdefault(j, []).append((thr, lo, mid))
    records, total_pairs, total_words = [], 0, 0
    for t in range(T):
        singles = [(j, *spans[t][j][0]) for j in sorted(spans[t]) if len(spans[t][j]) == 1]
        multi = [j for j in sorted(spans[t]) if len(spans[t][j]) > 1]
        S, P = len(singles), len(multi)
        ent = np.zeros(S, dtype=[("j", "<i4"), ("pad", "<i4"), ("thr", "<f8")])
        ent["j"] = [z[0] for z in singles]
        ent["thr"] = [z[1] for z in singles]
        words = [_mask(lo, mid) for _, _, lo, mid in singles]
        pairs = np.zeros((P, 2), dtype=np.int32)
        thrs = []
        for p, j in enumerate(multi):
            nds = sorted(spans[t][j], key=lambda z: z[0])
            pairs[p] = (len(thrs), j | (len(nds) << 16))
            acc = (1 << 128) - 1
            words.append(acc)
            for thr, lo, mid in nds:
                thrs.append(thr)
                acc &= _mask(lo, mid)
                words.append(acc)
        M, L = len(thrs), int(n_leaves[t])
        a = int(leaf_offs[t])
        head = np.array([S, P, M, L], dtype=np.int32)
        body = b"".join((head.tobytes(), ent.tobytes(), pairs.tobytes(),
                         np.asarray(thrs, np.float64).tobytes(),
                         np.asarray(leaf_mean[a:a + L], np.float64).tobytes(),
                         np.asarray(leaf_var[a:a + L], np.float64).tobytes()))
        w = np.array([[x & (2**64 - 1), x >> 64] for x in words], dtype=np.uint64).reshape(-1, 2)
        wbytes = (w[:, 0].astype(np.uint32) if wb == 4 else w[:, 0] if wb == 8 else w).tobytes()
        rec = bytearray(_align16(_align16(len(body)) + len(wbytes)))
        rec[:len(body)] = body
        rec[_align16(len(body)):_align16(len(body)) + len(wbytes)] = wbytes
        records.append(bytes(rec))
        total_pairs += S + P
        total_words += len(words)
    sizes = np.array([len(r) for r in records], dtype=np.int64)
    tree_off = np.concatenate([[0], np.cumsum(sizes)]).astype(np.int64)
    blob = np.frombuffer(b"".join(records), dtype=np.uint8).copy()
    return blob, tree_off, sizes, wb, total_pairs, total_words


def build_qs_plan_ex(feat, thr, child, mean, var, roots, d, merged: bool = True):
    """Host-side QuickScorer tables for a fused multi-source arena (numpy
    arrays): the reference's ``build_qs_plan_ex``, through the port's own
    chain packer (``chain.pack_leaf_spans``, ``chain.build_false_tables``),
    and the per-tree records (:func:`build_tree_records`). Returns
    ``((thrs, tables, leaf_mean, leaf_var, leaf_offs, records), "")``, each
    feature's sorted thresholds and its (n_thr + 1, T[, 2]) uint64 table
    (both None without ``merged``: the per_tree route needs the records
    alone), or ``(None, reason)`` where a tree has more than 128 leaves or
    splits outside the d-dim space."""
    packed, reason = pack_leaf_spans(feat, thr, child, mean, var, roots, d)
    if packed is None:
        return None, reason
    nodes_by_feat, leaf_mean, leaf_var, leaf_offs, n_words = packed
    thrs = tables = None
    if merged:
        thrs, tables = (tuple(a) for a in build_false_tables(nodes_by_feat, len(roots), n_words))
    records = build_tree_records(nodes_by_feat, leaf_mean, leaf_var, leaf_offs)
    return (thrs, tables, leaf_mean, leaf_var, leaf_offs, records), ""


def qs_tables(plan, device) -> QSTables:
    """:class:`QSTables` on ``device`` from :func:`build_qs_plan_ex`'s plan
    (the merged tensors None where the plan has no merged tables)."""
    thrs, tabs, lm, lv, offs, (blob, tree_off, sizes, wb, n_pairs, n_words) = plan
    T = len(offs)

    def to(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

    trees = TreeTables(to(blob, np.uint8), to(tree_off, np.int32), to(np.array([T, wb]), np.int32),
                       sizes, wb, n_pairs, n_words)
    if tabs is None:
        return QSTables(*(None,) * 7, T, 2 if wb == 16 else 1, trees)
    W = 1 if tabs[0].ndim == 2 else tabs[0].shape[2]
    off = np.concatenate([[0], np.cumsum([len(t) for t in thrs])]).astype(np.int32)
    flat = np.concatenate([t.reshape(t.shape[0], -1) for t in tabs]).reshape(-1)
    return QSTables(
        to(np.concatenate(thrs) if thrs else np.zeros(0), np.float64), to(off, np.int32),
        to(flat.view(np.int64), np.int64), to(lm, np.float64), to(lv, np.float64),
        to(offs, np.int32), to(np.array([T, W]), np.int32), T, W, trees)


class QSPlan(NamedTuple):
    """A Q1 launch on the card. ``per_tree``: a persistent grid of ``grid``
    blocks of 512 threads walks units (tree chunk, candidate tile), chunk-
    major; a chunk is ``trees`` consecutive trees (the kernel counts the
    chunks from T in ``meta``), a tile ``tile`` candidates, a warp's item
    one tree on the whole tile; ``smem`` bytes of shared memory a block
    hold the mbarrier, a ring of two X tiles and one chunk's records.
    ``merged``: the first design's grid; ``reason`` says why the plan took
    it."""

    route: str
    tile: int = 0
    trees: int = 0
    grid: int = 0
    smem: int = 0
    reason: str = ""


QS_ROUTES = ("per_tree", "merged")
_QS_TILES = (128, 64)        # candidates a tile (a warp's item), the larger first
_QS_BAR = 16                 # the mbarrier's slot at the start of shared memory


def qs_ring_bytes(tile: int, d: int) -> int:
    """Bytes of the per_tree route's X ring: two tiles, each feature's
    column of ``tile`` candidates padded to an odd stride of ``tile + 1``."""
    return 2 * d * (tile + 1) * 8


def qs_chunk_bytes(sizes: np.ndarray, trees: int) -> int:
    """The largest chunk's bytes where chunks are ``trees`` consecutive
    records from tree 0."""
    T = len(sizes)
    pad = np.zeros(-T % trees, dtype=np.int64)
    return int(np.concatenate([sizes, pad]).reshape(-1, trees).sum(1).max(initial=0))


def qs_plan(qs: QSTables, n: int, d: int, sms: int, smem_block: int = SMEM_BLOCK) -> QSPlan:
    """The route and launch shape of Q1 for ``n`` candidates of ``d``
    features on a card of ``sms`` SMs. ``per_tree`` wherever one tree's
    record and the ring of a 64-candidate tile fit ``smem_block`` bytes
    and ``d`` fits the pairs' 16 bits; its tile is 128 candidates (four a
    lane) where their ring fits beside the largest record, else 64; its
    chunks as many trees as fit beside the ring, cut so that chunks x tiles
    fills the SMs in one round where the tiles alone do not (a unit of a
    small pool costs its latency, whatever its trees). ``merged``
    otherwise."""
    trees = qs.trees
    if trees is None:
        return QSPlan("merged", reason="no per-tree layout")
    if d >= 1 << 16:
        return QSPlan("merged", reason=f"{d} features exceed the pairs' 16-bit feature index")
    T = qs.n_trees
    biggest = int(trees.sizes.max(initial=0))
    for tile in _QS_TILES:
        room = smem_block - _QS_BAR - qs_ring_bytes(tile, d)
        if room < biggest:
            continue
        tiles = -(-max(n, 1) // tile)
        per = -(-T // max(1, sms // tiles))   # the fewest trees a chunk in one round
        per = max(1, min(T, per))
        while per > 1 and qs_chunk_bytes(trees.sizes, per) > room:
            per -= 1
        chunks = -(-T // per)
        return QSPlan("per_tree", tile, per, max(1, min(chunks * tiles, sms)), smem_block)
    return QSPlan("merged", reason=(
        f"a tree's record of {biggest} bytes and a ring of {_QS_TILES[-1]} candidates x {d} "
        f"features exceed {smem_block} bytes of shared memory"))


def qs_plan_fits(plan: QSPlan, qs: QSTables, d: int) -> bool:
    """True where ``plan``'s launch holds ``qs``: on ``per_tree``, every
    chunk of its tree count fits beside the ring; ``merged`` holds any
    plane."""
    if plan.route == "merged":
        return True
    if qs.trees is None:
        return False
    room = plan.smem - _QS_BAR - qs_ring_bytes(plan.tile, d)
    return qs_chunk_bytes(qs.trees.sizes, plan.trees) <= room


def qs_leaf_stats_plain(X: torch.Tensor, qs: QSTables, t_rows: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_qs_leaf_stats`` in torch int64 ops: per feature
    the rank ``r = #(thr < v)`` (``searchsorted``, side left), the table row
    ANDed into every tree's words, each tree's exit leaf the lowest set bit
    (word 0 first; an empty word counts 64). Rows of the (t_rows, N)
    outputs past T are zero."""
    N, D = X.shape
    T, W = qs.n_trees, qs.n_words
    t_rows = T if t_rows is None else t_rows
    off = qs.thr_off.tolist()
    tabs = qs.tables.view(-1, T, W)
    w = None
    for j in range(D):
        a, b = off[j], off[j + 1]
        if a == b:
            continue
        r = torch.searchsorted(qs.thr[a:b].contiguous(), X[:, j].contiguous(), right=False)
        wj = tabs[a + j + r]
        w = wj if w is None else w & wj
    offs = qs.leaf_off.to(torch.int64)
    if w is None:   # a forest of root leaves
        idx = offs[None, :].expand(N, T)
    else:
        leaf = _lowbit_ordinal(w[..., 0])
        leaf = torch.where(leaf < 0, 64, leaf)
        if W == 2:
            leaf1 = _lowbit_ordinal(w[..., 1])
            leaf = torch.where(w[..., 0] != 0, leaf, 64 + torch.where(leaf1 < 0, 64, leaf1))
        idx = offs[None, :] + leaf
    m = torch.zeros((t_rows, N), dtype=torch.float64, device=X.device)
    v = torch.zeros((t_rows, N), dtype=torch.float64, device=X.device)
    m[:T] = qs.leaf_mean[idx].T
    v[:T] = qs.leaf_var[idx].T
    return m, v


def _record(blob: np.ndarray, at: int, wb: int):
    """One tree's record of a :class:`TreeTables` blob, parsed as the
    kernel reads it: (singles' features, singles' thresholds, pairs (P, 2)
    int32, thresholds, leaf means, leaf vars, words (S + M + P, 1 or 2)
    int64)."""
    S, P, M, L = (int(x) for x in blob[at:at + 16].view(np.int32))
    o = at + 16
    ent = blob[o:o + 16 * S].view(np.int32).reshape(S, 4)
    sthr = blob[o:o + 16 * S].view(np.float64).reshape(S, 2)[:, 1]
    o += 16 * S
    pairs = blob[o:o + 8 * P].view(np.int32).reshape(P, 2)
    o += 8 * P
    thr = blob[o:o + 8 * M].view(np.float64)
    o += 8 * M
    lm = blob[o:o + 8 * L].view(np.float64)
    lv = blob[o + 8 * L:o + 16 * L].view(np.float64)
    o = at + _align16(o + 16 * L - at)
    n = S + M + P
    words = blob[o:o + wb * n]
    words = (words.view(np.uint32).astype(np.int64)[:, None] if wb == 4
             else words.view(np.int64).reshape(n, wb // 8))
    return ent[:, 0], sthr, pairs, thr, lm, lv, torch.from_numpy(words.copy())


def qs_leaf_stats_tree_model(X: torch.Tensor, qs: QSTables, plan: QSPlan,
                             t_rows: Optional[int] = None, leaves: bool = False):
    """The ``per_tree`` route's walk in torch ops on the CPU, over the
    records as the kernel stages them: chunk by chunk (``plan.trees``
    records from ``tree_off`` of the chunk's first tree, one copy), each
    candidate a tree: every single's false mask ANDed in where its
    threshold is below the candidate's value, then for every pair its rank
    ``#(thr < v)`` by strict compares against the pair's thresholds and
    the pair's word at that rank ANDed in; the exit leaf the lowest set
    bit (word 0 first), the leaf's stats read from the record. Returns the
    (t_rows, N) means and vars, rows past T zero; with ``leaves``, also
    the (T, N) global leaf ordinals (each tree's first ordinal plus its
    exit leaf)."""
    trees = qs.trees
    N, D = X.shape
    T = qs.n_trees
    t_rows = T if t_rows is None else t_rows
    blob = trees.blob.cpu().numpy()
    off = trees.tree_off.cpu().numpy().astype(np.int64)
    wb = trees.word_bytes
    Xc = X.cpu()
    m = torch.zeros((t_rows, N), dtype=torch.float64)
    v = torch.zeros((t_rows, N), dtype=torch.float64)
    ids = torch.zeros((T, N), dtype=torch.int64)
    first = 0
    for t0 in range(0, T, plan.trees):
        t1 = min(T, t0 + plan.trees)
        staged = blob[off[t0]:off[t1]].copy()    # the chunk's one bulk copy
        for t in range(t0, t1):
            sj, sthr, pairs, thr, lm, lv, words = _record(staged, int(off[t] - off[t0]), wb)
            S = len(sj)
            acc = torch.full((N, words.shape[1]), -1, dtype=torch.int64)
            for i in range(S):
                below = torch.from_numpy(sthr[i:i + 1].copy()) < Xc[:, int(sj[i])]
                acc = torch.where(below[:, None], acc & words[i], acc)
            for p in range(len(pairs)):
                s, key = int(pairs[p, 0]), int(pairs[p, 1])
                j, n = key & 0xFFFF, key >> 16
                th = torch.from_numpy(thr[s:s + n].copy())
                r = (th[None, :] < Xc[:, j:j + 1]).sum(1)
                acc &= words[S + s + p + r]
            leaf = _lowbit_ordinal(acc[:, 0])
            if wb == 16:
                leaf = torch.where(acc[:, 0] != 0, leaf, 64 + _lowbit_ordinal(acc[:, 1]))
            m[t] = torch.from_numpy(lm.copy())[leaf]
            v[t] = torch.from_numpy(lv.copy())[leaf]
            ids[t] = first + leaf
            first += len(lm)
    dev = X.device
    out = (m.to(dev), v.to(dev))
    return out + (ids.to(dev),) if leaves else out


def qs_leaf_stats_cuda(X: torch.Tensor, qs: QSTables, t_rows: Optional[int] = None,
                       plan: Optional[QSPlan] = None, route: Optional[str] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch Q1 on the card, on ``plan``'s route (by default
    :func:`qs_plan`'s for this pool; ``route`` forces one, and raises where
    the plane cannot take it). Both routes read T and the word width from
    a ``meta`` on the device, so a CUDA graph replays the launch for any
    plane whose tables fit the buffers (and, on ``per_tree``, whose chunks
    fit the plan: :func:`qs_plan_fits`); ``t_rows`` (>= T) sizes the
    outputs, whose rows past T it leaves unwritten."""
    N, D = X.shape
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"qs_descent: the CUDA kernel needs tensors on the card, got {dev}")
    t_rows = qs.n_trees if t_rows is None else int(t_rows)
    if plan is None:
        plan = qs_plan(qs, N, D, n_sms(dev))
        if route == "merged" and plan.route != "merged":
            plan = QSPlan("merged", reason="forced")
    if route is not None and plan.route != route:
        raise ValueError(f"qs_descent: the {route} route cannot take this plane ({plan.reason})")
    if plan.route not in QS_ROUTES:
        raise ValueError(f"qs_descent: unknown route {plan.route!r}; expected one of {QS_ROUTES}")
    check("X", X, torch.float64, (N, D), dev)
    if t_rows < qs.n_trees:
        raise ValueError(f"qs_descent: {qs.n_trees} trees need {qs.n_trees} output rows, "
                         f"got {t_rows}")
    out = (torch.empty((t_rows, N), dtype=torch.float64, device=dev),
           torch.empty((t_rows, N), dtype=torch.float64, device=dev))
    if plan.route == "per_tree":
        tt = qs.trees
        if tt is None:
            raise ValueError("qs_descent: the per_tree route needs the per-tree tables")
        check("blob", tt.blob, torch.uint8, (-1,), dev)
        check("tree_off", tt.tree_off, torch.int32, (-1,), dev)
        check("meta", tt.meta, torch.int32, (2,), dev)
        if tt.tree_off.shape[0] < qs.n_trees + 1:
            raise ValueError(f"qs_descent: {qs.n_trees} trees need {qs.n_trees + 1} record "
                             f"offsets, got {tt.tree_off.shape[0]}")
        if N == 0 or t_rows == 0:
            return out
        launch("qs_descent", "qs_tree_launch", dev,
               (X, tt.blob, tt.tree_off, tt.meta, out[0], out[1]),
               (N, D, plan.tile, plan.trees, plan.grid, plan.smem), route="per_tree")
        return out
    check("thr", qs.thr, torch.float64, (-1,), dev)
    check("thr_off", qs.thr_off, torch.int32, (D + 1,), dev)
    check("tables", qs.tables, torch.int64, (-1,), dev)
    check("leaf_mean", qs.leaf_mean, torch.float64, (-1,), dev)
    check("leaf_var", qs.leaf_var, torch.float64, (qs.leaf_mean.shape[0],), dev)
    check("leaf_off", qs.leaf_off, torch.int32, (-1,), dev)
    check("meta", qs.meta, torch.int32, (2,), dev)
    if qs.leaf_off.shape[0] < qs.n_trees:
        raise ValueError(f"qs_descent: {qs.n_trees} trees need {qs.n_trees} leaf offsets, "
                         f"got {qs.leaf_off.shape[0]}")
    if N == 0 or t_rows == 0:
        return out
    smem = 4 * (_QS_ROWS * D + _QS_CHUNK * _QS_ROWS)
    launch("qs_descent", "qs_descent_launch", dev,
           (X, qs.thr, qs.thr_off, qs.tables, qs.leaf_mean, qs.leaf_var, qs.leaf_off, qs.meta,
            out[0], out[1]), (N, D, t_rows, smem), route="merged")
    return out


def qs_leaf_stats(X: torch.Tensor, qs: QSTables, t_rows: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, N) leaf means and vars of a unit pool through the QuickScorer
    tables (Q1 on the card, on its plan's route; the merged tables' plain
    version on the CPU)."""
    if X.device.type == "cuda":
        return qs_leaf_stats_cuda(X, qs, t_rows)
    if X.device.type != "cpu":
        raise ValueError(f"qs_descent: unsupported device {X.device}")
    PLAIN_CALLS["qs_descent"] += 1
    return qs_leaf_stats_plain(X, qs, t_rows)


# ---------------------------------------------------------------------------
# Q2: the per-source combine fused with EI
# ---------------------------------------------------------------------------


def _combine_source(m_t, v_t, y_mean, y_std, y_std2):
    """The reference's ``_combine_source`` on one source's (tps, N) leaf
    stats: rows added in tree order, each sum divided by T, the mean of
    squared deviations, the 1e-10 floor, the denormalisation (each product
    its own rounding)."""
    T = m_t.shape[0]
    ms = m_t[0]
    for t in range(1, T):
        ms = ms + m_t[t]
    mean = div_scalar(ms, T)
    vs = v_t[0]
    for t in range(1, T):
        vs = vs + v_t[t]
    vmean = div_scalar(vs, T)
    dev = m_t[0] - mean
    acc = dev * dev
    for t in range(1, T):
        dev = m_t[t] - mean
        acc = acc + dev * dev
    var = torch.clamp_min(vmean + div_scalar(acc, T), _VAR_FLOOR)
    return mean * y_std + y_mean, var * y_std2


def combine_ei_plain(m_leaf, v_leaf, ystats, inc, meta) -> torch.Tensor:
    """(S_rows, N) EI: for each source s < S its ``tps`` rows of the leaf
    stats combined (:func:`_combine_source`), then the portable EI against
    ``inc[s]``; columns at or past ``n_valid`` get -1, rows at or past S
    get 0. ``ystats`` (3, S_rows): y_mean, y_std, Python's y_std ** 2;
    ``meta`` (3,) int32: S, tps, n_valid."""
    from ...core.acquisition import make_portable_kernels

    ei = make_portable_kernels()["ei"]
    S_rows, N = inc.shape[0], m_leaf.shape[1]
    S, tps, n_valid = (int(x) for x in meta.tolist())
    out = torch.zeros((S_rows, N), dtype=torch.float64, device=m_leaf.device)
    for s in range(S):
        a = s * tps
        mean, var = _combine_source(m_leaf[a:a + tps], v_leaf[a:a + tps], ystats[0, s],
                                    ystats[1, s], ystats[2, s])
        out[s] = ei(mean, var, inc[s])
    out[:S, n_valid:] = -1.0
    return out


def combine_ei_cuda(m_leaf, v_leaf, ystats, inc, meta) -> torch.Tensor:
    """Launch Q2 on the card. S, tps and n_valid come from ``meta`` on the
    device, so a CUDA graph replays it for any source count up to the
    buffers' rows."""
    dev = m_leaf.device
    if dev.type != "cuda":
        raise ValueError(f"combine_ei: the CUDA kernel needs tensors on the card, got {dev}")
    T_rows, N = m_leaf.shape
    S_rows = inc.shape[0]
    check("m_leaf", m_leaf, torch.float64, (T_rows, N), dev)
    check("v_leaf", v_leaf, torch.float64, (T_rows, N), dev)
    check("ystats", ystats, torch.float64, (3, S_rows), dev)
    check("inc", inc, torch.float64, (S_rows,), dev)
    check("meta", meta, torch.int32, (3,), dev)
    out = torch.empty((S_rows, N), dtype=torch.float64, device=dev)
    if N == 0 or S_rows == 0:
        return out
    launch("combine_ei", "combine_ei_launch", dev, (m_leaf, v_leaf, ystats, inc, meta, out),
           (S_rows, N, T_rows))
    return out


def combine_ei(m_leaf, v_leaf, ystats, inc, meta) -> torch.Tensor:
    """The (S_rows, N) EI matrix of the step (Q2 on the card, its plain
    version on the CPU); see :func:`combine_ei_plain`."""
    if m_leaf.device.type == "cuda":
        return combine_ei_cuda(m_leaf, v_leaf, ystats, inc, meta)
    if m_leaf.device.type != "cpu":
        raise ValueError(f"combine_ei: unsupported device {m_leaf.device}")
    PLAIN_CALLS["combine_ei"] += 1
    return combine_ei_plain(m_leaf, v_leaf, ystats, inc, meta)


# ---------------------------------------------------------------------------
# ranks, aggregate, top k (K2)
# ---------------------------------------------------------------------------

def aggregate(ranks: torch.Tensor, weights: torch.Tensor) -> torch.Tensor:
    """sum_s w_s * rank_s, added in source order from the first product
    (the reference's ``_aggregate_ranks_traced``). A row of weight 0 adds
    +0.0, which leaves a sum of non-negative ranks as it was."""
    agg = weights[0] * ranks[0]
    for s in range(1, ranks.shape[0]):
        agg = agg + weights[s] * ranks[s]
    return agg


def topk_perm(agg: torch.Tensor) -> torch.Tensor:
    """The permutation ``argsort(agg, stable)`` gives, without a sort: K2's
    stable rank of each element's ascending key, then each index scattered
    to its rank (no host sync)."""
    N = agg.shape[0]
    r = radix_rank(ascending_keys(agg)[None])[0].to(torch.int64)
    idx = torch.arange(N, dtype=torch.int64, device=agg.device)
    return torch.empty_like(idx).scatter_(0, r, idx)


def score_rows(m_leaf, v_leaf, ystats, inc, weights, meta) -> Tuple[torch.Tensor, torch.Tensor]:
    """From the leaf stats to the selection: Q2's EI rows, K2's ranks of
    each, their weighted sum with padding at +inf, and the stable ascending
    order of that sum. Returns (perm, agg), each (N,)."""
    scores = combine_ei(m_leaf, v_leaf, ystats, inc, meta)
    ranks = radix_rank(monotone_keys(scores))
    agg = aggregate(ranks, weights)
    valid = torch.arange(agg.shape[0], device=agg.device) < meta[2]
    agg = torch.where(valid, agg, float("inf"))
    return topk_perm(agg), agg


# ---------------------------------------------------------------------------
# the device pool
# ---------------------------------------------------------------------------


def unit_col(sig_j, tab, u: torch.Tensor) -> torch.Tensor:
    """One knob column: unit draw -> restriction-CDF value -> unit encode
    (the reference's ``_unit_col``: ``SpacePlane._quantile_col`` then the
    clipped ``_to_unit_col``). ``tab`` holds the knob's tables as tensors
    on ``u``'s device."""
    kind, is_log, transformed, degenerate, zero_span, size = sig_j
    u = u.contiguous()
    if kind == _K_CONST:
        return tab[0][0].expand(u.shape)
    if kind in (_K_FLOAT, _K_INT):
        ga, gb, cum, mid, scal = tab
        P = size
        if degenerate:
            v = mid[torch.clamp_max((u * P).to(torch.int64), P - 1)]
        else:
            i = torch.clamp(torch.searchsorted(cum, u, right=True) - 1, 0, P - 1)
            lo = cum[i]
            span = cum[i + 1] - lo
            frac = torch.where(span > 0, (u - lo) / torch.where(span > 0, span, 1.0), 0.0)
            g = ga[i] + frac * (gb[i] - ga[i])
            v = torch.exp(g) if transformed else g
        if kind == _K_INT:
            v = torch.clamp(torch.round(v), scal[2], scal[3])
        if zero_span:
            return torch.zeros_like(v)
        t = torch.log(v) if is_log else v
        return torch.clamp((t - scal[0]) / scal[1], 0.0, 1.0)
    act = tab[0]
    m = act.shape[0]
    a = act[torch.clamp_max((u * m).to(torch.int64), m - 1)].to(torch.float64)
    if kind == _K_CAT:
        return (a + 0.5) / size
    return torch.where(a != 0, 0.75, 0.25)


def draw_units(gen: torch.Generator, D: int, n: int) -> torch.Tensor:
    """(n, D) unit draws on ``gen``'s device: a uniform half, then a
    per-knob stratified LHS half whose strata are shuffled by the LCG
    bijection ``p(i) = (a i + b) mod m`` (a odd) where the strata count m
    is a power of two (the buckets make it one), by true permutations
    otherwise: one sample per stratum per knob."""
    dev = gen.device
    n_lhs = n // 2
    n_uni = n - n_lhs
    f64 = dict(dtype=torch.float64, device=dev, generator=gen)
    u_uni = torch.rand((n_uni, D), **f64)
    frac = torch.rand((n_lhs, D), **f64)
    if n_lhs > 0 and n_lhs & (n_lhs - 1) == 0:
        ab = torch.randint(0, 1 << 32, (2, D), dtype=torch.int64, device=dev, generator=gen)
        i = torch.arange(n_lhs, dtype=torch.int64, device=dev)[:, None]
        strata = ((i * (ab[0] | 1) + ab[1]) & (n_lhs - 1)).to(torch.float64)
    else:
        strata = torch.stack([torch.randperm(n_lhs, device=dev, generator=gen)
                              for _ in range(D)], 1).to(torch.float64)
    return torch.cat([u_uni, (strata + frac) / n_lhs])


def draw_unit_pool(gen: torch.Generator, sig, cols, n: int) -> torch.Tensor:
    """(n, D) unit-space pool: :func:`draw_units`, each column through
    :func:`unit_col` (the reference's ``_draw_unit_pool``)."""
    u = draw_units(gen, len(sig), n)
    return torch.stack([unit_col(s, cols[j], u[:, j]) for j, s in enumerate(sig)], 1)


# ---------------------------------------------------------------------------
# the step
# ---------------------------------------------------------------------------


def leaf_stats(X: torch.Tensor, descent: str, arena: Optional[Arena] = None,
               qs: Optional[QSTables] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, N) leaf stats of a pool by ``descent``: ``qs`` (Q1) or
    ``forest`` (K1)."""
    if descent == "qs":
        if qs is None:
            raise ValueError("the qs descent needs QuickScorer tables")
        return qs_leaf_stats(X, qs)
    if descent != "forest":
        raise ValueError(f"unknown descent {descent!r} (qs or forest)")
    a = arena
    return forest_eval(a.feat, a.thr, a.child, a.mean, a.var, a.roots, X, a.depth, a.nodes)


def propose_step(gen, cols, arena: Optional[Arena], ystats: torch.Tensor,
                 incumbents: torch.Tensor, weights: torch.Tensor, *, n_pool: int,
                 n_sources: int, tps: int, k: int, sig=(), descent: str = "forest",
                 X: Optional[torch.Tensor] = None, n_valid: Optional[int] = None,
                 qs: Optional[QSTables] = None):
    """One fused propose step. ``X=None`` draws the pool from ``gen`` over
    the transform tables (``sig``, ``cols``); an uploaded ``X`` (n_pool, D)
    (host-pool mode, real rows first, ``n_valid`` of them) pins the
    candidates, so the selection is the staged path's. ``descent`` is
    ``forest`` (K1 over ``arena``) or ``qs`` (Q1 over ``qs``). ``ystats``
    (3, S), ``incumbents`` and ``weights`` (S,) on the pool's device.
    Returns (idx, X[idx], agg[idx]), each of length ``k``."""
    if X is None:
        X = draw_unit_pool(gen, sig, cols, n_pool)
    dev = X.device
    n_valid = n_pool if n_valid is None else int(n_valid)
    meta = torch.tensor([n_sources, tps, n_valid], dtype=torch.int32, device=dev)
    m_leaf, v_leaf = leaf_stats(X, descent, arena, qs)
    perm, agg = score_rows(m_leaf, v_leaf, ystats, incumbents, weights, meta)
    idx = perm[:k]
    return idx, X[idx], agg[idx]


def propose_scan(gen, cols, arena, ystats, incumbents, weights, *, n_pool: int,
                 n_sources: int, tps: int, k: int, sig, descent: str = "forest",
                 steps: int = 1, qs: Optional[QSTables] = None):
    """``steps`` device-pool steps, the generator advancing between them;
    each output stacked on a leading ``steps`` axis."""
    outs = [propose_step(gen, cols, arena, ystats, incumbents, weights, n_pool=n_pool,
                         n_sources=n_sources, tps=tps, k=k, sig=sig, descent=descent, qs=qs)
            for _ in range(steps)]
    return tuple(torch.stack(o) for o in zip(*outs))
