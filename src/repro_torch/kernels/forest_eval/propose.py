"""The fused BO propose step (ROADMAP item 7), in torch with two kernels.

Counterpart of ``repro/kernels/forest_eval/propose.py``. One step scores a
candidate pool against every surrogate source and returns the top k:

1. the pool: uploaded (host-pool mode, the staged path's own candidates)
   or drawn on the device (:func:`draw_unit_pool`: a uniform half and a
   per-knob stratified LHS half in unit space, replayed through the sample
   space's restriction CDFs, :func:`unit_col`);
2. the descent: per-tree leaf (mean, var), (T, N), either through K1
   (``forest``, ``ops.forest_eval``) or through the merged QuickScorer
   tables (``qs``, :func:`qs_leaf_stats`, kernel Q1, ``csrc/qs_descent.cu``);
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

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...numerics import div_scalar
from ..counts import PLAIN_CALLS
from ..launch import check, launch
from .chain import _lowbit_ordinal, build_false_tables, pack_leaf_spans
from .ops import forest_eval
from .rank import ascending_keys, monotone_keys, radix_rank

__all__ = [
    "POOL_BUCKET_MIN",
    "POOL_BUCKET_MAX",
    "Arena",
    "QSTables",
    "aggregate",
    "build_qs_plan_ex",
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
    "qs_tables",
    "score_rows",
    "topk_perm",
    "unit_col",
]

POOL_BUCKET_MIN = 256
POOL_BUCKET_MAX = 131072

_K_FLOAT, _K_INT, _K_CAT, _K_BOOL, _K_CONST = 0, 1, 2, 3, 4
_VAR_FLOOR = 1e-10          # the combine's variance floor (PackedForest.combine)
_QS_ROWS = 32               # candidates a Q1 block (the kernel's kRows)
_QS_CHUNK = 128             # trees a Q1 block (the kernel's kChunk)


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
# Q1: the merged QuickScorer descent
# ---------------------------------------------------------------------------


class QSTables(NamedTuple):
    """The merged QuickScorer tables of a fused arena, on one device.

    ``thr`` (M,) float64: every feature's split thresholds, each feature's
    sorted, laid end to end; feature j's are ``thr[thr_off[j]:thr_off[j +
    1]]`` (``thr_off`` (D + 1,) int32). ``tables`` int64 (uint64 bits),
    flat: feature j's prefix-ANDed false-node table has ``n_j + 1`` rows
    starting at row ``thr_off[j] + j``, a row holding T trees' W leaf words
    (row-major, words innermost). ``leaf_mean``/``leaf_var`` (L,) float64 by
    leaf ordinal, ``leaf_off`` (T,) int32 each tree's first ordinal.
    ``meta`` (2,) int32 on the device holds (T, W) for the kernel;
    ``n_trees``/``n_words`` the same on the host."""

    thr: torch.Tensor
    thr_off: torch.Tensor
    tables: torch.Tensor
    leaf_mean: torch.Tensor
    leaf_var: torch.Tensor
    leaf_off: torch.Tensor
    meta: torch.Tensor
    n_trees: int
    n_words: int


def build_qs_plan_ex(feat, thr, child, mean, var, roots, d):
    """Host-side QuickScorer tables for a fused multi-source arena (numpy
    arrays): the reference's ``build_qs_plan_ex``, through the port's own
    chain packer (``chain.pack_leaf_spans``, ``chain.build_false_tables``).
    Returns ``((thrs, tables, leaf_mean, leaf_var, leaf_offs), "")``, each
    feature's sorted thresholds and its (n_thr + 1, T[, 2]) uint64 table,
    or ``(None, reason)`` where a tree has more than 128 leaves or splits
    outside the d-dim space."""
    packed, reason = pack_leaf_spans(feat, thr, child, mean, var, roots, d)
    if packed is None:
        return None, reason
    nodes_by_feat, leaf_mean, leaf_var, leaf_offs, n_words = packed
    thrs, tables = build_false_tables(nodes_by_feat, len(roots), n_words)
    return (tuple(thrs), tuple(tables), leaf_mean, leaf_var, leaf_offs), ""


def qs_tables(plan, device) -> QSTables:
    """:class:`QSTables` on ``device`` from :func:`build_qs_plan_ex`'s plan."""
    thrs, tabs, lm, lv, offs = plan
    T = len(offs)
    W = 1 if tabs[0].ndim == 2 else tabs[0].shape[2]
    off = np.concatenate([[0], np.cumsum([len(t) for t in thrs])]).astype(np.int32)
    flat = np.concatenate([t.reshape(t.shape[0], -1) for t in tabs]).reshape(-1)

    def to(a, dt):
        return torch.from_numpy(np.ascontiguousarray(a, dtype=dt)).to(device)

    return QSTables(
        to(np.concatenate(thrs) if thrs else np.zeros(0), np.float64), to(off, np.int32),
        to(flat.view(np.int64), np.int64), to(lm, np.float64), to(lv, np.float64),
        to(offs, np.int32), to(np.array([T, W]), np.int32), T, W)


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


def qs_leaf_stats_cuda(X: torch.Tensor, qs: QSTables, t_rows: Optional[int] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch Q1 on the card. The kernel reads T and W from ``qs.meta`` on
    the device, so a CUDA graph replays it for any plane whose tables fit
    the buffers; ``t_rows`` (>= T) sizes the outputs, whose rows past T it
    leaves unwritten."""
    N, D = X.shape
    dev = X.device
    if dev.type != "cuda":
        raise ValueError(f"qs_descent: the CUDA kernel needs tensors on the card, got {dev}")
    t_rows = qs.n_trees if t_rows is None else int(t_rows)
    check("X", X, torch.float64, (N, D), dev)
    check("thr", qs.thr, torch.float64, (-1,), dev)
    check("thr_off", qs.thr_off, torch.int32, (D + 1,), dev)
    check("tables", qs.tables, torch.int64, (-1,), dev)
    check("leaf_mean", qs.leaf_mean, torch.float64, (-1,), dev)
    check("leaf_var", qs.leaf_var, torch.float64, (qs.leaf_mean.shape[0],), dev)
    check("leaf_off", qs.leaf_off, torch.int32, (-1,), dev)
    check("meta", qs.meta, torch.int32, (2,), dev)
    if qs.leaf_off.shape[0] < qs.n_trees or t_rows < qs.n_trees:
        raise ValueError(f"qs_descent: {qs.n_trees} trees need {qs.n_trees} leaf offsets and "
                         f"output rows, got {qs.leaf_off.shape[0]} and {t_rows}")
    out = (torch.empty((t_rows, N), dtype=torch.float64, device=dev),
           torch.empty((t_rows, N), dtype=torch.float64, device=dev))
    if N == 0 or t_rows == 0:
        return out
    smem = 4 * (_QS_ROWS * D + _QS_CHUNK * _QS_ROWS)
    launch("qs_descent", "qs_descent_launch", dev,
           (X, qs.thr, qs.thr_off, qs.tables, qs.leaf_mean, qs.leaf_var, qs.leaf_off, qs.meta,
            out[0], out[1]), (N, D, t_rows, smem))
    return out


def qs_leaf_stats(X: torch.Tensor, qs: QSTables, t_rows: Optional[int] = None
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(T, N) leaf means and vars of a unit pool through the merged
    QuickScorer tables (Q1 on the card, its plain version on the CPU)."""
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
