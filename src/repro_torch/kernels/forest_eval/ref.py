"""Plain PyTorch versions of the packed-forest descent (K1), and models of
the card's routes of K1, K2 and K3 for the tests.

``forest_eval_plain`` uses the node encoding of the reference's
``core/surrogate.py::packed_descend``: leaves carry ``thr = +inf`` and
self-loop children, and ``child`` holds the two children of node ``i`` at
``[2i, 2i+1]``. ``depth`` rounds of four gathers route every (tree,
candidate) lane to its leaf with the float64 compare ``x > thr``; the
result is the leaf (mean, var), each (T, N).

The models state each new route's algorithm step by step in torch, so the
CPU tests can hold the algorithm, not only its result, to the oracles
(none of them runs outside the tests):

- :func:`forest_eval_tiled_model`: K1's ``tiled`` route, block by block:
  each (tile, group) with its local copy of the group's records, each
  lane's trees for their own number of levels;
- :func:`rank_count_model`: K2's ``count`` route, the counting rule;
- :func:`rank_onesweep_model`: K2's ``onesweep`` route: the histogram
  plan, and each pass's tile-local offsets (the warps' running counts and
  earlier warps' counts) plus the look-back prefix over earlier tiles'
  status words, at any tile shape;
- :func:`chain_ordinals_staged_model`: K3's ``staged`` route, block by
  block: each (chain group, tree tile) block with its copy of the tile's
  background words, each chain's copied words, the prefix table in
  segments with their carries, and the walk in segments of levels, each
  from the AND of the background words above it;
- :func:`chain_values_model`: K3's ``values`` route: that walk with the
  ordinals kept as bytes, then each (level, row)'s tree sum from
  x[0] + 0.0 in tree order, the division by T, the denorm, and each
  level's pairwise sum over the rows (numpy's order, halves past 128, as
  the kernel's fixed depth of halvings), + 0.0, divided by nb.
"""

from __future__ import annotations

from typing import Tuple

import torch

from .chain import _THREADS

__all__ = [
    "chain_ordinals_staged_model",
    "chain_values_model",
    "forest_eval_plain",
    "forest_eval_tiled_model",
    "rank_count_model",
    "rank_onesweep_model",
]

_MSB = -(1 << 63)


def forest_eval_plain(feat, thr, child, mean, var, roots, X, depth: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    T = roots.shape[0]
    N, D = X.shape
    xflat = X.reshape(-1)
    col = (torch.arange(N, dtype=torch.int64, device=X.device) * D)[None, :]
    nid = roots[:, None].expand(T, N).clone()
    for _ in range(depth):
        f = feat[nid]
        go_right = (xflat[col + f] > thr[nid]).to(torch.int64)
        nid = child[2 * nid + go_right]
    return mean[nid], var[nid]


def forest_eval_tiled_model(table, X, depth: int, plan) -> Tuple[torch.Tensor, torch.Tensor]:
    """K1's ``tiled`` route on a ``NodeTable`` under a ``ForestPlan``: block
    (tile, group) copies the group's records and the tile's rows, then lane
    j of each row walks trees j, j + lanes, ... of the group, each for
    min(depth, its levels) rounds, by local record index. A record index
    outside the group's copy raises (IndexError)."""
    T = table.n_trees
    N = X.shape[0]
    thr_all = table.nodes[:, 0].contiguous().view(torch.float64)
    feat_all = (table.nodes[:, 1] & 0xFFFFFFFF).to(torch.int64)
    left_all = table.nodes[:, 1] >> 32
    start = table.trees[:, 0].to(torch.int64)
    levels = table.trees[:, 1].to(torch.int64)
    m = torch.full((T, N), float("nan"), dtype=torch.float64)
    v = torch.full((T, N), float("nan"), dtype=torch.float64)
    for g in range(plan.groups):
        t0, t1 = g * plan.trees, min(T, (g + 1) * plan.trees)
        rec0, rec1 = int(start[t0]), int(start[t1])
        thr, feat, left = (a[rec0:rec1].clone() for a in (thr_all, feat_all, left_all))
        for tile in range(plan.tiles):
            n0, n1 = tile * plan.rows, min(N, (tile + 1) * plan.rows)
            xs = X[n0:n1].clone()
            rows = torch.arange(n1 - n0)[None, :]
            for lane in range(plan.lanes):
                if t0 + lane >= t1:
                    continue
                ts = torch.arange(t0 + lane, t1, plan.lanes)
                nid = (start[ts] - rec0)[:, None].expand(len(ts), n1 - n0).clone()
                rounds = torch.clamp(levels[ts], max=depth)[:, None]
                for r in range(int(rounds.max())):
                    go = (xs[rows, feat[nid]] > thr[nid]).to(torch.int64)
                    nid = torch.where(r < rounds, left[nid] - rec0 + go, nid)
                m[ts, n0:n1] = table.stats[rec0 + nid, 0]
                v[ts, n0:n1] = table.stats[rec0 + nid, 1]
    return m, v


def rank_count_model(keys: torch.Tensor) -> torch.Tensor:
    """K2's ``count`` route: rank(i) = #{j < i : k_j <= k_i} + #{j > i :
    k_j < k_i} in unsigned key order (bit 63 flipped to compare as int64)."""
    S, N = keys.shape
    k = keys ^ _MSB
    ki, kj = k[:, :, None], k[:, None, :]
    j_below = torch.arange(N)[None, :] < torch.arange(N)[:, None]   # [i, j]: j < i
    c = torch.where(j_below, kj <= ki, kj < ki).sum(2)
    return c.to(torch.float64)


def _digit(keys: torch.Tensor, p: int) -> torch.Tensor:
    return (keys >> (8 * p)) & 0xFF


def rank_onesweep_model(keys: torch.Tensor, warps: int = 8, items: int = 16,
                        wave: int = 1) -> torch.Tensor:
    """K2's ``onesweep`` route with tiles of ``warps`` x 32 lanes x ``items``
    keys (the card's: 8 x 32 x 16). Per row: the 8 digit histograms give
    each digit's first slot and the list of non-trivial passes; each pass
    walks the current (key, index) order tile by tile. In a tile, warp w
    takes ``items`` rounds of 32 consecutive elements, and an element's
    offset is the warp's running count of its digit plus the lanes below it
    with that digit, plus the earlier warps' counts. Tiles publish their
    digit counts as aggregates, then look back over earlier tiles' status
    words, summing aggregates until an inclusive word, and publish their
    inclusive count. ``wave`` tiles publish their aggregates before any of
    them looks back, the last first, so a look-back crosses aggregates as
    it does on the card when tiles run at once. Each element then takes a
    slot in the tile sorted by digit (the digit's first slot in the tile
    plus its offset), and each digit's run of slots moves to base[digit] +
    prefix. The last pass writes the ranks; a row of one key value gets
    rank = index."""
    S, N = keys.shape
    tile_n = warps * 32 * items
    out = torch.empty((S, N), dtype=torch.float64)
    for s in range(S):
        key = keys[s].clone()
        hist = torch.stack([torch.bincount(_digit(key, p), minlength=256) for p in range(8)])
        base = torch.cumsum(hist, 1) - hist
        passes = [p for p in range(8) if int(hist[p].max()) < N]
        if not passes:
            out[s] = torch.arange(N, dtype=torch.float64)
            continue
        idx = torch.arange(N)
        for k, p in enumerate(passes):
            d = _digit(key, p)
            pos = torch.empty(N, dtype=torch.int64)
            tiles = -(-N // tile_n)
            status = [None] * tiles    # (inclusive?, counts (256,))
            local = [None] * tiles
            for t in range(tiles):     # each tile's warps
                dt = d[t * tile_n:(t + 1) * tile_n]
                off = torch.empty(len(dt), dtype=torch.int64)
                warp_excl = torch.zeros(warps, 256, dtype=torch.int64)
                running = torch.zeros(256, dtype=torch.int64)
                for w in range(warps):
                    warp_excl[w] = running
                    wcount = torch.zeros(256, dtype=torch.int64)
                    for r in range(items):
                        a = w * 32 * items + r * 32
                        lanes = dt[a:a + 32]
                        if not lanes.numel():
                            break
                        oh = torch.nn.functional.one_hot(lanes, 256)
                        below = (torch.cumsum(oh, 0) - oh)[torch.arange(len(lanes)), lanes]
                        off[a:a + len(lanes)] = wcount[lanes] + below
                        wcount += oh.sum(0)
                    off[w * 32 * items:(w + 1) * 32 * items] += warp_excl[w][
                        dt[w * 32 * items:(w + 1) * 32 * items]]
                    running += wcount
                local[t] = (dt, off, running)
            for w0 in range(0, tiles, wave):
                batch = range(w0, min(tiles, w0 + wave))
                for t in batch:
                    status[t] = (t == 0, local[t][2].clone())
                for t in reversed(batch):
                    dt, off, total = local[t]
                    excl = torch.zeros(256, dtype=torch.int64)
                    for q in range(t - 1, -1, -1):
                        inclusive, cnt = status[q]
                        excl += cnt
                        if inclusive:
                            break
                    status[t] = (True, excl + total)
                    # the tile sorted by digit: each element's slot, then the
                    # slot's run moved to its digit's place in the row
                    start = torch.cumsum(total, 0) - total
                    slot = start[dt] + off
                    if not torch.equal(torch.sort(slot).values, torch.arange(len(dt))):
                        raise AssertionError("tile slots are not a permutation")
                    pos[t * tile_n:t * tile_n + len(dt)] = (base[p] + excl - start)[dt] + slot
            if k == len(passes) - 1:
                out[s, idx] = pos.to(torch.float64)   # rank[index] = position
            else:
                nk, ni = torch.empty_like(key), torch.empty_like(idx)
                nk[pos], ni[pos] = key, idx
                key, idx = nk, ni
    return out


_SEGS = 8              # segments of K3's prefix scan
_WALK_SEGS = 4         # segments of the levels of K3's walk
_PAIRWISE_DEPTH = 4    # halvings of K3's pairwise sum


def _exit_ordinal(a: torch.Tensor) -> torch.Tensor:
    """(..., W) words -> (...) the card's exit ordinal: __ffsll(word 0) - 1,
    or 63 + __ffsll(word 1) where word 0 is zero (W = 2)."""
    def ffs(w):   # 1 + index of the lowest set bit (the float64 exponent of it), 0 for 0
        low = w & -w
        bit = ((low.to(torch.float64).view(torch.int64) >> 52) & 0x7FF) - 1022
        return torch.where(w == 0, 0, bit)
    o = ffs(a[..., 0]) - 1
    if a.shape[-1] == 2:
        o = torch.where(a[..., 0] != 0, o, 63 + ffs(a[..., 1]))
    return o


def _walk_blocks(word_x, word_b, perms, plan, x_of_chain, threads):
    """Yield (chain, tree offset, (d+1, nb, tn) ordinals) block by block, as
    the staged kernels compute them."""
    C, d = perms.shape
    nb, _, T, W = word_b.shape
    rows = torch.arange(C) if x_of_chain is None else x_of_chain.long()
    for tile in range(-(-T // plan.trees)):
        t0 = tile * plan.trees
        tn = min(plan.trees, T - t0)
        segs = max(1, min(_SEGS, threads // (tn * W)))
        seg_len = -(-d // segs)
        hs = max(1, min(_WALK_SEGS, threads // (nb * tn)))
        hl = -(-(d + 1) // hs)
        for g in range(plan.groups):
            bg = word_b[:, :, t0:t0 + tn].clone()              # (nb, d, tn, W)
            for c in range(g, C, plan.groups):
                xw = word_x[rows[c], :, t0:t0 + tn].clone()    # (d, tn, W)
                pb = perms[c].long()
                pref = torch.empty((d + 1, tn, W), dtype=torch.int64)
                pref[0] = -1
                totals = []
                for s in range(segs):
                    acc = torch.full((tn, W), -1, dtype=torch.int64)
                    for k in range(s * seg_len, min(d, (s + 1) * seg_len)):
                        acc = acc & xw[pb[k]]
                        pref[k + 1] = acc
                    totals.append(acc)
                for s in range(1, segs):
                    carry = torch.full((tn, W), -1, dtype=torch.int64)
                    for r in range(s):
                        carry = carry & totals[r]
                    k0, k1 = s * seg_len, min(d, (s + 1) * seg_len)
                    pref[k0 + 1:k1 + 1] &= carry
                # the walk: levels in hs segments, each from the AND of the
                # background words the segments above it take in
                o = torch.empty((d + 1, nb, tn), dtype=torch.int64)
                totals = {}
                for h in range(1, hs):
                    acc = torch.full((nb, tn, W), -1, dtype=torch.int64)
                    for j in range(h * hl - 1, min(d, (h + 1) * hl - 1)):
                        acc = acc & bg[:, pb[j]]
                    totals[h] = acc
                for h in range(hs):
                    suf = torch.full((nb, tn, W), -1, dtype=torch.int64)
                    for r in range(h + 1, hs):
                        suf = suf & totals[r]
                    lo, top = h * hl, min(d, (h + 1) * hl - 1)
                    for k in range(top, lo - 1, -1):
                        o[k] = _exit_ordinal(pref[k][None] & suf)
                        if k > lo:
                            suf = suf & bg[:, pb[k - 1]]
                yield c, t0, o


def chain_ordinals_staged_model(word_x, word_b, perms, plan, x_of_chain=None,
                                threads: int = _THREADS) -> torch.Tensor:
    """K3's ``staged`` route under a ``WalkPlan`` (any tree tile): (C, d+1,
    nb, T) int32 ordinals; word_x (C, d, T, W), or rows (n, d, T, W) with
    ``x_of_chain``. A plan the launcher refuses raises (ValueError)."""
    C, d = perms.shape
    nb, _, T, W = word_b.shape
    if not 1 <= plan.groups <= C:
        raise ValueError(f"{plan.groups} chain groups for {C} chains")
    out = torch.full((C, d + 1, nb, T), -(1 << 30), dtype=torch.int32)
    for c, t0, o in _walk_blocks(word_x, word_b, perms, plan, x_of_chain, threads):
        out[c, :, :, t0:t0 + o.shape[2]] = o.to(torch.int32)
    return out


def _pairwise(x, n: int, depth: int) -> float:
    """The kernel's pairwise sum of the Python floats x[:n]."""
    if n > 128:
        if depth == 0:
            raise ValueError("more background rows than the kernel's halvings take")
        n2 = n // 2
        n2 -= n2 % 8
        return _pairwise(x[:n2], n2, depth - 1) + _pairwise(x[n2:], n - n2, depth - 1)
    if n < 8:
        acc = x[0]
        for i in range(1, n):
            acc += x[i]
        return acc
    r = list(x[:8])
    i, stop = 8, n - n % 8
    while i < stop:
        for j in range(8):
            r[j] += x[i + j]
        i += 8
    res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
    for k in range(i, n):
        res += x[k]
    return res


def chain_values_model(words, x_of_chain, word_b, perms, leaf_mean, leaf_offs, y_std: float,
                       y_mean: float, plan, threads: int = _THREADS) -> torch.Tensor:
    """K3's ``values`` route under a ``WalkPlan`` of one tile: (C, d+1)
    float64 chain values from word rows (n, d, T, W) and ``x_of_chain``."""
    C, d = perms.shape
    nb, _, T, W = word_b.shape
    if plan.route != "values" or plan.trees != T:
        raise ValueError("the values route walks every tree in one block")
    vals = torch.full((C, d + 1), float("nan"), dtype=torch.float64)
    lm = leaf_mean.clone()
    offs = leaf_offs.to(torch.int32).long()
    for c, _, o in _walk_blocks(words, word_b, perms, plan, x_of_chain, threads):
        m = lm[offs + o.to(torch.uint8).long()]                       # (d+1, nb, T)
        s = m[..., 0] + 0.0
        for t in range(1, T):
            s = s + m[..., t]
        s = s / torch.tensor(float(T), dtype=torch.float64)
        rows = (s * y_std + y_mean).tolist()                           # (d+1) x nb
        for k in range(d + 1):
            vals[c, k] = (_pairwise(rows[k], nb, _PAIRWISE_DEPTH) + 0.0) / nb
    return vals
