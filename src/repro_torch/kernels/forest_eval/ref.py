"""Plain PyTorch versions of the packed-forest descent (K1), and models of
the card's routes of K1 and K2 for the tests.

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
  status words, at any tile shape.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = [
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
