"""The card's routes of K1 (forest descent) and K2 (radix rank) on the CPU.

The plain torch models of the new routes (``ref.forest_eval_tiled_model``,
``ref.rank_count_model``, ``ref.rank_onesweep_model``) state each
algorithm step by step: K1's descent through ``pack_nodes``' records block
by block, K2's counting rule, and K2's tile-local offsets plus look-back
prefixes at small tiles. Each is held bit for bit to the plain versions and
to the reference's oracles (``packed_descend``, ``forest_eval_pallas`` and
``radix_rank_pallas`` in interpret mode, ``rank_rows_reference``), on ties
x == thr, NaN and +-inf in X, one-leaf trees and depth 0 for K1, and on
IEEE special values, tied rows and ties across tile edges for K2. The
route planners (``forest_plan``, ``rank_route``) are held to covering every
(tree, candidate) or element once within the shared-memory budget, and to
putting the tuner's shapes and 131072 candidates on the new routes.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import surrogate as RS
from repro.kernels.forest_eval import rank as RR
from repro.kernels.forest_eval.kernel import forest_eval_pallas
from repro_torch.kernels.forest_eval import ops, rank, ref

SPECIALS = np.array(
    [0.0, -0.0, 5e-324, -5e-324, 1e-310, -1e-310, np.finfo(np.float64).tiny,
     -np.finfo(np.float64).tiny, np.inf, -np.inf, np.finfo(np.float64).max,
     -np.finfo(np.float64).max, 1.0, -1.0, 3.5, -3.5],
    dtype=np.float64,
)


def _special_rows(seed: int, n_rows: int, n: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = SPECIALS[rng.integers(0, len(SPECIALS), size=(n_rows, n))]
    return np.ascontiguousarray(
        np.where(rng.random((n_rows, n)) < 0.5, rng.standard_normal((n_rows, n)), rows))


def _tied_rows(n: int) -> np.ndarray:
    s = np.zeros((4, n))
    s[1] = -0.0                                   # one key: every pass trivial
    s[2, ::2] = -0.0
    s[3] = np.arange(n) % 3                       # three values, ties across tiles
    return s


def _keys(scores: np.ndarray) -> torch.Tensor:
    return rank.monotone_keys(torch.from_numpy(scores))


# (warps, items, wave): the card's tile (8 x 32 x 16 = 4096 keys) and small
# tiles of 64 and 128 keys, some with tiles that look back past aggregates
TILES = [(8, 16, 1), (2, 2, 1), (1, 2, 3), (2, 1, 4)]


@pytest.mark.parametrize("seed,n", [(0, 64), (1, 97), (2, 1), (3, 300), (4, 513)])
def test_rank_models_match_the_reference_on_special_rows(seed, n):
    s = _special_rows(seed, 4, n)
    keys = _keys(s)
    want = RR.rank_rows_reference(s)
    np.testing.assert_array_equal(rank.radix_rank_plain(keys).numpy(), want)
    np.testing.assert_array_equal(ref.rank_count_model(keys).numpy(), want)
    for warps, items, wave in TILES:
        np.testing.assert_array_equal(ref.rank_onesweep_model(keys, warps, items, wave).numpy(),
                                      want)


@pytest.mark.parametrize("n", [1, 33, 200])
def test_rank_models_keep_index_order_in_tied_rows(n):
    s = _tied_rows(n)
    keys = _keys(s)
    want = RR.rank_rows_reference(s)
    np.testing.assert_array_equal(want[:2], np.broadcast_to(np.arange(float(n)), (2, n)))
    np.testing.assert_array_equal(ref.rank_count_model(keys).numpy(), want)
    for warps, items, wave in TILES:
        np.testing.assert_array_equal(ref.rank_onesweep_model(keys, warps, items, wave).numpy(),
                                      want)


def test_rank_models_match_pallas_interpret():
    s = np.concatenate([_special_rows(5, 3, 256), _tied_rows(256)])
    with jax.enable_x64(True):
        jkeys = RR.monotone_keys_traced(jax.numpy.asarray(s))
        want = np.asarray(RR.radix_rank_pallas(jkeys, interpret=True))
    keys = _keys(s)
    np.testing.assert_array_equal(ref.rank_count_model(keys).numpy(), want)
    np.testing.assert_array_equal(ref.rank_onesweep_model(keys, 2, 2, 2).numpy(), want)


def test_rank_route_plans_the_tuner_and_the_propose_scale():
    assert rank.rank_route(34, 256) == "count"
    assert rank.rank_route(1, 1) == "count"
    assert rank.rank_route(12, rank.COUNT_N) == "count"
    assert rank.rank_route(12, rank.COUNT_N + 1) == "onesweep"
    assert rank.rank_route(12, 131072) == "onesweep"
    assert rank.rank_route(65536, 256) == "block"
    assert rank.rank_route(2, 1 << 30) == "block"
    assert rank.COUNT_N <= rank.COUNT_LIMIT and rank.COUNT_LIMIT * 8 <= 48 * 1024
    with pytest.raises(ValueError):
        rank.rank_route(0, 5)


@pytest.mark.parametrize("S,N", [(1, 1), (12, 131072), (34, 4097), (3, 4096)])
def test_onesweep_tiles_cover_each_element_once(S, N):
    tile = rank.SWEEP_TILE
    tiles = -(-N // tile)
    cover = np.zeros(N, dtype=np.int64)
    for t in range(tiles):
        for w in range(8):
            for r in range(16):
                e = t * tile + w * 512 + r * 32 + np.arange(32)
                np.add.at(cover, e[e < N], 1)
    assert (cover == 1).all()
    assert rank._sweep_region(S, N) == S + S * tiles * 256


# ------------------------------------------------------------------- K1


def _forest(seed, n_trees=6, n=60, d=7, leaf_tree=True):
    """A reference forest's arena, with a one-leaf tree appended."""
    rng = np.random.default_rng(seed)
    X = rng.random((n, d))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.1 * rng.standard_normal(n)
    pf = RS.make_forest(seed=seed, n_trees=n_trees).fit(X, y).pack()
    feat, thr = pf.feat.astype(np.int64), pf.thr.astype(np.float64)
    child, mean, var = pf.child.astype(np.int64), pf.mean, pf.var
    roots = pf.roots.astype(np.int64)
    if leaf_tree:
        k = len(feat)
        feat, thr = np.append(feat, 0), np.append(thr, np.inf)
        child, roots = np.append(child, [k, k]), np.append(roots, k)
        mean, var = np.append(mean, 0.25), np.append(var, 0.5)
    return feat, thr, child, mean, var, roots, pf.depth


def _pool(arena, n, d=7, seed=10):
    feat, thr = arena[0], arena[1]
    X = np.random.default_rng(seed).random((n, d))
    branching = np.flatnonzero(np.isfinite(thr))[: max(0, n - 3)]
    X[np.arange(len(branching)) + min(3, n - 1), feat[branching]] = thr[branching]  # x == thr
    X[0, :] = np.nan
    if n > 2:
        X[1, ::2], X[1, 1::2] = np.inf, -np.inf
        X[2, :] = -np.inf
    return X


def _torch_arena(arena):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arena[:6]]


@pytest.mark.parametrize("seed,n,sms", [(0, 1, 132), (1, 64, 132), (2, 257, 4), (3, 300, 1)])
def test_tiled_model_matches_packed_descend(seed, n, sms):
    arena = _forest(seed)
    depth = arena[6]
    X = _pool(arena, n)
    table = ops.pack_nodes(*_torch_arena(arena))
    plan = ops.forest_plan(len(arena[5]), n, 7, table, sms)
    assert plan.route == "tiled"
    nid = RS.packed_descend(*[arena[i] for i in (0, 1, 2, 5)], X, depth)
    for d in (depth, 0, 1):
        m, v = ref.forest_eval_tiled_model(table, torch.from_numpy(X), d, plan)
        pm, pv = ops.forest_eval_plain(*_torch_arena(arena), torch.from_numpy(X), d)
        np.testing.assert_array_equal(m.numpy(), pm.numpy())
        np.testing.assert_array_equal(v.numpy(), pv.numpy())
        if d == 0:   # every lane stays at its root
            np.testing.assert_array_equal(m.numpy()[:, 0], arena[3][arena[5]])
    m, v = ref.forest_eval_tiled_model(table, torch.from_numpy(X), depth, plan)
    np.testing.assert_array_equal(m.numpy(), arena[3][nid])
    np.testing.assert_array_equal(v.numpy(), arena[4][nid])


def test_tiled_model_matches_pallas_interpret():
    arena = _forest(4, n_trees=4, n=40)
    X = _pool(arena, 64)
    with jax.enable_x64(True):
        jm, jv = forest_eval_pallas(*[jax.numpy.asarray(a) for a in arena[:6]], X, arena[6],
                                    block_n=32, interpret=True)
        jm, jv = np.asarray(jm), np.asarray(jv)
    table = ops.pack_nodes(*_torch_arena(arena))
    plan = ops.forest_plan(len(arena[5]), 64, 7, table, 3)
    m, v = ref.forest_eval_tiled_model(table, torch.from_numpy(X), arena[6], plan)
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(v.numpy(), jv)


def test_pack_nodes_records():
    arena = _forest(5)
    feat, thr, child, mean, var, roots, _ = arena
    table = ops.pack_nodes(*_torch_arena(arena))
    R, T = table.n_records, len(roots)
    assert R == len(feat) and table.nodes.shape == (R, 2) and table.trees.shape == (T + 1, 2)
    rthr = table.nodes[:, 0].contiguous().view(torch.float64).numpy()
    rfeat = (table.nodes[:, 1] & 0xFFFFFFFF).numpy()
    left = (table.nodes[:, 1] >> 32).numpy()
    start = table.tree_start
    np.testing.assert_array_equal(table.trees[:, 0].numpy(), start)
    # the record of each original node, by walking both arenas from the roots
    orig = np.full(R, -1)
    orig[start[:-1]] = roots
    for t in range(T):
        for r in range(start[t], start[t + 1]):
            assert orig[r] >= 0
            o = orig[r]
            if child[2 * o] == o and child[2 * o + 1] == o:   # a leaf holds its lane
                assert left[r] == r and rthr[r] == np.inf and rfeat[r] == 0
                continue
            assert start[t] <= left[r] and left[r] + 1 < start[t + 1]   # siblings in the tree
            orig[left[r]], orig[left[r] + 1] = child[2 * o], child[2 * o + 1]
            assert rthr[r] == thr[o] and rfeat[r] == feat[o]
    np.testing.assert_array_equal(table.stats[:, 0].numpy(), mean[orig])
    np.testing.assert_array_equal(table.stats[:, 1].numpy(), var[orig])
    assert int(table.trees[T - 1, 1]) == 0   # the one-leaf tree has no level below its root
    assert table.feat_range == (int(feat[np.isfinite(thr)].min()),
                                int(feat[np.isfinite(thr)].max()))


def test_pack_nodes_refuses_what_is_no_forest():
    feat, thr, child, mean, var, roots, _ = _forest(6, leaf_tree=False)
    shared = np.append(roots, roots[0])          # two trees share one root
    assert ops.pack_nodes(*_torch_arena((feat, thr, child, mean, var, shared))) is None
    loop = child.copy()
    b = int(np.flatnonzero(np.isfinite(thr))[0])
    loop[2 * b + 1] = b                          # a branch back to itself
    assert ops.pack_nodes(*_torch_arena((feat, thr, loop, mean, var, roots))) is None


def test_node_tables_concatenate_as_the_fused_arena():
    arenas = [_forest(s, n_trees=3 + s) for s in range(3)]
    tables = [ops.pack_nodes(*_torch_arena(a)) for a in arenas]
    offs = np.cumsum([0] + [len(a[0]) for a in arenas])
    fused = [np.concatenate([a[i] + (o if i == 5 else 0) for a, o in zip(arenas, offs)])
             for i in range(5)]
    fused[2] = np.concatenate([a[2] + o for a, o in zip(arenas, offs)])
    fused.append(np.concatenate([a[5] + o for a, o in zip(arenas, offs)]))
    whole = ops.pack_nodes(*[torch.from_numpy(a) for a in fused])
    cat = ops.NodeTable.concat(tables)
    assert torch.equal(cat.nodes, whole.nodes) and torch.equal(cat.stats, whole.stats)
    assert torch.equal(cat.trees, whole.trees) and cat.feat_range == whole.feat_range
    np.testing.assert_array_equal(cat.tree_start, whole.tree_start)


def _plan_cover(plan, T, N):
    """How many times each (tree, candidate) the tiled grid writes."""
    cover = np.zeros((T, N), dtype=np.int64)
    for g in range(plan.groups):
        t0, t1 = g * plan.trees, min(T, (g + 1) * plan.trees)
        for tile in range(plan.tiles):
            rows = np.arange(tile * plan.rows, min(N, (tile + 1) * plan.rows))
            for lane in range(plan.lanes):
                for t in range(t0 + lane, t1, plan.lanes):
                    cover[t, rows] += 1
    return cover


def _table(records_per_tree, D=60):
    start = np.concatenate([[0], np.cumsum(records_per_tree)])
    return ops.NodeTable(None, None, None, start, (0, D - 1))


@pytest.mark.parametrize("T,N,per_tree", [(340, 256, 41), (120, 131072, 61), (10, 1, 19),
                                          (34, 255, 99), (1, 4097, 1), (700, 300, 47)])
def test_forest_plan_covers_each_lane_once_within_shared_memory(T, N, per_tree):
    sizes = np.random.default_rng(T + N).integers(1, 2 * per_tree, size=T)
    table = _table(sizes)
    plan = ops.forest_plan(T, N, 60, table)
    assert plan.route == "tiled"
    assert plan.rows in ops.TILE_ROWS and plan.rows * plan.lanes <= plan.threads <= 1024
    assert plan.threads % 32 == 0 and plan.threads >= 256
    # rows at an odd stride, or twice an odd one (16-byte aligned rows)
    assert plan.smem <= ops.SMEM_MAX and plan.xstride % 4 != 0 and plan.xstride >= 60
    x_bytes = -(-plan.rows * plan.xstride // 2) * 16
    for g in range(plan.groups):
        t0, t1 = g * plan.trees, min(T, (g + 1) * plan.trees)
        assert x_bytes + 16 * (table.tree_start[t1] - table.tree_start[t0]) <= plan.smem
    if N <= 4097:
        assert (_plan_cover(plan, T, N) == 1).all()
    if N == 131072:
        assert plan.tiles * plan.groups >= 132


def test_forest_plan_fills_the_card_at_the_tuner_shape():
    plan = ops.forest_plan(340, 256, 60, _table(np.full(340, 41)))
    assert plan.route == "tiled" and plan.tiles * plan.groups >= 132


def test_forest_plan_takes_gather_where_tiled_cannot():
    assert ops.forest_plan(5, 10, 60, None).route == "gather"
    assert ops.forest_plan(5, 10, 8, _table(np.full(5, 9), D=60)).route == "gather"
    huge = _table(np.array([ops.SMEM_MAX // 16]))
    assert ops.forest_plan(1, 10, 60, huge).route == "gather"
    wide = ops.forest_plan(2, 1000, 800, _table(np.full(2, 3), D=800))
    assert (wide.route, wide.rows) == ("tiled", 32)   # only a 32-row tile fits
    assert ops.forest_plan(2, 10, 1000, _table(np.full(2, 3), D=1000)).route == "gather"
    with pytest.raises(ValueError):
        ops.forest_plan(0, 10, 60, None)
