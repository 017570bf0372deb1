"""Q1's ``per_tree`` route on the CPU: its layout, its plan, its walk.

The torch emulation of the route's walk (``qs_leaf_stats_tree_model``,
chunk by chunk over the per-tree records as the kernel stages them) must
equal the reference's ``_qs_leaf_stats`` (called directly under
``jax.enable_x64(True)``, traced by ``jax.jit`` as the reference's step
traces it) and the merged tables' plain version bit for bit:
the int64 views of the float64 means and vars, and the exit leaves (each
plane's leaf means are the leaves' ordinals, so the means name them). The
planes: synthetic arenas with trees of 1-24 leaves (four-byte words) and
33-64 leaves (eight-byte words), root leaves, features no tree splits on,
thresholds drawn from a small grid (so they repeat across trees), pools holding
every threshold value exactly (the ``thr < v`` edge); forests fitted to
noise whose trees have 65-128 leaves; a plane whose records overflow one
block's shared memory (tree chunks) and one whose ring of X tiles does
(the plan takes ``merged``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.forest_eval import propose as RP
from repro_torch.core import ProbabilisticRandomForest
from repro_torch.core.surrogate import ForestPlane
from repro_torch.kernels.forest_eval import propose as PP
from repro_torch.kernels.forest_eval.chain import SMEM_BLOCK

SMS = 132   # an H100's SMs, for the plans


def _arena(rng, n_trees, leaves, feats, grid):
    """A packed arena (feat, thr, child, mean, var, roots) of random binary
    trees with ``leaves`` (lo, hi) leaves each, splitting on ``feats`` at
    thresholds drawn from ``grid[j]``; leaves self-loop with thr = +inf."""
    feat, thr, child, mean, var, roots = [], [], [], [], [], []

    def build(n_leaves):
        n = len(feat)
        feat.append(0)
        thr.append(np.inf)
        child.extend([n, n])
        mean.append(float(rng.normal()))
        var.append(float(rng.random()))
        if n_leaves > 1:
            k = int(rng.integers(1, n_leaves))
            left, right = build(k), build(n_leaves - k)
            j = int(rng.choice(feats))
            feat[n], thr[n] = j, float(rng.choice(grid[j]))
            child[2 * n], child[2 * n + 1] = left, right
        return n

    for _ in range(n_trees):
        roots.append(build(int(rng.integers(leaves[0], leaves[1] + 1))))
    return (np.array(feat, np.int32), np.array(thr), np.array(child, np.int32),
            np.array(mean), np.array(var), np.array(roots, np.int32))


def _pool(rng, n, d, arena):
    """n random unit rows, then one row for each threshold value of each
    feature holding that value exactly in its column."""
    X = rng.random((n, d))
    feat, thr, child = arena[0], arena[1], arena[2]
    internal = np.array([child[2 * i] != i for i in range(len(feat))])
    edge = [(int(j), t) for j, t in zip(feat[internal], thr[internal])]
    extra = rng.random((len(edge), d))
    for row, (j, t) in enumerate(edge):
        extra[row, j] = t
    return np.concatenate([X, extra])


def _fitted(seed0=1, n_sources=2, n_obs=220, d=5):
    """The two-word forests of ``tests/test_torch_propose.py`` (noise
    targets: trees of 65-128 leaves)."""
    rng = np.random.default_rng(seed0)
    forests = []
    for s in range(n_sources):
        X = rng.random((n_obs, d))
        forests.append(ProbabilisticRandomForest(n_trees=10, seed=s, device="cpu").fit(
            X, rng.normal(size=n_obs)))
    p = ForestPlane([f.pack() for f in forests])
    return tuple(t.numpy() for t in (p.feat, p.thr, p.child, p.mean, p.var, p.roots))


def _ordinal_means(arena):
    """``arena`` with each leaf's mean set to its leaf ordinal (trees in
    order, leaves left to right), so that a mean output names the exit
    leaf."""
    feat, thr, child, mean, var, roots = arena
    mean = mean.copy()
    k = 0
    for r in roots:
        stack = [int(r)]
        while stack:
            i = stack.pop()
            if child[2 * i] == i:
                mean[i] = k
                k += 1
            else:
                stack += [int(child[2 * i + 1]), int(child[2 * i])]
    return feat, thr, child, mean, var, roots


@pytest.fixture(scope="module")
def planes():
    """name -> (arena, d, pool): every case's plane, built once, each
    leaf's mean its ordinal."""
    rng = np.random.default_rng(0)
    out = {}
    d = 10
    grid = [np.round(rng.random(5), 2) for _ in range(d)]
    used = [0, 1, 2, 3, 5, 6, 8]       # 4, 7 and 9: no tree splits on them
    a = _ordinal_means(_arena(rng, 40, (1, 24), used, grid))
    out["one_word"] = (a, d, _pool(rng, 300, d, a))
    a = _ordinal_means(_arena(rng, 20, (33, 64), used, grid))
    out["eight_byte"] = (a, d, _pool(rng, 200, d, a))
    a = _ordinal_means(_fitted())
    out["two_word"] = (a, 5, _pool(rng, 300, 5, a))
    a = _ordinal_means(_arena(rng, 12, (1, 1), used, grid))
    out["root_leaf"] = (a, d, rng.random((100, d)))
    a = _ordinal_means(_arena(rng, 150, (33, 64), used, grid))
    out["tiled"] = (a, d, _pool(rng, 100, d, a))
    wide = 300                          # a ring of 64 candidates: 312 KB
    a = _ordinal_means(_arena(rng, 10, (2, 20), used, grid))
    out["merged"] = (a, wide, rng.random((64, wide)))
    return out


_REFERENCE: dict = {}


def _reference(arena, d, X):
    """The reference's ``_qs_leaf_stats`` on its own plan of ``arena``,
    once a process for each plane."""
    key = (id(arena), id(X))
    if key not in _REFERENCE:
        host, reason = RP.build_qs_plan_ex(*arena, d)
        assert host is not None, reason
        thrs, tabs, lm, lv, offs = host
        with jax.enable_x64(True):
            qs = (tuple(jnp.asarray(t) for t in thrs), tuple(jnp.asarray(t) for t in tabs),
                  jnp.asarray(lm), jnp.asarray(lv), jnp.asarray(offs))
            m, v = jax.jit(RP._qs_leaf_stats)(qs, jnp.asarray(X))
            _REFERENCE[key] = (np.array(m), np.array(v))
    return _REFERENCE[key]


def _port(arena, d):
    host, reason = PP.build_qs_plan_ex(*arena, d)
    assert host is not None, reason
    return PP.qs_tables(host, "cpu")


def _bits(t):
    return t.contiguous().view(torch.int64)


@pytest.mark.parametrize("case", ["one_word", "eight_byte", "two_word", "root_leaf", "tiled"])
@pytest.mark.parametrize("n", [256, 131072])
def test_tree_walk_matches_reference(planes, case, n):
    """The emulated walk under the plan for a pool of ``n`` (one chunk or
    many) against the reference and the merged plain version, bit for
    bit, exit leaves included."""
    arena, d, X = planes[case]
    qs = _port(arena, d)
    plan = PP.qs_plan(qs, n, d, SMS)
    assert plan.route == "per_tree"
    Xt = torch.from_numpy(X)
    m, v, leaves = PP.qs_leaf_stats_tree_model(Xt, qs, plan, qs.n_trees + 2, leaves=True)
    assert not m[qs.n_trees:].any() and not v[qs.n_trees:].any()
    want_m, want_v = _reference(arena, d, X)
    plain = PP.qs_leaf_stats_plain(Xt, qs)
    for got, want, p in ((m, want_m, plain[0]), (v, want_v, plain[1])):
        assert torch.equal(_bits(got[:qs.n_trees]), _bits(torch.from_numpy(want)))
        assert torch.equal(_bits(got[:qs.n_trees]), _bits(p))
    assert torch.equal(leaves.to(torch.float64), m[:qs.n_trees])   # the means are ordinals


def test_plane_features(planes):
    """The cases hold what they claim: unused features, repeated
    thresholds, every threshold value in the pool, root-leaf trees, the
    word widths."""
    arena, d, X = planes["one_word"]
    feat, thr, child = arena[0], arena[1], arena[2]
    internal = np.array([child[2 * i] != i for i in range(len(feat))])
    assert not np.isin([4, 7, 9], feat[internal]).any()
    assert len(np.unique(thr[internal])) < internal.sum()
    for j, t in zip(feat[internal], thr[internal]):
        assert (X[:, j] == t).any()
    assert (~internal[arena[5]]).any()       # some roots are leaves
    widths = {c: _port(*planes[c][:2]).trees.word_bytes
              for c in ("one_word", "eight_byte", "two_word")}
    assert widths == {"one_word": 4, "eight_byte": 8, "two_word": 16}


@pytest.mark.parametrize("case", ["one_word", "eight_byte", "two_word", "root_leaf", "tiled"])
def test_record_sizes(planes, case):
    """Pairs, words and each record's bytes as the packer implies them: a
    (tree, feature) pair for each feature a tree splits on, a single where
    it splits once (one word), n + 1 words where n > 1; a record of a
    16-byte header, 16 bytes a single, 8 a pair and a threshold of a pair,
    16 a leaf, then the words from the next 16-byte boundary, padded."""
    arena, d, _ = planes[case]
    feat, _, child, _, _, roots = arena
    qs = _port(arena, d)
    tt = qs.trees
    sizes, n_pairs, n_words = [], 0, 0
    for r in roots:
        stack, splits, leaves = [int(r)], {}, 0
        while stack:
            i = stack.pop()
            if child[2 * i] == i:
                leaves += 1
                continue
            splits[int(feat[i])] = splits.get(int(feat[i]), 0) + 1
            stack += [int(child[2 * i]), int(child[2 * i + 1])]
        S = sum(1 for n in splits.values() if n == 1)
        P, M = len(splits) - S, sum(n for n in splits.values() if n > 1)
        n_pairs += S + P
        n_words += S + M + P
        head = (16 + 16 * S + 8 * (P + M) + 16 * leaves + 15) // 16 * 16
        sizes.append((head + tt.word_bytes * (S + M + P) + 15) // 16 * 16)
    assert (tt.pairs, tt.words) == (n_pairs, n_words)
    assert np.array_equal(tt.sizes, sizes)
    assert np.array_equal(tt.tree_off.numpy(), np.concatenate([[0], np.cumsum(sizes)]))
    assert tt.blob.numel() == sum(sizes) and tt.meta.tolist() == [qs.n_trees, tt.word_bytes]


def test_plans(planes):
    """The plan's shapes: one chunk and 128-candidate tiles where the plane
    fits and the pool fills the SMs; chunks that fill the SMs at 256;
    chunks that fit where the records overflow a block; ``merged`` where
    the ring of X tiles cannot fit."""
    arena, d, _ = planes["one_word"]
    qs = _port(arena, d)
    big = PP.qs_plan(qs, 131072, d, SMS)
    assert (big.route, big.tile, big.trees, big.grid, big.smem) == (
        "per_tree", 128, qs.n_trees, SMS, SMEM_BLOCK)
    small = PP.qs_plan(qs, 256, d, SMS)
    tiles = 256 // small.tile
    units = -(-qs.n_trees // small.trees) * tiles
    assert small.tile == 128 and units <= SMS and small.grid == units
    assert small.trees == 1 or -(-qs.n_trees // (small.trees - 1)) * tiles > SMS

    arena, d, _ = planes["tiled"]
    qs = _port(arena, d)
    room = SMEM_BLOCK - 16 - PP.qs_ring_bytes(128, d)
    assert qs.trees.sizes.sum() > room
    plan = PP.qs_plan(qs, 131072, d, SMS)
    assert plan.route == "per_tree" and 1 < plan.trees < qs.n_trees
    assert PP.qs_chunk_bytes(qs.trees.sizes, plan.trees) <= room
    assert PP.qs_chunk_bytes(qs.trees.sizes, plan.trees + 1) > room
    assert PP.qs_plan_fits(plan, qs, d)
    assert not PP.qs_plan_fits(plan._replace(trees=qs.n_trees), qs, d)

    arena, d, X = planes["merged"]
    qs = _port(arena, d)
    plan = PP.qs_plan(qs, 131072, d, SMS)
    assert plan.route == "merged" and "shared memory" in plan.reason
    want = _reference(arena, d, X)
    got = PP.qs_leaf_stats(torch.from_numpy(X), qs)
    for g, w in zip(got, want):
        assert torch.equal(_bits(g), _bits(torch.from_numpy(w)))
    # a plan too small for one record sends the plane to merged as well
    tight = PP.qs_plan(_port(*planes["one_word"][:2]), 131072, 10, SMS, smem_block=4096)
    assert tight.route == "merged"
