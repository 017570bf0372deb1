"""The tuner's reference paths in the port against the JAX package, on the
CPU: the forest backends (the recursive tree builder and per-tree ``loop``
prediction, the host gather descent ``packed_descend``), the chain-delta
pool scoring (``PoolPlan``, ``ForestPlane.predict(..., delta=...)``, the
generator's mutation provenance), the space backends (``scalar``, the log
geometry switch), the ``loop`` Hyperband bracket runner, and Shapley's
``loop`` backend with ``shapley_values`` and ``shapley_values_exact``.

Each is held to the reference on the same inputs with exact equality, in
the idiom of the reference's own tests (``tests/test_tree_frontier.py``,
``test_surrogate_packed.py``, ``test_pool_delta.py``,
``test_space_plane.py``, ``test_core_space.py``, ``test_rung_table.py``,
``test_shapley_batched.py``); these paths are host numpy in both packages.
The default device route (kernel K1, here its plain version) is held to the
host routes bit for bit too.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

import repro.core as R
import repro.sparksim as RS
import repro_torch.core as P
import repro_torch.obs as Pobs
import repro_torch.sparksim as PS
from repro.core import hyperband as Rhb
from repro.core import surrogate as Rsur
from repro.core.generator import CandidateGenerator as RGen
from repro.core.generator import SurrogateSource as RSource
from repro.tuneapi import Budget as RBudget
from repro_torch.core import compression as Pcomp
from repro_torch.core import generator as Pgen
from repro_torch.core import surrogate as Psur
from repro_torch.kernels import counts
from repro_torch.tuneapi import Budget as PBudget

CPU = "cpu"


def _np(t) -> np.ndarray:
    return t.cpu().numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _data(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d))
    y = np.sin(4 * X[:, 0]) + X[:, 1 % d] + 0.1 * rng.standard_normal(n)
    return X, y


def _dfs(tree):
    """A tree's nodes in depth-first order (the builders number them
    otherwise): (feature, threshold, mean, var, n)."""
    out = []

    def rec(i):
        nd = tree.nodes[i]
        out.append((nd.feature, nd.threshold, nd.mean, nd.var, nd.n))
        if nd.feature >= 0:
            rec(nd.left)
            rec(nd.right)

    rec(0)
    return out


# ------------------------------------------------------------ forest backends


@pytest.mark.parametrize("seed", [0, 1, 2, 3, 11])
def test_recursive_builder_matches_frontier_and_reference(seed):
    """The recursive builder's tree equals the frontier builder's and the
    reference's recursive tree, node for node, and predicts the same."""
    X, y = _data(60, 5, seed)
    if seed % 2:
        X[:, 0] = np.round(X[:, 0] * 5) / 5       # tied feature values
    kw = dict(max_depth=8, min_samples_split=4, min_samples_leaf=1 + seed % 2)
    rec = Psur.RegressionTree(rng=np.random.default_rng(seed), builder="recursive", **kw).fit(X, y)
    fro = Psur.RegressionTree(rng=np.random.default_rng(seed), **kw).fit(X, y)
    ref = Rsur.RegressionTree(rng=np.random.default_rng(seed), builder="recursive", **kw).fit(X, y)
    assert _dfs(rec) == _dfs(fro) == _dfs(ref)
    Xq = np.random.default_rng(seed + 1).random((32, 5))
    for a, b, c in zip(rec.predict(Xq), fro.predict(Xq), ref.predict(Xq)):
        assert np.array_equal(a, b) and np.array_equal(a, c)


def test_degenerate_inputs_stay_leaves_and_unknown_builder_rejected():
    for builder in ("recursive", "frontier"):
        t = Psur.RegressionTree(rng=np.random.default_rng(0), builder=builder).fit(
            np.random.default_rng(0).random((10, 3)), np.full(10, 2.0))
        assert len(t.nodes) == 1 and t.nodes[0].mean == 2.0
        t = Psur.RegressionTree(max_depth=0, rng=np.random.default_rng(0),
                                builder=builder).fit(*_data(20, 3, 1))
        assert len(t.nodes) == 1
    with pytest.raises(ValueError, match="unknown tree builder"):
        Psur.RegressionTree(builder="iterative")


@pytest.mark.parametrize("n,d,seed", [(16, 3, 0), (48, 8, 1), (120, 16, 2), (5, 2, 3)])
def test_forest_backends_predict_identically_and_as_the_reference(n, d, seed):
    """``loop`` (recursive trees, per-tree prediction), ``numpy`` (the host
    gather descent) and ``device`` (K1's plain version here) give the same
    (mean, var) bit for bit, and the reference's ``loop`` and ``numpy``."""
    X, y = _data(n, d, seed)
    Xq = np.random.default_rng(seed + 100).random((37, d))
    outs = {b: P.make_forest(seed=seed, device=CPU, backend=b).fit(X, y).predict(Xq)
            for b in P.surrogate.FOREST_BACKENDS}
    refs = {b: R.make_forest(seed=seed, backend=b).fit(X, y).predict(Xq)
            for b in ("loop", "numpy")}
    for got in list(outs.values()) + [refs["numpy"]]:
        for a, b in zip(got, refs["loop"]):
            assert np.array_equal(a, b)


def test_packed_descend_matches_reference():
    X, y = _data(80, 6, 4)
    Xq = np.random.default_rng(5).random((50, 6))
    pf = R.make_forest(seed=4, backend="numpy").fit(X, y).pack()
    want = Rsur.packed_descend(pf.feat, pf.thr, pf.child, pf.roots, Xq, pf.depth)
    got = P.packed_descend(pf.feat, pf.thr, pf.child, pf.roots, Xq, pf.depth)
    assert np.array_equal(got, want)


def test_forest_backend_switch_and_context():
    assert P.get_forest_backend() == "device"
    with P.forest_backend("loop"):
        assert P.make_forest(device=CPU).backend == "loop"
        with P.forest_backend("numpy"):
            assert P.get_forest_backend() == "numpy"
        assert P.get_forest_backend() == "loop"
    assert P.make_forest(device=CPU).backend == "device"
    with pytest.raises(ValueError, match="unknown forest backend"):
        P.set_forest_backend("jax")
    with pytest.raises(ValueError, match="unknown forest backend"):
        P.make_forest(device=CPU).fit(*_data(20, 3, 0)).pack().predict(np.zeros((1, 3)), "loop")
    empty = P.make_forest(device=CPU, backend="loop")
    m, v = empty.predict(np.zeros((3, 2)))
    assert np.array_equal(m, np.zeros(3)) and np.array_equal(v, np.ones(3))


def _planes(d=6, seed=11, n_trees=4, depth=5):
    """The same three forests as a port and a reference plane."""
    rng = np.random.default_rng(seed)
    Xf = rng.random((80, d))
    ys = [rng.random(80) for _ in range(3)]
    pm = [P.make_forest(seed=s, device=CPU, n_trees=n_trees, max_depth=depth).fit(Xf, y)
          for s, y in enumerate(ys)]
    rm = [R.make_forest(seed=s, n_trees=n_trees, max_depth=depth, backend="numpy").fit(Xf, y)
          for s, y in enumerate(ys)]
    return (P.ForestPlane([m.pack() for m in pm]), R.ForestPlane([m.pack() for m in rm]),
            rng)


def test_plane_host_route_matches_device_route_and_reference():
    pplane, rplane, rng = _planes()
    X = rng.random((40, 6))
    dev = pplane.predict(X)
    host = pplane.predict(X, "numpy")
    want = rplane.predict(X, backend="numpy")
    for a, b, c in zip(dev, host, want):
        assert np.array_equal(_np(a), _np(b)) and np.array_equal(_np(a), c)


# ------------------------------------------------------ chain-delta scoring


def _mutation_pool(rng, d: int, n_free: int = 10, n_mut: int = 30, n_bases: int = 4):
    bases = rng.random((n_bases, d))
    N = n_free + n_mut
    base_of = np.concatenate([np.full(n_free, -1), rng.integers(0, n_bases, n_mut)])
    X = np.empty((N, d))
    for i in range(N):
        if base_of[i] < 0:
            X[i] = rng.random(d)
        else:
            X[i] = bases[base_of[i]]
            nm = rng.integers(1, d)
            cols = rng.choice(d, size=nm, replace=False)
            X[i, cols] = rng.random(nm)
    return X, bases, base_of


def test_delta_predict_bit_identical():
    pplane, rplane, rng = _planes()
    X, bases, base_of = _mutation_pool(rng, d=6)
    m0, v0 = pplane.predict(X, "numpy")
    m1, v1 = pplane.predict(X, "numpy", delta=(bases, base_of))
    rm, rv = rplane.predict(X, backend="numpy", delta=(bases, base_of))
    for a, b, c in ((m0, m1, rm), (v0, v1, rv)):
        assert np.array_equal(_np(a), _np(b)) and np.array_equal(_np(a), c)


def test_pool_plan_leaf_stats_match_reference():
    from repro.kernels.forest_eval.chain import build_pool_plan_ex as r_build
    from repro_torch.kernels.forest_eval.chain import build_pool_plan_ex as p_build

    pplane, rplane, rng = _planes(seed=14, depth=7)
    X, bases, base_of = _mutation_pool(rng, d=6, n_mut=60)
    pplan, preason = p_build(pplane, 6)
    rplan, rreason = r_build(rplane, 6)
    assert preason == rreason == ""
    assert p_build(pplane, 6)[0] is pplan           # cached on the arena
    for a, b in zip(pplan.leaf_stats(X, bases, base_of), rplan.leaf_stats(X, bases, base_of)):
        assert np.array_equal(a, b)
    assert p_build(pplane, 65) == (None, "d=65 > 64 prefix-mask bits")
    assert p_build(object(), 6) == (None, "not a packed arena")


def test_delta_predict_degenerate_pools():
    pplane, _, rng = _planes(seed=12)
    X, bases, base_of = _mutation_pool(rng, d=6)
    N = len(X)
    m0, v0 = pplane.predict(X, "numpy")
    # all-free: every row scored through the plain chain walk
    m2, v2 = pplane.predict(X, "numpy", delta=(bases, np.full(N, -1)))
    assert torch.equal(m0, m2) and torch.equal(v0, v2)
    # all-based on one base, every coordinate mutated: pure re-AND path
    Xall = rng.random((N, X.shape[1]))
    ma, va = pplane.predict(Xall, "numpy")
    mb, vb = pplane.predict(Xall, "numpy", delta=(bases, np.zeros(N, dtype=np.int64)))
    assert torch.equal(ma, mb) and torch.equal(va, vb)


def test_delta_dispatch_counter_and_device_route_ignores_delta():
    pplane, _, rng = _planes(seed=13)
    X, bases, base_of = _mutation_pool(rng, d=6)
    with Pobs.tracing() as tr:
        pplane.predict(X, "numpy", delta=(bases, base_of))
        pplane.predict(X, "numpy")
        dev = pplane.predict(X, delta=(bases, base_of))
    view = tr.metrics.counters_view("forest_plane/")
    assert view.get("chain_delta", 0) == 1 and view.get("numpy", 0) == 1
    assert view.get("device", 0) == 1
    plain = pplane.predict(X)
    assert torch.equal(dev[0], plain[0]) and torch.equal(dev[1], plain[1])


def _spaces(d: int = 5):
    out = []
    for core in (P, R):
        knobs = [core.FloatKnob(f"f{i}", 0.0, 1.0) for i in range(d - 1)]
        knobs.append(core.IntKnob("i0", 1, 32))
        out.append(core.ConfigSpace(knobs))
    return out


def test_candidate_pool_sets_delta_provenance():
    pspace, rspace = _spaces()
    gen = P.CandidateGenerator(pspace, seed=7, pool_size=64, device=CPU)
    rgen = RGen(rspace, seed=7, pool_size=64)
    incs = [pspace.sample(np.random.default_rng(3), 1)[0] for _ in range(3)]
    pool, rpool = gen._candidate_pool(incs), rgen._candidate_pool(incs)
    bases, base_of = pool.delta
    assert np.array_equal(bases, rpool.delta[0]) and np.array_equal(base_of, rpool.delta[1])
    assert np.array_equal(pool.unit(), rpool.unit())
    n_mut = int((base_of >= 0).sum())
    assert n_mut > 0 and np.all(base_of[: len(pool) - n_mut] == -1)
    # take() remaps the provenance; a pool with no incumbents carries none
    sub = pool.take(np.arange(len(pool))[::-1])
    assert np.array_equal(sub.delta[1], base_of[::-1])
    assert gen._candidate_pool([]).delta is None
    with pytest.raises(ValueError, match="base_of has shape"):
        pool.set_delta(bases, base_of[:-1])


def test_recommend_unchanged_by_delta_path(monkeypatch):
    """Host-route sources score the pool through the chain-delta plan; the
    recommendation equals the one without it and the reference's."""
    pspace, rspace = _spaces()
    rng = np.random.default_rng(2)
    X = pspace.sample(rng, 30).unit()
    y = [rng.random(30) for _ in range(2)]
    pm = [P.make_forest(seed=s, device=CPU, backend="numpy", n_trees=3, max_depth=4).fit(X, y[s])
          for s in range(2)]
    rm = [R.make_forest(seed=s, backend="numpy", n_trees=3, max_depth=4).fit(X, y[s])
          for s in range(2)]
    psrc = [Pgen.SurrogateSource(name=f"s{i}", model=m, weight=0.5, incumbent=0.4)
            for i, m in enumerate(pm)]
    rsrc = [RSource(name=f"s{i}", model=m, weight=0.5, incumbent=0.4) for i, m in enumerate(rm)]
    incs = [pspace.sample(np.random.default_rng(9), 1)[0] for _ in range(3)]

    with Pobs.tracing() as tr:
        got_delta = P.CandidateGenerator(pspace, seed=5, pool_size=64, device=CPU).recommend(
            4, psrc, incumbents=incs)
    assert tr.metrics.counters_view("forest_plane/").get("chain_delta", 0) == 1
    want = RGen(rspace, seed=5, pool_size=64).recommend(4, rsrc, incumbents=incs)
    orig = Pgen.score_sources
    monkeypatch.setattr(Pgen, "score_sources",
                        lambda models, X, incs, delta=None: orig(models, X, incs, delta=None))
    got_plain = P.CandidateGenerator(pspace, seed=5, pool_size=64, device=CPU).recommend(
        4, psrc, incumbents=incs)
    assert got_delta == got_plain == want


# ------------------------------------------------------------ space backends


def _mixed(core, restricted: bool):
    s = core.ConfigSpace([
        core.FloatKnob("f", 0.5, 4.0),
        core.FloatKnob("flog", 1.0, 1024.0, log=True),
        core.IntKnob("i", 2, 64, log=True, default=8),
        core.IntKnob("iplain", 0, 100),
        core.CatKnob("c", ("a", "b", "z"), default="b"),
        core.BoolKnob("b", default=True),
    ])
    if restricted:
        s = s.restrict(
            ranges={"f": core.Intervals([(1.0, 1.5), (3.0, 3.5)]),
                    "flog": core.Intervals([(2.0, 8.0), (100.0, 700.0)]),
                    "i": core.Intervals([(4.0, 4.0), (16.0, 32.0)])},
            cat_subsets={"c": ["a", "z"], "b": [True]},
        )
    return s


def _space_outputs(core, backend: str, restricted: bool, geometry, seed: int):
    with core.log_sampling(geometry), core.space_backend(backend):
        s = _mixed(core, restricted)
        rng = np.random.default_rng(seed)
        pool = s.sample(rng, 48)
        lhs = s.lhs_sample(rng, 24)
        muts = s.mutate_many(pool, rng)
        proj = s.project_many(muts)
        dec = s.decode_many(rng.random((16, s.dim)))
        return [pool.values, pool.unit(), lhs.values, muts.values, proj.values, dec.values]


@pytest.mark.parametrize("restricted", [False, True])
@pytest.mark.parametrize("geometry", [False, True, None])
@pytest.mark.parametrize("seed", [0, 7, 99991])
def test_space_backends_identical_and_equal_to_reference(restricted, geometry, seed):
    """Both backends give the same pools from the same pre-drawn matrices
    under a pinned geometry, and each backend (its own default geometry
    under None) the reference's."""
    got = {b: _space_outputs(P, b, restricted, geometry, seed) for b in ("columnar", "scalar")}
    for b in ("columnar", "scalar"):
        want = _space_outputs(R, b, restricted, geometry, seed)
        for a, c in zip(got[b], want):
            assert np.array_equal(a, c), b
    if geometry is not None:
        for a, c in zip(got["columnar"], got["scalar"]):
            assert np.array_equal(a, c)


def test_space_backend_switches():
    assert P.get_space_backend() == "columnar"
    with P.space_backend("scalar"):
        assert P.get_space_backend() == "scalar"
    assert P.get_space_backend() == "columnar"
    with pytest.raises(ValueError, match="unknown space backend"):
        P.set_space_backend("vectorized")
    # the log-geometry gate: log knobs sample in log space on the columnar
    # default, in raw units on the scalar reference, unless pinned
    s = P.ConfigSpace([P.FloatKnob("flog", 1.0, 1024.0, log=True)])
    med = {}
    for b in ("columnar", "scalar"):
        with P.space_backend(b):
            med[b] = float(np.median(s.sample(np.random.default_rng(0), 2000).values))
    assert med["columnar"] < 100 < med["scalar"]
    P.set_log_sampling(True)
    try:
        with P.space_backend("scalar"):
            assert float(np.median(s.sample(np.random.default_rng(0), 2000).values)) < 100
    finally:
        P.set_log_sampling(None)


# ----------------------------------------------------------------- hyperband


def _drive(core_hb, backend, scores, fail_ids=(), batch_mode=False, R_=9, eta=3):
    hb = core_hb.HyperbandRunner(R=R_, eta=eta, seed=0, backend=backend)
    log, hooks = [], []

    def one(cfg):
        i = cfg["id"]
        return float(scores[i]), i in fail_ids, 1.0 + 0.1 * i

    def evaluate(cfg, delta, cap):
        log.append(("eval", cfg["id"], round(delta, 6), cap))
        return one(cfg)

    def evaluate_batch(cfgs, delta, cap):
        log.append(("batch", tuple(c["id"] for c in cfgs), round(delta, 6), cap))
        return [one(c) for c in cfgs]

    out = hb.run_bracket(
        hb.brackets[0], lambda n, rungs: [{"id": i} for i in range(n)], evaluate,
        lambda cfg, d, p, f, e: hooks.append((cfg["id"], round(d, 6), p, f, e)),
        lambda: False, evaluate_batch=evaluate_batch if batch_mode else None,
    )
    return hb, [(o.config["id"], o.performance, o.failed, o.elapsed) for o in out], log, hooks


@pytest.mark.parametrize("batch_mode", [False, True])
@pytest.mark.parametrize("case", ["plain", "ties", "failures", "all_failed"])
def test_hyperband_loop_matches_table_and_reference(batch_mode, case):
    """Promotions, outcomes, evaluation order, cost caps and cost history:
    the port's ``loop`` and ``table`` runners and the reference's ``loop``."""
    scores = np.random.default_rng(5).random(16)
    fail_ids = ()
    if case == "ties":
        scores = np.array([0.5, 0.2, 0.5, 0.2, 0.9, 0.2, 0.5, 0.1, 0.2] + [0.5] * 7)
    elif case == "failures":
        fail_ids, scores = (0, 1, 2, 5), np.arange(16, dtype=float)
    elif case == "all_failed":
        fail_ids = tuple(range(16))
    loop = _drive(P.hyperband, "loop", scores, fail_ids, batch_mode)
    table = _drive(P.hyperband, "table", scores, fail_ids, batch_mode)
    ref = _drive(Rhb, "loop", scores, fail_ids, batch_mode)
    for i in (1, 2, 3):
        assert loop[i] == table[i] == ref[i]
    assert loop[0]._cost_history == ref[0]._cost_history
    for key, vals in loop[0]._cost_history.items():
        assert np.array_equal(np.asarray(vals), table[0]._cost_history.values(key))


def test_hyperband_backend_default_and_context():
    assert P.HyperbandRunner().backend == P.get_hyperband_backend() == "table"
    with P.hyperband_backend("loop"):
        assert P.HyperbandRunner().backend == "loop"
    assert P.HyperbandRunner().backend == "table"
    with pytest.raises(ValueError, match="unknown hyperband backend"):
        P.set_hyperband_backend("bogus")


# ------------------------------------------------------------------- Shapley


def _poly(d, seed=0):
    w = np.random.default_rng(seed).normal(size=d)
    return lambda Z: (Z * w).sum(axis=1) + 2.0 * Z[:, 0] * Z[:, 1 % d]


@pytest.mark.parametrize("d,n_perm,nb", [(3, 4, 1), (6, 8, 12), (6, 1, 5), (9, 3, 16),
                                         (16, 32, 16)])
def test_shapley_loop_matches_batched_and_reference(d, n_perm, nb):
    rng = np.random.default_rng(d + n_perm)
    x, bg = rng.random(d), rng.random((nb, d))
    X, y = _data(48, d, 2)
    model = P.make_forest(seed=2, device=CPU).fit(X, y)
    rmodel = R.make_forest(seed=2).fit(X, y)
    for f, rf, m in ((_poly(d, 1), _poly(d, 1), None),
                     (model.predict_mean, rmodel.predict_mean, model)):
        got = [P.shapley_values(f, x, bg, n_permutations=n_perm, rng=np.random.default_rng(7),
                                backend=b, model=m) for b in ("loop", "batched")]
        want = R.shapley_values(rf, x, bg, n_permutations=n_perm,
                                rng=np.random.default_rng(7), backend="loop")
        assert np.array_equal(got[0], got[1]) and np.array_equal(got[0], want)
    Xs = rng.random((3, d))
    a = P.shapley_values_batch(_poly(d, 1), Xs, bg, n_permutations=n_perm,
                               rng=np.random.default_rng(11), backend="loop")
    b = R.shapley_values_batch(_poly(d, 1), Xs, bg, n_permutations=n_perm,
                               rng=np.random.default_rng(11), backend="loop")
    assert np.array_equal(a, b)


def test_shapley_exact_matches_reference_and_bounds_the_sampler():
    rng = np.random.default_rng(0)
    w = np.array([2.0, -1.0, 0.5, 0.0])
    f = lambda Z: Z @ w + 3 * Z[:, 0] * Z[:, 1]
    x, bg = rng.random(4), rng.random((12, 4))
    exact = P.shapley_values_exact(f, x, bg)
    assert np.array_equal(exact, R.shapley_values_exact(f, x, bg))
    mc = P.shapley_values(f, x, bg, n_permutations=64, rng=np.random.default_rng(1))
    assert np.abs(exact - mc).max() < 0.05
    assert abs(mc.sum() - (f(x[None])[0] - f(bg).mean())) < 1e-9
    with pytest.raises(ValueError, match="unknown shapley backend"):
        P.shapley_values(lambda Z: Z.sum(1), np.zeros(3), np.zeros((2, 3)), backend="vmap")


def test_extract_regions_identical_across_shapley_backends():
    space = P.ConfigSpace([P.FloatKnob(f"x{i}", 0.0, 1.0) for i in range(5)])
    f = lambda c: (c["x0"] - 0.2) ** 2 + (c["x1"] - 0.7) ** 2 + 1.0
    rec = P.TaskRecord(task_id="s0", queries=["q1"])
    for cfg in space.sample(np.random.default_rng(0), 40):
        rec.observations.append(P.Observation(config=cfg, performance=f(cfg), fidelity=1.0))
    regions = [Pcomp.extract_promising_regions(space, rec, 1.0, seed=3, device=CPU, backend=b)
               for b in ("loop", "batched")]
    assert regions[0] is not None
    assert regions[0].importance == regions[1].importance
    assert regions[0].values == regions[1].values


# ------------------------------------------------------------------ the API


def test_core_exports_every_reference_name_but_the_jax_ones():
    missing = set(R.__all__) - set(P.__all__)
    assert missing == {"aggregate_ranks_jax", "expected_improvement_jax"}
    assert all(hasattr(P, n) for n in P.__all__)


def test_rank_aggregate_matches_reference():
    rows = [np.random.default_rng(s).random(40) for s in range(3)]
    rows[1][:10] = rows[0][:10]                       # ties across rows
    w = [0.5, 0.3, 0.2]
    got = P.rank_aggregate(rows, w)
    assert np.array_equal(_np(got), R.rank_aggregate(rows, w))
    assert torch.equal(got, P.aggregate_ranks(np.asarray(rows), w))
    with pytest.raises(ValueError, match="no scores"):
        P.rank_aggregate([], w)


# ------------------------------------------------------- the tuner end to end


def _stream(core, sim, Budget, **kw):
    kb = core.KnowledgeBase()
    kb.add_task(sim.generate_history(sim.TaskSpec("tpch", 600, "B").workload(), n_obs=20,
                                     seed=0, **kw.pop("hist", {})), persist=False)
    dev = kw.pop("dev", {})
    wl = sim.SparkWorkload("tpch", 100, "A")
    with core.log_sampling(True):
        res = core.MFTune(wl, kb, core.MFTuneOptions(seed=0, **kw), **dev).run(Budget(6 * 3600.0))
    obs = kb.get(wl.task_id).observations
    return ([(o.performance, o.fidelity, o.failed, tuple(sorted(o.config.items())))
             for o in obs], [(p.time, p.best) for p in res.trajectory])


def test_mftune_stream_identical_across_reference_backends():
    """The port's run on its host reference paths (per-tree forests, scalar
    space, per-chain Shapley, scalar brackets) and on the host route with
    chain-delta scoring repeats its default run, and the reference's run with
    the same host paths; one log geometry is pinned so the space backends
    compare."""
    cpu = dict(hist={"device": CPU}, dev={"device": CPU})
    loops = dict(surrogate_backend="loop", space_backend="scalar", shapley_backend="loop",
                 hyperband_backend="loop")
    default = _stream(P, PS, PBudget, **cpu)
    counts.reset()
    with Pobs.tracing() as tr:
        host = _stream(P, PS, PBudget, surrogate_backend="numpy", **cpu)
    assert tr.metrics.counters_view("forest_plane/").get("chain_delta", 0) > 0
    looped = _stream(P, PS, PBudget, **loops, **cpu)
    want = _stream(R, RS, RBudget, **loops)
    assert default == host == looped == want
    assert len(default[0]) > 20
