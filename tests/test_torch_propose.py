"""The fused propose step of the port against the JAX package's.

The port's host-pool ``propose_step`` (descents ``forest``, K1's plain
version, and ``qs``, Q1's) must return the reference's ``propose_step``
(``descent="jax"`` and ``"qs"``, called directly under
``jax.enable_x64(True)`` with ``rank_impl="sort"``) bit for bit: ``idx``,
``X[idx]`` and ``agg[idx]``, at pool sizes around the buckets, on one-word
and two-word forests, with tied rows and a source of zero variance; and
both must give the staged numpy path's top n. Q1's and Q2's plain versions
are held to the reference's ``_qs_leaf_stats`` and combine + EI, the
device pool's columns to ``_unit_col``, and a fused ``MFTune`` run on the
CPU to the staged runs of both packages.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import repro.core as R
import repro.obs as Robs
import repro.sparksim as RS
import repro_torch.core as PC
import repro_torch.obs as Pobs
import repro_torch.sparksim as PS
from repro.core.surrogate import ForestPlane as RPlane
from repro.kernels.forest_eval import propose as RP
from repro.tuneapi import Budget as RBudget
from repro_torch.core import propose as PE
from repro_torch.core.surrogate import ForestPlane as PPlane
from repro_torch.kernels import counts
from repro_torch.kernels.forest_eval import propose as PP
from repro_torch.tuneapi import Budget as PBudget


def _space(core):
    return core.ConfigSpace([
        core.FloatKnob("f1", 0.1, 10.0, log=True),
        core.FloatKnob("f2", -5.0, 5.0),
        core.IntKnob("i1", 1, 64, log=True),
        core.IntKnob("i2", 0, 9),
        core.CatKnob("c1", ["a", "b", "c"]),
        core.BoolKnob("b1"),
    ])


def _models(n_sources=3, n_obs=40, seed0=0, d=6, noise=False, flat=False):
    """Reference and port PRFs fitted on the same data (the fixture of
    ``tests/test_propose_fused.py``); ``flat`` adds a source fitted on a
    constant target (root-leaf trees, zero variance)."""
    rng = np.random.default_rng(seed0)
    ref, port = [], []
    for s in range(n_sources + flat):
        X = rng.random((n_obs, d))
        y = rng.normal(size=n_obs) if noise else rng.random(n_obs) * 10 + s
        if s == n_sources:
            y = np.full(n_obs, 3.0)
        ref.append(R.ProbabilisticRandomForest(n_trees=10, seed=s).fit(X, y))
        port.append(PC.ProbabilisticRandomForest(n_trees=10, seed=s, device="cpu").fit(X, y))
    return ref, port


def _pool(n, d, seed):
    """A unit pool with tied rows (every 7th row repeats row 0)."""
    X = np.random.default_rng(seed).random((n, d))
    X[::7] = X[0]
    return X


def _ref_step(rmodels, X, incs, ws, k, descent, d):
    """The reference's ``propose_step`` in host-pool mode."""
    plane = RPlane([m.pack() for m in rmodels])
    N = X.shape[0]
    bucket = RP.pool_bucket(N)
    Xp = np.zeros((bucket, X.shape[1]))
    Xp[:N] = X
    with jax.enable_x64(True):
        arena = tuple(jnp.asarray(a) for a in (plane.feat, plane.thr, plane.child, plane.mean,
                                               plane.var, plane.roots))
        ystats = (jnp.asarray(plane.y_means), jnp.asarray(plane.y_stds),
                  jnp.asarray(np.array([f.y_std ** 2 for f in plane.forests])))
        qs = None
        if descent == "qs":
            host, reason = RP.build_qs_plan_ex(plane.feat, plane.thr, plane.child, plane.mean,
                                               plane.var, plane.roots, d)
            assert host is not None, reason
            thrs, tabs, lm, lv, offs = host
            qs = (tuple(jnp.asarray(a) for a in thrs), tuple(jnp.asarray(a) for a in tabs),
                  jnp.asarray(lm), jnp.asarray(lv), jnp.asarray(offs))
        out = RP.propose_step(
            None, None, arena, ystats, jnp.asarray(np.asarray(incs, float)),
            jnp.asarray(np.asarray(ws, float)), jnp.zeros((), dtype=jnp.uint64),
            n_pool=bucket, depth=plane.depth, n_sources=len(rmodels),
            tps=plane.uniform_tree_count, k=k, sig=(), descent=descent, rank_impl="sort",
            X=jnp.asarray(Xp), n_valid=N, qs=qs)
        return tuple(np.asarray(o) for o in out)


def _port_entry(pmodels, d):
    return PE._PlaneEntry(PPlane([m.pack() for m in pmodels]), d)


def _port_step(pmodels, X, incs, ws, k, descent, d):
    entry = _port_entry(pmodels, d)
    N = X.shape[0]
    bucket = PP.pool_bucket(N)
    Xp = torch.zeros((bucket, X.shape[1]), dtype=torch.float64)
    Xp[:N] = torch.from_numpy(X)
    out = PP.propose_step(
        None, None, entry.arena, entry.ystats, torch.tensor(incs, dtype=torch.float64),
        torch.tensor(ws, dtype=torch.float64), n_pool=bucket, n_sources=entry.S,
        tps=entry.tps, k=k, descent=descent, X=Xp, n_valid=N,
        qs=entry.qs()[0] if descent == "qs" else None)
    return tuple(o.numpy() for o in out)


def _bits(a):
    return np.ascontiguousarray(a).view(np.uint64 if a.dtype == np.float64 else a.dtype)


def _staged_topk(rmodels, X, incs, ws, n):
    scores = R.score_sources(rmodels, X, incs)
    return np.argsort(R.aggregate_ranks(scores, np.asarray(ws)), kind="stable")[:n]


INCS4, WS4 = [5.0, 4.0, 6.0, 3.0], [0.5, 0.3, 0.2, 0.1]


@pytest.fixture(scope="module")
def one_word():
    return _models(flat=True)


@pytest.fixture(scope="module")
def two_word():
    ref, port = _models(n_sources=2, n_obs=220, seed0=1, d=5, noise=True)
    return ref, port


@pytest.mark.parametrize("descent", ["forest", "qs"])
@pytest.mark.parametrize("n", [1, 255, 256, 257, 4097])
def test_propose_step_matches_reference(one_word, descent, n):
    ref, port = one_word
    X = _pool(n, 6, n)
    k = min(32, PP.pool_bucket(n))
    want = _ref_step(ref, X, INCS4, WS4, k, "jax" if descent == "forest" else "qs", 6)
    got = _port_step(port, X, INCS4, WS4, k, descent, 6)
    assert np.array_equal(got[0], want[0].astype(np.int64))
    assert np.array_equal(_bits(got[1]), _bits(want[1]))
    assert np.array_equal(_bits(got[2]), _bits(want[2]))
    m = min(5, n)
    assert np.array_equal(got[0][:m], _staged_topk(ref, X, INCS4, WS4, m))


@pytest.mark.parametrize("descent", ["forest", "qs"])
def test_propose_step_two_word_forest(two_word, descent):
    ref, port = two_word
    assert _port_entry(port, 5).qs()[0].n_words == 2
    X = _pool(777, 5, 3)
    want = _ref_step(ref, X, [0.1, -0.2], [0.6, 0.4], 64, "jax" if descent == "forest" else "qs",
                     5)
    got = _port_step(port, X, [0.1, -0.2], [0.6, 0.4], 64, descent, 5)
    assert np.array_equal(got[0], want[0].astype(np.int64))
    assert np.array_equal(_bits(got[1]), _bits(want[1]))
    assert np.array_equal(_bits(got[2]), _bits(want[2]))
    assert np.array_equal(got[0][:8], _staged_topk(ref, X, [0.1, -0.2], [0.6, 0.4], 8))


def _ref_qs_stats(rmodels, X, d):
    plane = RPlane([m.pack() for m in rmodels])
    host, reason = RP.build_qs_plan_ex(plane.feat, plane.thr, plane.child, plane.mean,
                                       plane.var, plane.roots, d)
    assert host is not None, reason
    thrs, tabs, lm, lv, offs = host
    with jax.enable_x64(True):
        qs = (tuple(jnp.asarray(a) for a in thrs), tuple(jnp.asarray(a) for a in tabs),
              jnp.asarray(lm), jnp.asarray(lv), jnp.asarray(offs))
        m, v = RP._qs_leaf_stats(qs, jnp.asarray(X))
        return np.array(m), np.array(v)


@pytest.mark.parametrize("case", ["one_word", "two_word", "root_leaf"])
def test_qs_leaf_stats_matches_reference(case, one_word, two_word):
    if case == "one_word":
        (ref, port), d = one_word, 6
    elif case == "two_word":
        (ref, port), d = two_word, 5
    else:   # every tree a root leaf: constant targets
        (ref, port), d = _models(n_sources=0, flat=True), 6
    X = _pool(300, d, 11)
    want = _ref_qs_stats(ref, X, d)
    qs = _port_entry(port, d).qs()[0]
    counts.reset()
    got = PP.qs_leaf_stats(torch.from_numpy(X), qs, qs.n_trees + 3)
    assert counts.PLAIN_CALLS["qs_descent"] == 1
    for g, w in zip(got, want):
        assert np.array_equal(_bits(g[:qs.n_trees].numpy()), _bits(w))
        assert not g[qs.n_trees:].any()
    if case == "root_leaf":
        assert qs.thr.numel() == 0


def test_combine_ei_matches_reference(one_word):
    """Q2's plain version against the reference step's combine and EI on
    the same leaf stats, padding rows and columns included."""
    ref, port = one_word
    X = _pool(300, 6, 5)
    m, v = _ref_qs_stats(ref, X, 6)
    plane = RPlane([p.pack() for p in ref])
    S, tps, n_valid = len(ref), plane.uniform_tree_count, 290
    with jax.enable_x64(True):
        zi = jnp.zeros((), dtype=jnp.uint64)
        mul, div = RP._seal_mul(zi), RP._seal_div(zi)
        sq = np.array([f.y_std ** 2 for f in plane.forests])
        means, vars_ = zip(*[RP._combine_source(jnp.asarray(m[s * tps:(s + 1) * tps]),
                                                jnp.asarray(v[s * tps:(s + 1) * tps]),
                                                plane.y_means[s], plane.y_stds[s], sq[s],
                                                mul, div) for s in range(S)])
        want = RP._kernels(zi)["ei"](jnp.stack(means), jnp.stack(vars_),
                                     jnp.asarray(INCS4)[:, None])
        want = np.where(np.arange(300)[None, :] < n_valid, np.asarray(want), -1.0)
    ystats = torch.zeros((3, S + 2), dtype=torch.float64)
    ystats[:, :S] = torch.from_numpy(np.stack([plane.y_means, plane.y_stds, sq]))
    inc = torch.tensor(INCS4 + [0.0, 0.0], dtype=torch.float64)
    meta = torch.tensor([S, tps, n_valid], dtype=torch.int32)
    counts.reset()
    got = PP.combine_ei(torch.from_numpy(m), torch.from_numpy(v), ystats, inc, meta).numpy()
    assert counts.PLAIN_CALLS["combine_ei"] == 1
    assert np.array_equal(_bits(got[:S]), _bits(want))
    assert not got[S:].any()


def _unit_cols(sub_r, sub_p, u):
    sig_r, cols_r = sub_r.plane().device_tables()
    sig_p, cols_p = sub_p.plane().device_tables()
    assert sig_r == sig_p
    out = []
    with jax.enable_x64(True):
        for j, s in enumerate(sig_r):
            want = np.asarray(RP._unit_col(s, tuple(jnp.asarray(a) for a in cols_r[j]),
                                           jnp.asarray(u[:, j])))
            got = PP.unit_col(s, tuple(torch.from_numpy(np.asarray(a)) for a in cols_p[j]),
                              torch.from_numpy(u[:, j])).numpy()
            out.append((s[0], got, want))
    return out


@pytest.mark.parametrize("restricted", [False, True])
def test_unit_col_matches_reference(restricted):
    spaces = [_space(R), _space(PC)]
    if restricted:
        spaces = [s.restrict(keep=["f1", "f2", "i1", "c1", "b1"],
                             ranges={"f1": c.Intervals([(0.5, 1.0), (4.0, 8.0)]),
                                     "i1": c.Intervals([(2, 2)])},
                             cat_subsets={"c1": ["a", "c"]})
                  for s, c in zip(spaces, (R, PC))]
    u = np.random.default_rng(3).random((4096, spaces[0].dim))
    u[0], u[1] = 0.0, 1.0 - 2.0 ** -53
    kinds = set()
    for kind, got, want in _unit_cols(*spaces, u):
        kinds.add(kind)
        assert got.min() >= 0.0 and got.max() <= 1.0
        if kind == 0:
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
        else:
            assert np.array_equal(got, want), kind
    assert kinds == {0, 1, 2, 3}


def test_device_pool_draw():
    space = _space(PC)
    sig, cols = space.plane().device_tables()
    cols = tuple(tuple(torch.from_numpy(np.asarray(a)) for a in c) for c in cols)
    g = torch.Generator().manual_seed(4)
    u = PP.draw_units(g, len(sig), 512)
    lhs = u[256:]
    for j in range(len(sig)):   # one LHS sample a stratum a knob
        assert torch.equal(torch.sort((lhs[:, j] * 256).floor().long()).values,
                           torch.arange(256))
    a = PP.draw_unit_pool(torch.Generator().manual_seed(4), sig, cols, 512)
    b = PP.draw_unit_pool(torch.Generator().manual_seed(4), sig, cols, 512)
    assert a.shape == (512, len(sig)) and torch.equal(a, b)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    gen = torch.Generator().manual_seed(4)
    first = PP.draw_unit_pool(gen, sig, cols, 512)
    assert torch.equal(first, a) and not torch.equal(PP.draw_unit_pool(gen, sig, cols, 512), a)


def test_engine_device_pool_on_the_cpu(one_word):
    _, port = one_word
    space = _space(PC)
    a, b = PC.ProposeEngine(space, seed=0), PC.ProposeEngine(space, seed=0)
    ia, ua, ga = a.propose(port, INCS4, WS4, 5)
    _, ua2, _ = a.propose(port, INCS4, WS4, 5)
    _, ub, _ = b.propose(port, INCS4, WS4, 5)
    assert ua.shape == (128, space.dim) and np.all((ua >= 0) & (ua <= 1))
    assert np.all(np.isfinite(ga)) and np.all(np.diff(ga) >= 0)
    assert np.array_equal(ua, ub) and not np.array_equal(ua, ua2)
    steps = b.propose(port, INCS4, WS4, 5, steps=3)
    assert steps[1].shape == (3, 128, space.dim)
    batch = space.decode_many(ua)
    assert len(batch) == 128


def test_score_topk_and_signatures_bounded(one_word):
    """Many calls at two buckets leave two reference signatures; the CPU
    runs eagerly (no graph); both descents give the staged top n."""
    ref, port = one_word
    eng = PC.ProposeEngine(_space(PC), seed=0)
    rng = np.random.default_rng(11)
    for n_pool in (300, 300, 500, 400, 510):
        X = rng.random((n_pool, 6))
        want = _staged_topk(ref, X, INCS4, WS4, 4)
        assert np.array_equal(eng.score_topk(port, X, INCS4, WS4, 4), want)
        assert np.array_equal(eng.score_topk(port, X, INCS4, WS4, 4, descent="qs"), want)
    assert len({s for s in eng.compiled if s[-1] == "forest"}) == 1
    assert len(eng.compiled) == 2 and not eng.graphs
    with pytest.raises(ValueError):
        eng.score_topk(port, X, INCS4, WS4, 4, descent="jax")


def test_graph_capacities_grow_to_powers_of_two():
    """A slot's buffers hold the largest plane seen: source and tree rows
    exactly, table sizes as powers of two; so a tuner run's planes, whose
    tables grow with its observations, capture a graph a handful of times."""
    caps, grown = {}, 0
    for S, R in [(2, 300), (2, 310), (3, 500), (2, 520), (4, 1100), (4, 1000), (3, 1200)]:
        need = {"S": S, "T": 10 * S, "R": R + 1, "rt": 64}
        new = PE._grow(caps, need)
        assert all(new[k] >= v for k, v in need.items())
        assert all(new[k] >= caps.get(k, 0) for k in new)
        grown += new != caps
        caps = new
    assert caps == {"S": 4, "T": 40, "R": 2048, "rt": 64} and grown == 4


# ------------------------------------------------ MFTune on the fused path


def _observations(core, sim, Budget, obs_mod, **kw):
    dev = {"device": kw.pop("device")} if "device" in kw else {}
    kb = core.KnowledgeBase()
    for i, spec in enumerate([sim.TaskSpec("tpch", 600, "B"), sim.TaskSpec("tpch", 100, "B")]):
        kb.add_task(sim.generate_history(spec.workload(), n_obs=20, seed=i, **dev),
                    persist=False)
    wl = sim.SparkWorkload("tpch", 100, "A")
    with obs_mod.tracing(name="fused") as tr:
        res = core.MFTune(wl, kb, core.MFTuneOptions(seed=0, **kw), **dev).run(
            Budget(8 * 3600.0))
    obs = kb.get(wl.task_id).observations
    sig = [(o.performance, o.fidelity, o.failed, tuple(sorted(o.config.items()))) for o in obs]
    traj = [(p.time, p.best, p.fidelity, tuple(sorted(p.config.items())))
            for p in res.trajectory]
    spans = {e["name"] for e in tr.events if e.get("type") == "span"}
    return sig, traj, res, spans


@pytest.fixture(scope="module")
def tuner_runs():
    ref = _observations(R, RS, RBudget, Robs)
    staged = _observations(PC, PS, PBudget, Pobs, device="cpu")
    counts.reset()
    fused = _observations(PC, PS, PBudget, Pobs, device="cpu", acquisition_backend="fused",
                          acquisition_pool="host")
    return ref, staged, fused, counts.snapshot()


def test_mftune_fused_host_pool_matches_staged_runs(tuner_runs):
    ref, staged, fused, snap = tuner_runs
    assert ref[2].n_evaluations > 40
    assert fused[0] == staged[0] == ref[0]
    assert fused[1] == staged[1] == ref[1]
    assert fused[2].best_performance == ref[2].best_performance
    # the fused step ran: its span, Q2's and K1's plain versions, no staged
    # acquisition span
    assert "propose_step" in fused[3] and "acquisition" not in fused[3]
    assert snap["plain_calls"]["combine_ei"] > 0 and snap["plain_calls"]["forest_eval"] > 0
    assert PC.get_acquisition_backend() == "staged" and PC.get_acquisition_pool() == "device"


def test_acquisition_switches():
    with PC.acquisition_backend("fused"), PC.acquisition_pool("host"):
        assert (PC.get_acquisition_backend(), PC.get_acquisition_pool()) == ("fused", "host")
    assert (PC.get_acquisition_backend(), PC.get_acquisition_pool()) == ("staged", "device")
    with pytest.raises(ValueError):
        PC.set_acquisition_backend("jax")
    with pytest.raises(ValueError):
        PC.set_acquisition_pool("disk")
    from repro_torch.convert import acquisition_backend_from_reference as conv

    assert [conv(b) for b in ("numpy", "jax", "pallas")] == ["staged", "fused", "fused"]
