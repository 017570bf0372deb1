"""The paper's baseline tuners through the port on the CPU against the JAX
package's, and the Tuneful baseline's Gaussian process.

Target TPC-H 100 GB on hardware A, a knowledge base of {tpch-600-B,
tpch-100-B} x 20 observations, made afresh for every run (Rover adds the
target's record to it), 8 virtual hours, seed 0: each tuner's observation
stream (performance, fidelity, failed, config), trajectory, span names and
``overheads`` keys must be identical to the reference's.
"""
from __future__ import annotations

import numpy as np
import pytest

import repro.baselines as RB
import repro.core as R
import repro.obs as Robs
import repro.sparksim as RS
import repro_torch.baselines as PB
import repro_torch.core as P
import repro_torch.obs as Pobs
import repro_torch.sparksim as PS
from repro.tuneapi import Budget as RBudget
from repro_torch.kernels import counts
from repro_torch.tuneapi import Budget as PBudget

TUNERS = ("RandomSearch", "VanillaBO", "LOCAT", "TopTune", "Rover", "LOFTune", "Tuneful")
# the tuners whose proposals descend a forest (K1's plain version here) within
# 8 h; TopTune's synthetic-space forest needs two earlier continuous-phase
# evaluations, which its 10 evaluations in 8 h do not give it
FOREST_TUNERS = ("VanillaBO", "LOCAT", "Rover", "LOFTune", "Tuneful")


def _kb(core, sim, **dev):
    kb = core.KnowledgeBase()
    for i, spec in enumerate([sim.TaskSpec("tpch", 600, "B"), sim.TaskSpec("tpch", 100, "B")]):
        kb.add_task(sim.generate_history(spec.workload(), n_obs=20, seed=i, **dev),
                    persist=False)
    return kb


def _run(name, pkg, core, sim, Budget, obs_mod, **dev):
    kb = _kb(core, sim, **dev)
    wl = sim.SparkWorkload("tpch", 100, "A")
    tuner = getattr(pkg, name)(wl, kb=kb, seed=0, **dev)
    counts.reset()
    with obs_mod.tracing(name="parity") as tr:
        res = tuner.run(Budget(8 * 3600.0))
    snap = counts.snapshot()
    stream = [(o.performance, o.fidelity, o.failed, tuple(sorted(o.config.items())))
              for o in tuner.obs]
    traj = [(p.time, p.best, p.fidelity, p.rung, tuple(sorted(p.config.items())))
            for p in res.trajectory]
    spans = {e["name"] for e in tr.events if e.get("type") == "span"}
    return dict(res=res, stream=stream, traj=traj, spans=spans, overheads=set(res.overheads),
                counts=snap)


@pytest.fixture(scope="module")
def runs():
    out = {}
    for name in TUNERS:
        ref = _run(name, RB, R, RS, RBudget, Robs)
        port = _run(name, PB, P, PS, PBudget, Pobs, device="cpu")
        out[name] = (ref, port, port["counts"])
    return out


@pytest.mark.parametrize("name", TUNERS)
def test_observation_stream_identical(runs, name):
    ref, port, _ = runs[name]
    assert ref["res"].n_evaluations >= 8
    assert port["res"].n_evaluations == ref["res"].n_evaluations
    assert port["stream"] == ref["stream"]


@pytest.mark.parametrize("name", TUNERS)
def test_trajectory_and_result_identical(runs, name):
    ref, port, _ = runs[name]
    assert port["traj"] == ref["traj"]
    assert port["res"].best_performance == ref["res"].best_performance
    assert port["res"].best_config == ref["res"].best_config
    assert port["res"].n_full_evaluations == ref["res"].n_full_evaluations


@pytest.mark.parametrize("name", TUNERS)
def test_span_names_and_overheads_identical(runs, name):
    ref, port, _ = runs[name]
    assert port["spans"] == ref["spans"]
    assert port["overheads"] == ref["overheads"]
    assert {"bo_recommend", "workload_eval", "iteration"} <= port["spans"]


@pytest.mark.parametrize("name", TUNERS)
def test_plain_versions_only_on_the_cpu(runs, name):
    _, _, snap = runs[name]  # the counts of the port's tuner run alone
    assert all(v == 0 for v in snap["launches"].values()), snap
    assert (snap["plain_calls"]["forest_eval"] > 0) == (name in FOREST_TUNERS), snap
    assert (snap["plain_calls"]["radix_rank"] > 0) == (name == "Rover"), snap


@pytest.mark.parametrize("name", TUNERS)
def test_default_device_needs_a_card(name):
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wl = PS.SparkWorkload("tpch", 100, "A")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        getattr(PB, name)(wl, kb=P.KnowledgeBase(), seed=0)


def test_rover_mirrors_the_target_into_the_knowledge_base():
    kb = _kb(P, PS, device="cpu")
    wl = PS.SparkWorkload("tpch", 100, "A")
    tuner = PB.Rover(wl, kb=kb, seed=0, device="cpu")
    tuner.run(PBudget(2 * 3600.0))
    assert kb.get(wl.task_id).observations == tuner.obs


def test_permutation_importance_equals_one_prediction_a_column():
    from repro_torch.baselines.common import permutation_importance

    rng = np.random.default_rng(5)
    X, y = rng.random((24, 9)), rng.random(24)
    model = P.make_forest(seed=2, device="cpu").fit(X, y)
    got = permutation_importance(model, X, [0, 3, 8, 4], np.random.default_rng(7))
    r = np.random.default_rng(7)
    base = model.predict_mean(X)
    want = []
    for j in [0, 3, 8, 4]:
        Xp = X.copy()
        Xp[:, j] = r.permutation(Xp[:, j])
        want.append(float(np.abs(model.predict_mean(Xp) - base).mean()))
    assert got.tolist() == want


# ------------------------------------------------------------ GaussianProcess


@pytest.mark.parametrize("n,d,seed", [(6, 3, 0), (30, 8, 1), (48, 60, 2)])
def test_gaussian_process_identical(n, d, seed):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d))
    y = np.sin(X @ rng.random(d) * 3.0) + 0.1 * rng.random(n)
    Xq = rng.random((17, d))
    ref, port = R.GaussianProcess().fit(X, y), P.GaussianProcess().fit(X, y)
    assert (port.ls_, port.noise_) == (ref.ls_, ref.noise_)
    assert np.array_equal(port.L_, ref.L_) and np.array_equal(port.alpha_, ref.alpha_)
    for a, b in zip(port.predict(Xq), ref.predict(Xq)):
        assert np.array_equal(a, b)
    assert np.array_equal(port.predict_mean(Xq), ref.predict_mean(Xq))


def test_gaussian_process_fit_failure_raises_in_both():
    X = np.zeros((4, 2))
    y = np.arange(4.0)
    for gp in (R.GaussianProcess(noises=(-2.0,)), P.GaussianProcess(noises=(-2.0,))):
        with pytest.raises(RuntimeError, match="GP fit failed"):
            gp.fit(X, y)
