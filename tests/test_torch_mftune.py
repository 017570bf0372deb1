"""The whole slice: a fixed-seed MFTune run through the port on the CPU
against the JAX package's run.

Target TPC-H 100 GB on hardware A, a knowledge base of {tpch-600-B,
tpch-100-B} x 20 observations, 8 virtual hours: the run reaches all three
kernels' plain versions (descent, rank, Shapley chains), and its
observation stream and trajectory must be identical to the reference's.
"""
from __future__ import annotations

import pytest

import repro.core as R
import repro.obs as Robs
import repro.sparksim as RS
import repro_torch.core as P
import repro_torch.obs as Pobs
import repro_torch.sparksim as PS
from repro.tuneapi import Budget as RBudget
from repro_torch.kernels import counts
from repro_torch.tuneapi import Budget as PBudget


def _run(core, sim, Budget, obs_mod, **dev):
    kb = core.KnowledgeBase()
    for i, spec in enumerate([sim.TaskSpec("tpch", 600, "B"), sim.TaskSpec("tpch", 100, "B")]):
        kb.add_task(sim.generate_history(spec.workload(), n_obs=20, seed=i, **dev),
                    persist=False)
    kb_sig = {t: [(o.performance, tuple(sorted(o.config.items()))) for o in r.observations]
              for t, r in kb.tasks.items()}
    wl = sim.SparkWorkload("tpch", 100, "A")
    with obs_mod.tracing(name="parity") as tr:
        res = core.MFTune(wl, kb, core.MFTuneOptions(seed=0), **dev).run(Budget(8 * 3600.0))
    obs = kb.get(wl.task_id).observations
    sig = [(o.performance, o.fidelity, o.failed, tuple(sorted(o.config.items()))) for o in obs]
    traj = [(p.time, p.best, p.fidelity, tuple(sorted(p.config.items())))
            for p in res.trajectory]
    spans = {e["name"] for e in tr.events if e.get("type") == "span"}
    return kb_sig, sig, traj, res, spans


@pytest.fixture(scope="module")
def runs():
    ref = _run(R, RS, RBudget, Robs)
    counts.reset()
    port = _run(P, PS, PBudget, Pobs, device="cpu")
    return ref, port, counts.snapshot()


def test_knowledge_base_histories_identical(runs):
    (ref, port, _) = runs
    assert port[0] == ref[0]


def test_observation_stream_identical(runs):
    ref, port, _ = runs
    assert ref[3].n_evaluations > 40
    assert port[1] == ref[1]


def test_trajectory_and_result_identical(runs):
    ref, port, _ = runs
    assert port[2] == ref[2]
    assert port[3].best_performance == ref[3].best_performance
    assert port[3].n_full_evaluations == ref[3].n_full_evaluations
    assert port[3].mfo_activation_time == ref[3].mfo_activation_time


TUNER_KERNELS = ("forest_eval", "radix_rank", "chain_ordinals")


def test_every_kernel_plain_version_ran(runs):
    _, _, snap = runs
    assert all(snap["plain_calls"][k] > 0 for k in TUNER_KERNELS), snap
    assert all(v == 0 for v in snap["launches"].values()), snap


def test_span_vocabulary_matches_reference(runs):
    ref, port, _ = runs
    assert port[4] == ref[4]
    assert {"similarity", "space_compression", "shapley_attribution", "acquisition",
            "surrogate_eval", "mfo_bracket", "evaluate"} <= port[4]


def test_default_device_needs_a_card():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    wl = PS.SparkWorkload("tpch", 100, "A")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        P.MFTune(wl, P.KnowledgeBase())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.generate_history(wl, n_obs=3)
