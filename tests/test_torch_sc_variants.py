"""The four space-compression variants of the paper's Fig. 6 ablation (Box,
Decrease, Project, Vote) through the port on the CPU against the JAX
package's: each compressor's space on the same inputs, and MFTune with
each compressor in place of its own (``MFTuneOptions.compressor``).
"""
from __future__ import annotations

import pytest

import repro.baselines as RB
import repro.core as R
import repro.sparksim as RS
import repro_torch.baselines as PB
import repro_torch.core as P
import repro_torch.sparksim as PS
from repro.tuneapi import Budget as RBudget
from repro_torch.tuneapi import Budget as PBudget

COMPRESSORS = ("BoxCompressor", "DecreaseCompressor", "ProjectCompressor", "VoteCompressor")
SOURCES = (("tpch", 600, "B"), ("tpch", 100, "B"))
# virtual hours of each MFTune run: Decrease needs 8 h to reach its first
# knob drop (10 full evaluations); Box and Vote make twice the evaluations of
# the others in 8 h, and 6 h already calls them a dozen times
HOURS = {"BoxCompressor": 6.0, "DecreaseCompressor": 8.0, "ProjectCompressor": 8.0,
         "VoteCompressor": 6.0}


def space_sig(space):
    """Every knob of a space with its type, bounds and restriction."""
    out = []
    for k in space.knobs:
        fields = dict(vars(k))
        r = fields.get("restriction")
        if r is not None and not isinstance(r, tuple):
            fields["restriction"] = [tuple(iv) for iv in r]
        out.append((type(k).__name__, tuple(sorted((f, repr(v)) for f, v in fields.items()))))
    return out


def make(pkg, name, **dev):
    return getattr(pkg, name)(**dev) if name == "DecreaseCompressor" else getattr(pkg, name)()


class Recording:
    """A compressor that records the space of each of its calls."""

    def __init__(self, inner):
        self.inner, self.spaces = inner, []

    def __call__(self, space, weights, tasks, target=None):
        out = self.inner(space=space, weights=weights, tasks=tasks, target=target)
        self.spaces.append(space_sig(out))
        return out


def _inputs(core, sim, **dev):
    """A knowledge base of the two sources, a target record of 20 full
    evaluations of TPC-H 100 GB on hardware A, and fixed weights."""
    kb = core.KnowledgeBase()
    for i, spec in enumerate(SOURCES):
        kb.add_task(sim.generate_history(sim.TaskSpec(*spec).workload(), n_obs=20, seed=i, **dev),
                    persist=False)
    target = sim.generate_history(sim.TaskSpec("tpch", 100, "A").workload(), n_obs=20, seed=7,
                                  **dev)
    ids = list(kb.tasks)
    weights = core.TaskWeights(weights={ids[0]: 0.5, ids[1]: 0.3, "__target__": 0.2},
                               similarities={ids[0]: 0.5, ids[1]: 0.3}, used_meta=True)
    return sim.SparkWorkload("tpch", 100, "A").space, weights, dict(kb.tasks), target


@pytest.mark.parametrize("name", COMPRESSORS)
def test_compressed_space_identical(name):
    spaces = []
    for pkg, core, sim, dev in ((RB, R, RS, {}), (PB, P, PS, {"device": "cpu"})):
        space, weights, tasks, target = _inputs(core, sim, **dev)
        comp = make(pkg, name, **dev)
        spaces.append([space_sig(comp(space=space, weights=weights, tasks=tasks,
                                      target=target)) for _ in range(2)])
    assert spaces[1] == spaces[0]
    assert spaces[0][0] != space_sig(PS.SparkWorkload("tpch", 100, "A").space)


def _tune(pkg, core, sim, Budget, name, **dev):
    kb = core.KnowledgeBase()
    for i, spec in enumerate(SOURCES):
        kb.add_task(sim.generate_history(sim.TaskSpec(*spec).workload(), n_obs=20, seed=i, **dev),
                    persist=False)
    wl = sim.SparkWorkload("tpch", 100, "A")
    comp = Recording(make(pkg, name, **dev))
    res = core.MFTune(wl, kb, core.MFTuneOptions(seed=0, compressor=comp), **dev).run(
        Budget(HOURS[name] * 3600.0))
    stream = [(o.performance, o.fidelity, o.failed, tuple(sorted(o.config.items())))
              for o in kb.get(wl.task_id).observations]
    traj = [(p.time, p.best, p.fidelity, tuple(sorted(p.config.items())))
            for p in res.trajectory]
    return stream, traj, comp.spaces, res


@pytest.mark.parametrize("name", COMPRESSORS)
def test_mftune_with_compressor_identical(name):
    ref = _tune(RB, R, RS, RBudget, name)
    port = _tune(PB, P, PS, PBudget, name, device="cpu")
    assert len(ref[2]) > 0, "the compressor was never called"
    assert port[2] == ref[2]
    assert port[0] == ref[0] and len(ref[0]) > 10
    assert port[1] == ref[1]
    assert port[3].best_performance == ref[3].best_performance
    if name == "DecreaseCompressor":
        assert len(ref[2][-1]) < len(ref[2][0]), "Decrease never dropped a knob"


def test_decrease_compressor_needs_a_card_by_default():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PB.DecreaseCompressor()
