"""The port's jaxwl workload against the reference's.

``runtime_space()`` is identical. With a cost both packages compute alike
patched into each package's ``run_cell`` (the cell's ``model_flops`` times a
fixed function of the knobs, ``_cost`` below), the port's ``CellWorkload``
under the port's tuner gives the reference's observation stream and
trajectory bit for bit from the same seed, and its caching, overrides,
early stop, failures and batch deduplication behave as the reference's.
On one card (the 1 x 1 mesh) the distribution knobs change no cost.
The reference's ``launch/dryrun.py`` sets ``XLA_FLAGS`` when imported, so
its ``run_cell`` is replaced by a stand-in module, never imported.
"""
from __future__ import annotations

import dataclasses
import sys
import types

import pytest

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.core import KnowledgeBase as RefKB
from repro.core import MFTune as RefMFTune
from repro.core import MFTuneOptions as RefOptions
from repro.jaxwl import CellWorkload as RefCellWorkload
from repro.jaxwl import runtime_space as ref_runtime_space
from repro.tools.flops import model_flops as ref_model_flops
from repro.tuneapi import Budget as RefBudget
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.jaxwl import CellWorkload, runtime_space
from repro_torch.jaxwl.tune import tune_mesh
from repro_torch.launch import dryrun
from repro_torch.tools import model_flops

CELLS = [("llama3-8b", "train_4k"), ("mixtral-8x22b", "decode_32k")]
EVALS = 8


def _factor(ov) -> float:
    """The fixed function of the knobs that scales a cell's model FLOPs."""
    return ({"none": 1.0, "dots": 1.25, "full": 1.5}[ov["remat"]]
            * (0.9 if ov["seq_shard"] else 1.0) * (0.85 if ov["fsdp"] else 1.0)
            * (1.0 + ov["attn_chunk"] / 8192.0) * (1.0 + 0.1 * (ov["scan_unroll"] - 1))
            * ov["capacity_factor"] * (0.8 if ov["opt_state_dtype"] == "bfloat16" else 1.0)
            * (0.95 if ov["act_shard"] else 1.0))


def _cost(flops_fn, archs, shapes, calls):
    def run_cell(arch, shape, multi_pod, overrides):
        calls.append((arch, shape, multi_pod, tuple(sorted(overrides.items()))))
        if arch == "broken":
            return {"status": "error"}
        t = flops_fn(archs[arch], shapes[shape]) / 1e18 * _factor(overrides)
        return {"status": "ok", "roofline": {"step_time_s": t}}
    return run_cell


@pytest.fixture
def patched(monkeypatch):
    """(reference calls, port calls) of the two patched ``run_cell``s."""
    ref_calls, calls = [], []
    stand_in = types.ModuleType("repro.launch.dryrun")
    stand_in.run_cell = _cost(ref_model_flops, REF_ARCHS, REF_SHAPES, ref_calls)
    monkeypatch.setitem(sys.modules, "repro.launch.dryrun", stand_in)
    monkeypatch.setattr(dryrun, "run_cell", _cost(model_flops, ARCHS, SHAPES, calls))
    return ref_calls, calls


def _knobs(space):
    return [(type(k).__name__, dataclasses.asdict(k)) for k in space.knobs]


def test_runtime_space_identical():
    assert _knobs(runtime_space()) == _knobs(ref_runtime_space())
    assert runtime_space().default() == ref_runtime_space().default()


def _stream(kb, wl):
    return [(o.performance, o.fidelity, tuple(sorted(o.config.items())))
            for o in kb.get(wl.task_id).observations]


def test_observation_stream_bit_for_bit(patched):
    ref_calls, calls = patched
    ref_wl = RefCellWorkload(CELLS, cache_path="")
    ref_base = ref_wl.evaluate(ref_wl.default_config())
    ref_tuner = RefMFTune(ref_wl, RefKB(), RefOptions(seed=0, enable_mfo=False,
                                                        enable_transfer=False, init_lhs=4))
    ref_res = ref_tuner.run(RefBudget(ref_base.aggregate * EVALS))

    base, res, tuner = tune_mesh(CELLS, EVALS, cache_path="", device="cpu")
    assert base.per_query_latency == ref_base.per_query_latency
    stream = _stream(tuner.kb, tuner.wl)
    assert len(stream) >= EVALS
    assert stream == _stream(ref_tuner.kb, ref_wl)
    assert [(p.time, p.best, tuple(sorted(p.config.items()))) for p in res.trajectory] == \
        [(p.time, p.best, tuple(sorted(p.config.items()))) for p in ref_res.trajectory]
    assert res.best_performance == ref_res.best_performance
    assert calls == ref_calls                     # the same cells traced, once each


def test_cache_overrides_early_stop_failures_and_dedup(patched, tmp_path):
    ref_calls, calls = patched
    path = tmp_path / "evals.json"
    wl, ref_wl = CellWorkload(CELLS, cache_path=str(path)), RefCellWorkload(CELLS, cache_path="")
    cfg = dict(wl.default_config(), remat="none", seq_shard=False)
    for w in (wl, ref_wl):
        a = w.evaluate(cfg)
        b = w.evaluate(cfg)                       # from the cache
        capped = w.evaluate(cfg, cost_cap=a.per_query_latency[0] / 2)
        many = w.evaluate_many([cfg, cfg, dict(cfg, fsdp=False)], cost_cap=[None, None, 1e9])
        assert a.per_query_latency == b.per_query_latency and not a.failed
        assert capped.failed and capped.failure_reason == "early_stop"
        assert many[0] is many[1] and not many[2].failed
    assert calls == ref_calls and len(calls) == 4
    # non-train cells trace with remat "none" and no sequence sharding
    decode = [dict(c[3]) for c in calls if c[1] == "decode_32k"]
    assert all(d["remat"] == "none" and d["seq_shard"] is False for d in decode)
    assert CellWorkload(CELLS, cache_path=str(path))._cache == wl._cache   # persisted
    broken = [("broken", "train_4k")]
    for w in (CellWorkload(broken, cache_path=""), RefCellWorkload(broken, cache_path="")):
        r = w.evaluate(w.default_config())
        assert r.failed and r.failure_reason == "compile_error"


def test_knobs_that_change_nothing_on_one_card():
    """On the 1 x 1 mesh no axis splits anything: ``seq_shard``, ``fsdp``,
    ``act_shard`` (and ``scan_unroll``, which the eager port never reads)
    leave the step's costs as they are; ``remat``, ``attn_chunk`` and
    ``opt_state_dtype`` still change the train step, as they change what the
    card runs."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.configs import ShapeConfig, reduced
    from repro_torch.launch.mesh import fake_world
    from repro_torch.models import Runtime

    with fake_world(1):
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    cfg = dataclasses.replace(reduced(ARCHS["llama3-8b"]), n_layers=1)
    shape = ShapeConfig("t", 1024, 16, "train")
    base = Runtime(remat="full", seq_shard=True, attn_chunk=1024)

    def costs(**kw):
        c, mem, _ = dryrun.cell_costs(cfg, shape, dataclasses.replace(base, **kw), mesh)
        return c.flops, c.bytes, c.collective_bytes, c.temp_bytes, mem["argument_bytes"]

    default = costs()
    assert default[2] == 0.0
    for kw in ({"seq_shard": False}, {"fsdp": False}, {"act_shard": False},
               {"scan_unroll": 2}):
        assert costs(**kw) == default, kw
    for kw in ({"remat": "none"}, {"attn_chunk": 512}, {"opt_state_dtype": "bfloat16"}):
        assert costs(**kw) != default, kw
