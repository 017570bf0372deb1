"""The step-cost walker's rules: its FLOPs are FlopCounterMode's, its
splitting of work and its collectives on a 16 x 16 mesh, the depth
extrapolation of ``launch/dryrun.py`` against a direct trace, and the
roofline with its H100 spec (the reference's report keys).
"""
from __future__ import annotations

import dataclasses

import pytest
import torch

from repro.tools.roofline import RooflineReport as RefReport
from repro_torch.configs import ShapeConfig, get_arch, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import Runtime
from repro_torch.tools import H100, V5E, StepCostMode, roofline_terms
from repro_torch.tools.step_cost import StepCosts


@pytest.fixture(scope="module")
def mesh16():
    with fake_world(256):
        return make_production_mesh()


@pytest.fixture(scope="module")
def mesh1():
    from torch.distributed.device_mesh import init_device_mesh

    with fake_world(1):
        return init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))


def test_walker_flops_are_flop_counter_modes(mesh1):
    """The walker's total is FlopCounterMode's over the same step."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.flop_counter import FlopCounterMode

    from repro_torch.models import build_param_specs, forward
    from repro_torch.models.params import tree_map

    cfg = reduced(get_arch("mixtral-8x22b"))
    rt = Runtime()
    costs, _, _ = dryrun.cell_costs(dataclasses.replace(cfg, n_layers=1),
                                    ShapeConfig("t", 32, 2, "prefill"), rt, mesh1)
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = tree_map(lambda s: torch.zeros(s.shape, dtype=s.dtype),
                          build_param_specs(dataclasses.replace(cfg, n_layers=1), rt))
        tokens = torch.zeros((2, 32), dtype=torch.int32)
        with FlopCounterMode(display=False) as fc:
            forward(params, dataclasses.replace(cfg, n_layers=1), rt, tokens=tokens)
    assert costs.global_flops == fc.get_total_flops()


def test_splitting_rules(mesh16):
    """Column- then row-parallel products, a vocabulary-split gather and a
    data-contracted weight gradient on 16 x 16."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import NamedSharding

    with FakeTensorMode():
        x = torch.zeros(64, 32)
        w1, w2 = torch.zeros(32, 128), torch.zeros(128, 32)
        table, idx = torch.zeros(512, 32), torch.zeros(64, dtype=torch.int64)
        mode = StepCostMode(mesh16, fsdp=False)
        mode.place(x, NamedSharding(mesh16, ("data",)))
        mode.place(w1, NamedSharding(mesh16, (None, "model")), param=True)
        mode.place(w2, NamedSharding(mesh16, ("model",)), param=True)
        mode.place(table, NamedSharding(mesh16, ("model",)), param=True)
        mode.place(idx, NamedSharding(mesh16, ("data",)))
        with mode:
            h = x @ w1                       # column-parallel: no reduction
            y = h @ w2                       # row-parallel: an all-reduce over model
            e = table[idx]                   # a vocabulary-split gather
            gw = x.t() @ y                   # contracted over the data axis
        c = mode.costs
        assert mode.tag(h) == {"data", "model"} and mode.tag(y) == {"data"}
        assert mode.tag(e) == {"data"} and mode.tag(gw) == frozenset()
        assert c.global_flops == 2 * 64 * 32 * 128 * 2 + 2 * 32 * 64 * 32
        assert c.flops == 2 * 64 * 32 * 128 * 2 / 256 + 2 * 32 * 64 * 32 / 16
        out = 64 * 32 * 4 / 16                  # y's and e's bytes a device
        want = 2 * 15 / 16 * out * 2 + 2 * 15 / 16 * (32 * 32 * 4)
        assert c.collectives == {"all-reduce": pytest.approx(want)}


@pytest.mark.parametrize("arch,kind", [("llama3-8b", "train"), ("zamba2-2.7b", "prefill"),
                                       ("seamless-m4t-medium", "prefill"),
                                       ("deepseek-v3-671b", "decode")])
def test_depth_extrapolation_equals_a_direct_trace(mesh16, arch, kind):
    base = reduced(get_arch(arch))
    full = {"zamba2-2.7b": dict(n_layers=9, attn_every=3),
            "seamless-m4t-medium": dict(n_layers=2, n_encoder_layers=3),
            "deepseek-v3-671b": dict(n_layers=4),
            "llama3-8b": dict(n_layers=3)}[arch]
    cfg = dataclasses.replace(base, **full)
    shape = ShapeConfig("t", 16, 32, kind)
    rt = Runtime(remat="full" if kind == "train" else "none", attn_chunk=16)
    costs, mem, rec = dryrun.cell_costs(cfg, shape, rt, mesh16)
    direct, _ = dryrun._trace(cfg, shape, rt, mesh16)
    assert rec["trip_counts"] == dryrun.depth_units(cfg)
    for name in ("flops", "global_flops", "bytes", "collective_bytes", "n_ops"):
        assert getattr(costs, name) == pytest.approx(getattr(direct, name), rel=1e-9), name
    # a peak: saved activations grow with the depth in a train step, a
    # forward's is nearly one body's
    assert costs.temp_bytes == pytest.approx(direct.temp_bytes, rel=0.05)
    assert mem["argument_bytes"] > 0 and costs.flops * 16 <= costs.global_flops


def test_roofline_h100_and_own_chip():
    costs = StepCosts(flops=989e12, bytes=3.35e12 / 2, collective_bytes=450e9 * 3,
                      collectives={"all-reduce": 450e9 * 3})
    r = roofline_terms("a", "s", "16x16", 256, costs, model_fl=256 * 989e12 / 2)
    assert (r.compute_s, r.memory_s, r.collective_s) == (1.0, 0.5, 3.0)
    assert r.bottleneck == "collective" and r.step_time_s == 3.0
    assert r.roofline_fraction == pytest.approx(1 / 6)
    v = roofline_terms("a", "s", "16x16", 256, costs, model_fl=256 * 989e12 / 2, chip=V5E)
    assert v.roofline_fraction == pytest.approx(256 * 989e12 / 2 / v.step_time_s
                                                / (256 * V5E.peak_flops))
    assert (H100.peak_flops, H100.hbm_bw, H100.link_bw) == (989e12, 3.35e12, 450e9)
    ref = RefReport("a", "s", "m", 1, 1.0, 1.0, 1.0)
    assert set(r.to_json()) == set(ref.to_json())


def test_fsdp_gradient_reduce_scatter_and_sequence_gather(mesh16):
    """Under FSDP a data-contracted weight gradient is reduce-scattered and
    stays split over the data axis; a sequence-split activation meeting a
    column-parallel weight is gathered over "model" first."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from repro_torch.distributed.sharding import NamedSharding

    with FakeTensorMode():
        x, dy = torch.zeros(64, 32), torch.zeros(64, 128)
        w = torch.zeros(32, 128)
        mode = StepCostMode(mesh16, fsdp=True)
        mode.place(dy, NamedSharding(mesh16, ("data", "model")))   # h's gradient
        mode.place(w, NamedSharding(mesh16, (None, "model")), param=True)
        mode.on_place(x, ("data", "model"))              # batch and sequence
        with mode:
            h = x @ w
            gw = x.t() @ dy
        assert mode.tag(h) == {"data", "model"}
        assert mode.tag(gw) == {"data", "model"}
        c = mode.costs.collectives
        assert c["all-gather"] == pytest.approx(2 * 15 / 16 * 64 * 32 * 4 / 16)
        assert c["reduce-scatter"] == pytest.approx(15 / 16 * 32 * 128 * 4 / 16)
