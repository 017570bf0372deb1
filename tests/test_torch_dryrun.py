"""The port's dry-run tooling against the reference's.

``model_flops`` is equal for every (arch, shape); every cell's parameters,
optimizer state, inputs and caches are sized on the ``meta`` device with
the reference's shapes and dtypes; the step-cost walker's product FLOPs of
a reduced llama3-8b prefill and train step are held to the dot FLOPs that
the reference's ``analyze_hlo`` counts in the same cell compiled on one CPU
device; ``run_cell``'s record and the command line. The walker's own
rules are in ``test_torch_step_cost.py``.
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import SHAPES as REF_SHAPES
from repro.configs import reduced as ref_reduced
from repro.configs.base import ShapeConfig as RefShape
from repro.models import Runtime as RefRuntime
from repro.models import abstract_params as ref_abstract_params
from repro.models import build_param_specs as ref_specs
from repro.optim import adamw_init_abstract as ref_adamw_abstract
from repro.tools import flops as ref_flops
from repro.tools import hlo_analysis
from repro.train import input_specs as ref_input_specs
from repro.train import make_prefill_step as ref_prefill_step
from repro.train import make_train_step as ref_train_step
from repro_torch import configs
from repro_torch.configs import ARCHS, SHAPES, ShapeConfig, get_arch, reduced
from repro_torch.launch import dryrun
from repro_torch.launch.mesh import fake_world
from repro_torch.models import Runtime, abstract_params, build_param_specs
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw_init_abstract
from repro_torch.tools import model_flops
from repro_torch.train import input_specs

CELLS = [(a, s) for a in sorted(ARCHS) for s in SHAPES]


def _mesh(shape, names):
    from torch.distributed.device_mesh import init_device_mesh

    with fake_world(int(np.prod(shape))):
        return init_device_mesh("cpu", shape, mesh_dim_names=names)


@pytest.fixture(scope="module")
def mesh1():
    return _mesh((1, 1), ("data", "model"))


@pytest.mark.parametrize("arch,shape", CELLS)
def test_model_flops_equal(arch, shape):
    assert model_flops(ARCHS[arch], SHAPES[shape]) == \
        ref_flops.model_flops(REF_ARCHS[arch], REF_SHAPES[shape])


def _same(t: torch.Tensor, ref) -> bool:
    return (t.device.type == "meta" and tuple(t.shape) == tuple(ref.shape)
            and str(t.dtype).split(".")[-1] == jnp.dtype(ref.dtype).name)


@pytest.mark.parametrize("arch,shape", CELLS)
def test_trees_sized_on_meta_as_the_reference(arch, shape):
    cfg, ref_cfg, sh, ref_sh = ARCHS[arch], REF_ARCHS[arch], SHAPES[shape], REF_SHAPES[shape]
    rt, ref_rt = Runtime(), RefRuntime()
    params = tree_leaves(abstract_params(build_param_specs(cfg, rt)))
    ref_params = jax.tree.leaves(ref_abstract_params(ref_specs(ref_cfg, ref_rt)))
    assert len(params) == len(ref_params)
    assert all(_same(p, r) for p, r in zip(params, ref_params))
    n_bytes = sum(p.numel() * p.element_size() for p in params)
    assert n_bytes > 1e8
    if sh.kind == "train":
        opt = adamw_init_abstract(abstract_params(build_param_specs(cfg, rt)))
        ref_opt = ref_adamw_abstract(ref_abstract_params(ref_specs(ref_cfg, ref_rt)))
        assert _same(opt.step, ref_opt.step)
        for got, want in ((opt.m, ref_opt.m), (opt.v, ref_opt.v)):
            assert all(_same(a, b) for a, b in zip(tree_leaves(got), jax.tree.leaves(want)))
    ins, ref_ins = input_specs(cfg, sh, rt), ref_input_specs(ref_cfg, ref_sh, ref_rt)
    assert set(ins) == set(ref_ins)
    for group in ins:
        tree, ref_tree = ins[group], ref_ins[group]
        if isinstance(tree, dict):
            assert set(tree) == set(ref_tree)
            assert all(_same(tree[k], ref_tree[k]) for k in tree), group
        else:
            assert _same(tree, ref_tree)


def _ref_dot_flops(hlo: str) -> float:
    """The dot FLOPs of the reference's walker: its total less its total
    with every dot counted as 0."""
    total = hlo_analysis.analyze_hlo(hlo).flops
    orig = hlo_analysis._dot_flops
    hlo_analysis._dot_flops = lambda op, defs: 0.0
    try:
        rest = hlo_analysis.analyze_hlo(hlo).flops
    finally:
        hlo_analysis._dot_flops = orig
    return total - rest


@pytest.fixture(scope="module")
def reference_dots():
    """kind -> the reference's dot FLOPs of reduced llama3-8b at 2 layers,
    remat "none", layers unrolled, 2 x 64 tokens, compiled on one CPU
    device (both cells compile at once)."""
    from concurrent.futures import ThreadPoolExecutor

    ref_cfg = dataclasses.replace(ref_reduced(REF_ARCHS["llama3-8b"]), n_layers=2)
    ref_rt = RefRuntime(remat="none", scan_layers=False)
    params = ref_abstract_params(ref_specs(ref_cfg, ref_rt))

    def dots(kind):
        batch = ref_input_specs(ref_cfg, RefShape("t", 64, 2, kind), ref_rt)["batch"]
        if kind == "train":
            lowered = jax.jit(ref_train_step(ref_cfg, ref_rt)).lower(
                params, ref_adamw_abstract(params), batch)
        else:
            lowered = jax.jit(ref_prefill_step(ref_cfg, ref_rt)).lower(params, batch)
        return lowered.compile().as_text()

    with ThreadPoolExecutor(2) as pool:
        hlo = dict(zip(("prefill", "train"), pool.map(dots, ("prefill", "train"))))
    return {k: _ref_dot_flops(v) for k, v in hlo.items()}


@pytest.mark.parametrize("kind", ["prefill", "train"])
def test_product_flops_match_reference_hlo(mesh1, reference_dots, kind):
    """The eager step recomputes the attention scores of each block in both
    backward passes and the loss chunk's logits, where XLA keeps most of
    them, so the distinct products are held within 2 % of the reference's
    dots; the gap of all that runs is reported."""
    ref_dots = reference_dots[kind]
    cfg = dataclasses.replace(reduced(get_arch("llama3-8b")), n_layers=2)
    costs, _, _ = dryrun.cell_costs(cfg, ShapeConfig("t", 64, 2, kind),
                                    Runtime(remat="none", scan_layers=False), mesh1)
    gap_unique = costs.global_unique_flops / ref_dots - 1
    gap_all = costs.global_flops / ref_dots - 1
    print(f"{kind}: reference dots {ref_dots:.6g}, port distinct products "
          f"{costs.global_unique_flops:.6g} ({gap_unique:+.4%}), all products run "
          f"{costs.global_flops:.6g} ({gap_all:+.4%})")
    assert abs(gap_unique) <= 0.02
    assert costs.flops == costs.global_flops          # one device: nothing splits
    if kind == "prefill":
        assert costs.global_flops == ref_dots


def _small(monkeypatch):
    monkeypatch.setattr(configs, "get_arch", lambda name: reduced(ARCHS[name]))
    monkeypatch.setattr(configs, "SHAPES", {
        "train_4k": ShapeConfig("train_4k", 32, 32, "train"),
        "decode_32k": ShapeConfig("decode_32k", 32, 32, "decode"),
        "long_500k": SHAPES["long_500k"]})


def test_run_cell_record(monkeypatch):
    """``run_cell``'s statuses and keys, at reduced widths and shapes."""
    _small(monkeypatch)
    r = dryrun.run_cell("llama3-8b", "long_500k", False)
    assert r["status"] == "skipped" and "quadratic" in r["reason"]
    for arch, shape, mp in (("llama3-8b", "train_4k", False), ("rwkv6-7b", "decode_32k", True)):
        r = dryrun.run_cell(arch, shape, mp, {"attn_chunk": 32})
        assert r["status"] == "ok" and r["chips"] == (512 if mp else 256)
        assert r["mesh"] == ("2x16x16" if mp else "16x16")
        assert set(r["memory"]) == {"argument_bytes", "output_bytes", "temp_bytes",
                                    "alias_bytes", "generated_code_bytes",
                                    "temp_gb_per_device", "args_gb_per_device"}
        rl = r["roofline"]
        assert rl["step_time_s"] == max(rl["compute_s"], rl["memory_s"], rl["collective_s"]) > 0
        assert r["runtime"]["attn_chunk"] == 32 and r["trip_counts"]["layers"] >= 1
        assert {"lower_s", "compile_s", "hlo_notes", "n_while"} <= set(r)


def test_main_writes_and_resumes(monkeypatch, tmp_path, capsys):
    _small(monkeypatch)
    out = tmp_path / "dry.json"
    argv = ["dryrun", "--arch", "llama3-8b", "--shape", "long_500k", "--both-meshes",
            "--out", str(out)]
    monkeypatch.setattr("sys.argv", argv)
    dryrun.main()
    monkeypatch.setattr("sys.argv", argv + ["--resume"])
    dryrun.main()
    import json

    assert [r["status"] for r in json.loads(out.read_text())] == ["skipped", "skipped"]
    assert "0 ok, 2 skipped, 0 errors" in capsys.readouterr().out
