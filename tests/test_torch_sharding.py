"""The port's sharding rules on torch's DeviceMesh against the reference's.

Every parameter leaf and every decode cache leaf of every arch gets the
same per-dimension mesh axes as the reference's ``assign_pspec`` on the
production meshes (16 x 16 and 2 x 16 x 16). The port's meshes are
``DeviceMesh`` objects on a fake process group; the reference's
``assign_pspec`` reads only ``mesh.axis_names`` and ``mesh.devices.shape``,
so it is given a stand-in with those two attributes. Also the reference's
own checks (``tests/test_distributed.py``), the DTensor placements, the
degenerate 1 x 1 mesh and ``shard_batch``.
"""
from __future__ import annotations

import types

import jax
import numpy as np
import pytest
import torch
from torch.distributed.tensor import Replicate, Shard

from repro.configs import ARCHS as REF_ARCHS
from repro.distributed import sharding as ref_sh
from repro.models import Runtime as RefRuntime
from repro.models import abstract_cache as ref_abstract_cache
from repro.models import build_param_specs as ref_specs
from repro.models.params import ParamSpec as RefParamSpec
from repro_torch.configs import ARCHS, SHAPES
from repro_torch.distributed import sharding
from repro_torch.launch.mesh import fake_world, make_production_mesh
from repro_torch.models import Runtime, abstract_cache, build_param_specs
from repro_torch.models.blocks import shard_batch
from repro_torch.models.params import tree_leaves

MESHES = {"16x16": False, "2x16x16": True}


@pytest.fixture(scope="module")
def meshes():
    """name -> (the port's DeviceMesh, the reference's stand-in); each
    fake world is destroyed again after its mesh is built."""
    out = {}
    for name, multi_pod in MESHES.items():
        with fake_world(512 if multi_pod else 256):
            mesh = make_production_mesh(multi_pod=multi_pod)
        stand_in = types.SimpleNamespace(axis_names=mesh.mesh_dim_names,
                                         devices=np.empty(tuple(mesh.shape), dtype=np.int8))
        out[name] = (mesh, stand_in)
    return out


def _ref_leaves(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, RefParamSpec))
    return {tuple(k.key for k in path): leaf for path, leaf in flat}


def _port_leaves(tree, prefix=()):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_port_leaves(tree[k], prefix + (k,)))
        return out
    return {prefix: tree}


@pytest.mark.parametrize("fsdp", [True, False])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_param_specs_match_reference(meshes, arch, mesh_name, fsdp):
    mesh, stand_in = meshes[mesh_name]
    ref_rt, rt = RefRuntime(fsdp=fsdp), Runtime(fsdp=fsdp)
    ref = _ref_leaves(ref_specs(REF_ARCHS[arch], ref_rt))
    port = _port_leaves(build_param_specs(ARCHS[arch], rt))
    assert set(ref) == set(port)
    ref_rules = ref_sh.make_param_rules(ref_rt, stand_in)
    rules = sharding.make_param_rules(rt, mesh)
    assert rules == ref_rules
    got = _port_leaves(sharding.shardings_for_specs(build_param_specs(ARCHS[arch], rt), mesh,
                                                    rules))
    for path, s in ref.items():
        want = tuple(ref_sh.assign_pspec(s.shape, s.axes, stand_in, ref_rules))
        assert port[path].shape == tuple(s.shape) and port[path].axes == tuple(s.axes), path
        assert got[path].spec == want, (path, got[path].spec, want)


@pytest.mark.parametrize("batch_shardable", [True, False])
@pytest.mark.parametrize("mesh_name", list(MESHES))
@pytest.mark.parametrize("shape_name", ["decode_32k", "long_500k"])
@pytest.mark.parametrize("arch", sorted(ARCHS))
def test_cache_specs_match_reference(meshes, arch, shape_name, mesh_name, batch_shardable):
    mesh, stand_in = meshes[mesh_name]
    shape = SHAPES[shape_name]
    enc = shape.seq_len if ARCHS[arch].family == "encdec" else 0
    ref_cache = ref_abstract_cache(REF_ARCHS[arch], RefRuntime(), shape.global_batch,
                                   shape.seq_len, enc_len=enc)
    cache = abstract_cache(ARCHS[arch], Runtime(), shape.global_batch, shape.seq_len, enc_len=enc)
    assert set(cache) == set(ref_cache)
    assert all(v.device.type == "meta" for v in cache.values())
    ref_axes = ref_sh.cache_axes(REF_ARCHS[arch], ref_cache)
    axes = sharding.cache_axes(ARCHS[arch], cache)
    assert axes == ref_axes
    ref_rules = ref_sh.cache_rules(RefRuntime(), stand_in, batch_shardable)
    rules = sharding.cache_rules(Runtime(), mesh, batch_shardable)
    assert rules == ref_rules
    tree = sharding.shardings_for_tree(axes, cache, mesh, rules)
    for k, v in cache.items():
        assert tuple(v.shape) == tuple(ref_cache[k].shape), k
        want = tuple(ref_sh.assign_pspec(ref_cache[k].shape, ref_axes[k], stand_in, ref_rules))
        assert sharding.assign_pspec(v.shape, axes[k], mesh, rules) == want, k
        assert tree[k].spec == want, k


def test_batch_axes_match_reference(meshes):
    for mesh, stand_in in meshes.values():
        assert sharding.batch_axes(mesh) == ref_sh.batch_axes(stand_in)


def test_assign_pspec_divisibility():
    """The reference's check, on a 2-rank model axis."""
    with fake_world(2):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (2,), mesh_dim_names=("model",))
    rules = {"heads": ("model",), "kv_heads": ("model",), None: ()}
    # kv_heads=3 not divisible by mesh size>1 -> None
    assert sharding.assign_pspec((3, 128), ("kv_heads", None), mesh, rules) == ()
    spec2 = sharding.assign_pspec((4, 128), ("heads", None), mesh, rules)
    assert spec2[0] == "model"
    assert sharding.NamedSharding(mesh, spec2).placements == (Shard(0),)


def test_param_rules_cover_model_axes():
    """The reference's check on the 1 x 1 mesh: every leaf gets a sharding,
    and on one device every placement is Replicate."""
    with fake_world(1):
        from torch.distributed.device_mesh import init_device_mesh

        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    from repro_torch.configs import get_arch, reduced

    for cfg in (reduced(get_arch("llama3-8b")), get_arch("llama3-8b")):
        specs = build_param_specs(cfg, Runtime())
        sh = tree_leaves(sharding.shardings_for_specs(specs, mesh,
                                                      sharding.make_param_rules(Runtime(), mesh)))
        assert len(sh) == len(tree_leaves(specs))
        assert all(isinstance(s, sharding.NamedSharding) for s in sh)
        assert all(s.spec == () and s.placements == (Replicate(), Replicate()) for s in sh)


def test_placements_and_shard_count(meshes):
    mesh, _ = meshes["2x16x16"]
    ns = sharding.NamedSharding(mesh, (("pod", "data"), None, "model"))
    assert ns.placements == (Shard(0), Shard(0), Shard(2))
    assert ns.num_shards == 512
    assert sharding.NamedSharding(mesh, ()).placements == (Replicate(),) * 3


def test_spec_shardings_takes_free_axes_without_divisibility(meshes):
    """``params.spec_shardings`` (the reference's): every free candidate
    axis, no divisibility check, trailing Nones kept."""
    from repro_torch.models import ParamSpec, spec_shardings

    mesh, _ = meshes["16x16"]
    specs = {"w": ParamSpec((3, 5, 7), ("heads", "embed", None)),
             "v": ParamSpec((8,), ("vocab",))}
    rules = {"heads": ("model",), "embed": ("data",), "vocab": ("model",), None: ()}
    got = spec_shardings(specs, mesh, rules)
    assert got["w"].spec == ("model", "data", None)
    assert got["v"].spec == ("model",)


def test_activation_spec_and_shard_batch(meshes):
    mesh, _ = meshes["16x16"]
    assert sharding.activation_spec((32, 4096, 8), mesh, seq_shard=False) == ("data", None, None)
    assert sharding.activation_spec((32, 4096, 8), mesh, seq_shard=True) == ("data", "model", None)
    assert sharding.activation_spec((1, 4096, 8), mesh, seq_shard=True) == (None, "model", None)
    mp, _ = meshes["2x16x16"]
    assert sharding.activation_spec((64, 8, 8), mp, seq_shard=False) == (("pod", "data"), None,
                                                                          None)
    x = torch.zeros(32, 64, 4)
    seen = []
    rt = Runtime(seq_shard=True)
    # no mesh: the identity, nobody told
    assert shard_batch(x, rt) is x
    with sharding.use_mesh(mesh, on_place=lambda t, spec: seen.append((t, spec))):
        assert shard_batch(x, rt) is x
        assert shard_batch(x, Runtime(act_shard=False)) is x
    assert len(seen) == 1 and seen[0][0] is x and seen[0][1] == ("data", "model", None)
    assert sharding.current_mesh() is None


def test_shard_batch_is_identity_on_one_rank():
    from repro_torch.launch.mesh import single_card_mesh

    x = torch.randn(4, 8, 2)
    told = []
    with single_card_mesh("cpu") as mesh, sharding.use_mesh(mesh, on_place=told.append):
        assert mesh.size() == 1
        assert shard_batch(x, Runtime(seq_shard=True)) is x
    assert not told


def test_dp_size_inferred_and_checked(meshes):
    mesh, _ = meshes["2x16x16"]
    assert sharding.dp_size(Runtime(), mesh) == 32
    assert sharding.dp_size(Runtime(dp_size=32), mesh) == 32
    with pytest.raises(ValueError):
        sharding.dp_size(Runtime(dp_size=16), mesh)
