"""Logical-axis -> mesh-axis sharding assignment on torch's ``DeviceMesh``.

The reference's ``distributed/sharding.py``, ported. Rules map logical axis
names to an ordered tuple of candidate mesh axes. ``assign_pspec`` walks a
shape left to right and gives each dimension the first candidate axis (or
axis group) that (a) is present in the mesh, (b) has not been used by an
earlier dimension of the same tensor, and (c) divides the dimension evenly.
This one function places every tensor of a step (parameters, optimizer
states, activations, caches), so the tensor-, data-, expert- and
sequence-parallel layouts stay consistent.

Default layout:
  model axis: TP (heads / mlp / experts / vocab / ssm_inner)
  data axes (pod, data): batch DP + FSDP parameter sharding (ZeRO-3) +
  sequence sharding for long-context caches whose batch cannot split.

The reference's ``PartitionSpec`` is a tuple here: one entry per dimension,
each a mesh-axis name, a tuple of names (an axis group) or ``None``, with
trailing ``None`` entries dropped as the reference drops them. A
:class:`NamedSharding` pairs that tuple with its mesh and gives the DTensor
placements (``Shard(d)`` / ``Replicate()`` per mesh dimension). On one card
the mesh is 1 x 1 and every placement is ``Replicate``: no axis of size 1
is ever chosen.

A mesh here is anything with ``mesh_dim_names`` and ``shape`` (a
``DeviceMesh``). ``use_mesh`` makes one the current mesh of a block of
code, the counterpart of the reference's ``jax.set_mesh``; ``place`` is the
activation placement that ``models.blocks.shard_batch`` asks for.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Iterator, Optional, Sequence, Tuple, Union

import torch

from ..configs.base import ArchConfig
from ..models.params import tree_map
from ..models.runtime import Runtime

__all__ = [
    "NamedSharding", "Rules", "Spec", "activation_spec", "assign_pspec", "batch_axes",
    "cache_axes", "cache_rules", "current_mesh", "dp_size", "make_param_rules", "mesh_sizes",
    "place", "shardings_for_specs", "shardings_for_tree", "use_mesh",
]

Rules = Dict[Optional[str], Tuple[str, ...]]
Entry = Union[None, str, Tuple[str, ...]]
Spec = Tuple[Entry, ...]


def mesh_sizes(mesh) -> Dict[str, int]:
    """Axis name -> size, in the mesh's order."""
    return dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))


def _data_axes(mesh) -> Tuple[str, ...]:
    names = mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def make_param_rules(rt: Runtime, mesh) -> Rules:
    d = _data_axes(mesh)
    return {
        "vocab": ("model",),
        "heads": ("model",),
        "kv_heads": ("model",),
        "mlp": ("model",),
        "experts": ("model",),
        # fallback TP for MoE weights whose expert count can't divide the
        # model axis (e.g. 8 experts on model=16): shard the FFN width
        "expert_mlp": ("model",),
        "ssm_inner": ("model",),
        "rank": (),
        "qk": (),
        "layers": (),
        "embed": d if rt.fsdp else (),
        None: (),
    }


def batch_axes(mesh) -> Tuple[str, ...]:
    return _data_axes(mesh)


def dp_size(rt: Runtime, mesh) -> int:
    """The data-parallel degree: the product of the mesh's batch axes.
    ``Runtime.dp_size`` (None: inferred) must agree with the mesh."""
    sizes = mesh_sizes(mesh)
    n = math.prod(sizes[a] for a in batch_axes(mesh))
    if rt.dp_size is not None and rt.dp_size != n:
        raise ValueError(f"Runtime.dp_size={rt.dp_size}, but the mesh's batch axes "
                         f"{batch_axes(mesh)} give {n}")
    return n


def assign_pspec(shape: Sequence[int], axes: Sequence[Optional[str]], mesh, rules: Rules) -> Spec:
    sizes = mesh_sizes(mesh)
    used: set = set()
    parts: list = []
    for dim, ax in zip(shape, axes):
        cands = rules.get(ax, ())
        if isinstance(cands, str):
            cands = (cands,)
        chosen: Tuple[str, ...] = ()
        # try the full candidate group first (e.g. ("pod","data")), then singles
        groups = [tuple(cands)] + [(c,) for c in cands] if len(cands) > 1 else [tuple(cands)]
        for grp in groups:
            grp = tuple(a for a in grp if a in sizes and a not in used)
            if not grp:
                continue
            total = math.prod(sizes[a] for a in grp)
            if total > 1 and dim % total == 0:
                chosen = grp
                break
        if chosen:
            used.update(chosen)
            parts.append(chosen if len(chosen) > 1 else chosen[0])
        else:
            parts.append(None)
    while parts and parts[-1] is None:
        parts.pop()
    return tuple(parts)


def _entry_axes(entry: Entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


@dataclass(frozen=True)
class NamedSharding:
    """A spec tuple on a mesh: the reference's ``NamedSharding``."""

    mesh: Any
    spec: Spec

    def axes(self) -> Tuple[str, ...]:
        """Every mesh axis the spec shards some dimension over."""
        return tuple(a for e in self.spec for a in _entry_axes(e))

    @property
    def placements(self) -> tuple:
        """DTensor placements, one per mesh dimension: ``Shard(d)`` where
        dimension d of the tensor is split over that mesh axis."""
        from torch.distributed.tensor import Replicate, Shard

        dim_of = {a: d for d, e in enumerate(self.spec) for a in _entry_axes(e)}
        return tuple(Shard(dim_of[a]) if a in dim_of else Replicate()
                     for a in self.mesh.mesh_dim_names)

    @property
    def num_shards(self) -> int:
        sizes = mesh_sizes(self.mesh)
        return math.prod(sizes[a] for a in self.axes())


def shardings_for_specs(specs, mesh, rules: Rules):
    """ParamSpec tree -> NamedSharding tree."""
    return tree_map(lambda s: NamedSharding(mesh, assign_pspec(s.shape, s.axes, mesh, rules)),
                    specs)


def _is_axes(x) -> bool:
    return isinstance(x, tuple) and all(a is None or isinstance(a, str) for a in x)


def shardings_for_tree(tree_axes, tree_shapes, mesh, rules: Rules):
    """Parallel trees of axis-tuples and shaped leaves -> NamedSharding tree."""
    if _is_axes(tree_axes):
        return NamedSharding(mesh, assign_pspec(tree_shapes.shape, tree_axes, mesh, rules))
    return {k: shardings_for_tree(tree_axes[k], tree_shapes[k], mesh, rules)
            for k in sorted(tree_axes)}


# ------------------------------------------------------------------- caches


_CACHE_AXES = {
    # (L, B, S, Hkv, hd)
    "k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "attn_k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "attn_v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "enc_k": ("layers", "batch", "kv_seq", "kv_heads", None),
    "enc_v": ("layers", "batch", "kv_seq", "kv_heads", None),
    "c_kv": ("layers", "batch", "kv_seq", None),
    "k_rope": ("layers", "batch", "kv_seq", None),
    "ssm": ("layers", "batch", "heads", None, None),
    "conv": ("layers", "batch", None, "ssm_inner"),
    "wkv": ("layers", "batch", "heads", None, None),
    "shift1": ("layers", "batch", None, "embed_act"),
    "shift2": ("layers", "batch", None, "embed_act"),
    "pos": ("batch",),
}


def cache_axes(cfg: ArchConfig, cache) -> Dict[str, tuple]:
    """Logical axes for each cache leaf (a dict parallel to ``init_cache``'s)."""
    return {k: _CACHE_AXES[k][:len(v.shape)] for k, v in cache.items()}


def cache_rules(rt: Runtime, mesh, batch_shardable: bool) -> Rules:
    d = _data_axes(mesh)
    return {
        "layers": (),
        "batch": d if batch_shardable else (),
        # KV sequence takes the model axis (ring-decode layout: each model
        # shard holds a slice of the context; softmax reduces across shards).
        # Essential when kv_heads < model-axis size: head sharding can't
        # divide, and a replicated 32k cache is tens of GB a device. When the
        # batch can't shard either (long-context B=1), sequence absorbs the
        # data axes too.
        "kv_seq": ("model",) if batch_shardable else d + ("model",),
        "kv_heads": ("model",),
        "heads": ("model",),
        "ssm_inner": ("model",),
        "embed_act": (),
        None: (),
    }


# -------------------------------------------------------- activations


_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh, on_place: Optional[Callable[[torch.Tensor, Spec], None]] = None
             ) -> Iterator[Any]:
    """Make ``mesh`` the current mesh inside the block. ``on_place(x, spec)``
    is told of every activation placement made there; the step-cost walker
    listens so."""
    token = _MESH.set((mesh, on_place))
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    cur = _MESH.get()
    return None if cur is None else cur[0]


def activation_spec(shape: Sequence[int], mesh, seq_shard: bool, seq_dim: int = 1) -> Spec:
    """The reference's ``shard_batch`` layout: the batch over the data axes
    where it divides, and with ``seq_shard`` dimension ``seq_dim`` over the
    model axis where it divides."""
    sizes = mesh_sizes(mesh)
    axes = _data_axes(mesh)
    spec: list = [None] * len(shape)
    total = math.prod(sizes[a] for a in axes)
    if axes and shape[0] % total == 0 and shape[0] >= total:
        spec[0] = axes if len(axes) > 1 else axes[0]
    if (seq_shard and "model" in sizes and len(shape) >= 3
            and shape[seq_dim] % sizes["model"] == 0):
        spec[seq_dim] = "model"
    return tuple(spec)


def place(x: torch.Tensor, spec: Spec) -> torch.Tensor:
    """Give activation ``x`` the placement ``spec`` on the current mesh: the
    mesh's listener (the step-cost walker's) is told, and ``x`` returned as
    it is. No step of the port runs on DTensors, so there is no data to
    move."""
    cur = _MESH.get()
    if cur is not None and cur[1] is not None:
        cur[1](x, spec)
    return x
