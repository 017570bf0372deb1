"""Parameter specification trees.

Model code declares parameters as ``ParamSpec`` leaves (shape + dtype +
*logical axis names*) in nested dicts, as the reference does; a parameter
tree is the same nested dict with tensors at the leaves. One spec tree
serves three consumers:

  * ``abstract_params``  -> tensors on the ``meta`` device (the dry-run:
                            shapes and dtypes, no allocation)
  * ``init_params``      -> real tensors from a seeded ``torch.Generator``
  * ``spec_shardings``   -> a ``NamedSharding`` tree through the
                            logical -> mesh rules of ``distributed/sharding.py``

Logical axis vocabulary: "layers" (stacked blocks), "embed" (d_model),
"vocab", "heads", "kv_heads", "qk" (per-head q/k dims), "mlp" (d_ff),
"experts", "expert_mlp", "ssm_inner", "state", "conv", "rank" (low-rank),
None.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Dict, Optional, Tuple

import torch

from ..device import DeviceLike, resolve_device

__all__ = ["ParamSpec", "abstract_params", "init_params", "param_bytes", "spec_shardings",
           "tree_leaves", "tree_map"]


@dataclass(frozen=True)
class ParamSpec:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    dtype: torch.dtype = torch.bfloat16
    init: str = "normal"       # normal | zeros | ones | scaled (1/sqrt(fan_in))
    fan_in_axis: int = -2

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} and axes {self.axes} differ in rank")


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` applied to every leaf of a nested dict, keys in sorted order
    (the order in which ``jax.tree`` flattens a dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def abstract_params(specs) -> Any:
    """The parameter tree on the ``meta`` device: every leaf's shape and
    dtype, no storage."""
    return tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype, device="meta"), specs)


def spec_shardings(specs, mesh, rules: Dict[Optional[str], Any]) -> Any:
    """Map logical axes -> ``NamedSharding`` using ``rules``: the reference's
    ``spec_shardings``, which, unlike ``sharding.assign_pspec``, takes every
    free candidate axis with no divisibility check and keeps trailing
    ``None`` entries."""
    from ..distributed.sharding import NamedSharding

    def one(s: ParamSpec):
        used: set = set()
        parts: list = []
        for ax in s.axes:
            mesh_axes = rules.get(ax)
            if mesh_axes is None:
                parts.append(None)
                continue
            if isinstance(mesh_axes, str):
                mesh_axes = (mesh_axes,)
            free = tuple(a for a in mesh_axes if a not in used and a in mesh.mesh_dim_names)
            if not free:
                parts.append(None)
                continue
            used.update(free)
            parts.append(free if len(free) > 1 else free[0])
        return NamedSharding(mesh, tuple(parts))

    return tree_map(one, specs)


def _scale(s: ParamSpec) -> float:
    fan_in = s.shape[s.fan_in_axis] if len(s.shape) >= 2 else s.shape[-1]
    return 1.0 / math.sqrt(max(fan_in, 1)) if s.init == "scaled" else 0.02


def init_params(specs, generator: torch.Generator, device: DeviceLike = None) -> Any:
    """Real tensors for a spec tree, by the reference's rules: ``zeros``,
    ``ones``, else a float32 standard normal times 0.02 (``normal``) or
    1/sqrt(fan_in) (``scaled``), cast to the leaf's dtype.

    Draws come from ``generator``, which must live on ``device``, leaf by
    leaf in sorted-key order; a leaf stacked over "layers" is drawn one
    layer slice at a time, so the float32 draw buffer stays one slice.
    JAX's and torch's generators give different numbers from one seed: to
    feed both packages the same weights, convert the reference's tree with
    :func:`repro_torch.convert.lm_params_from_numpy`.
    """
    dev = resolve_device(device)

    def one(s: ParamSpec) -> torch.Tensor:
        dt = s.dtype
        if s.init == "zeros":
            return torch.zeros(s.shape, dtype=dt, device=dev)
        if s.init == "ones":
            return torch.ones(s.shape, dtype=dt, device=dev)
        scale = _scale(s)
        out = torch.empty(s.shape, dtype=dt, device=dev)
        slices = out if (s.axes and s.axes[0] == "layers") else out[None]
        for sl in slices:
            draw = torch.randn(sl.shape, generator=generator, dtype=torch.float32, device=dev)
            sl.copy_(draw.mul_(scale))
        return out

    return tree_map(one, specs)


def param_bytes(specs) -> int:
    return sum(math.prod(s.shape) * torch.empty((), dtype=s.dtype).element_size()
               for s in tree_leaves(specs))
