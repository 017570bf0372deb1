"""Weights drawn from the seed on the device, by the benchmark's own code.

The port's spec tree (``build_param_specs``) gives each leaf's shape,
dtype and initial rule. Every random leaf of one dtype is a view into one
flat buffer that a ``torch.Generator`` on the device fills with standard
normals in a few large calls, in the dtype the leaf is served in; each leaf
is then scaled in place by its rule (0.02 for ``normal``, 1/sqrt(fan_in)
for ``scaled``), unless the configuration's ``init`` names another scale
for the leaf's key:

- ``["normal", std]``: that standard deviation;
- ``["scaled", fan_in]``: 1/sqrt(fan_in), where the leaf's true fan-in is
  more than its spec's ``fan_in_axis`` holds.

Leaves start on 128-byte boundaries. ``ones`` and ``zeros`` leaves are
filled.

The same seed gives the same tensors on the same device.
"""

from __future__ import annotations

import hashlib
import math
from typing import Any, Dict, List, Tuple

import torch

_ALIGN = 128          # bytes
_CHUNK = 1 << 30      # elements a generator call fills


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one stream (``"weights"``, ``"traffic"``, ...) of a
    run's seed."""
    return int.from_bytes(hashlib.sha256(f"{seed}:{tag}".encode()).digest()[:8], "little") >> 1


def _scale(spec, rule=None) -> float:
    if rule is not None:
        return float(rule[1]) if rule[0] == "normal" else 1.0 / math.sqrt(float(rule[1]))
    if spec.init == "scaled":
        fan_in = spec.shape[spec.fan_in_axis] if len(spec.shape) >= 2 else spec.shape[-1]
        return 1.0 / math.sqrt(max(fan_in, 1))
    return 0.02


def _walk(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _walk(tree[k], path + (k,))
    else:
        yield path, tree


def _set(tree: Dict[str, Any], path: Tuple[str, ...], value) -> None:
    for k in path[:-1]:
        tree = tree.setdefault(k, {})
    tree[path[-1]] = value


def draw(specs, seed: int, device, init: Dict[str, list] = None) -> Dict[str, Any]:
    """The parameter tree of ``specs`` drawn from ``seed`` on ``device``."""
    init = init or {}
    gen = torch.Generator(device=device).manual_seed(sub_seed(seed, "weights"))
    out: Dict[str, Any] = {}
    random: Dict[torch.dtype, List[Tuple[tuple, Any, int, Any]]] = {}
    for path, s in _walk(specs):
        if s.init in ("ones", "zeros"):
            fill = torch.ones if s.init == "ones" else torch.zeros
            _set(out, path, fill(s.shape, dtype=s.dtype, device=device))
        else:
            random.setdefault(s.dtype, []).append((path, s, math.prod(s.shape),
                                                   init.get(path[-1])))
    for dtype, leaves in random.items():
        align = _ALIGN // torch.empty((), dtype=dtype).element_size()
        offsets, total = [], 0
        for _, _, n, _ in leaves:
            offsets.append(total)
            total += -(-n // align) * align
        flat = torch.empty(total, dtype=dtype, device=device)
        for c0 in range(0, total, _CHUNK):
            flat[c0:c0 + _CHUNK].normal_(generator=gen)
        for (path, s, n, rule), off in zip(leaves, offsets):
            leaf = flat[off:off + n].view(s.shape)
            leaf.mul_(_scale(s, rule))
            _set(out, path, leaf)
    return out
