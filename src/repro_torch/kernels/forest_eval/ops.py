"""Dispatch for packed-forest evaluation (kernel K1).

``forest_eval`` returns per-tree leaf stats, each (n_trees, n_points), for
a packed node arena (see ``repro_torch.core.surrogate.PackedForest``).
Tensors on the card launch the CUDA kernel ``csrc/forest_eval.cu``;
tensors on the CPU take the plain version in ``ref.py``. There is no other
route: a CUDA tensor never reaches the plain version.

The reference pads arenas and pools to power-of-two buckets to bound
XLA's compile cache; an eager port compiles nothing per shape, so the
arena and the pool go to the kernel as they are.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch
from .ref import forest_eval_plain

__all__ = ["forest_eval", "forest_eval_cuda", "forest_eval_plain"]

_MAX_TREES = 65535  # gridDim.y


def forest_eval_cuda(feat, thr, child, mean, var, roots, X, depth: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K1 on the card; all tensors on one CUDA device."""
    dev = X.device
    n_nodes = feat.shape[0]
    T = roots.shape[0]
    N, D = X.shape
    if T > _MAX_TREES:
        raise ValueError(f"forest_eval: {T} trees > {_MAX_TREES}")
    check("feat", feat, torch.int64, (n_nodes,), dev)
    check("thr", thr, torch.float64, (n_nodes,), dev)
    check("child", child, torch.int64, (2 * n_nodes,), dev)
    check("mean", mean, torch.float64, (n_nodes,), dev)
    check("var", var, torch.float64, (n_nodes,), dev)
    check("roots", roots, torch.int64, (T,), dev)
    check("X", X, torch.float64, (N, D), dev)
    m_out = torch.empty((T, N), dtype=torch.float64, device=dev)
    v_out = torch.empty((T, N), dtype=torch.float64, device=dev)
    launch("forest_eval", "forest_eval_launch", dev,
           (feat, thr, child, mean, var, roots, X, m_out, v_out),
           (T, N, D, int(depth)))
    return m_out, v_out


def forest_eval(feat, thr, child, mean, var, roots, X, depth: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-tree (mean, var) over the packed arena, each (n_trees, n_points)."""
    if X.device.type == "cuda":
        return forest_eval_cuda(feat, thr, child, mean, var, roots, X, depth)
    if X.device.type != "cpu":
        raise ValueError(f"forest_eval: unsupported device {X.device}")
    PLAIN_CALLS["forest_eval"] += 1
    return forest_eval_plain(feat, thr, child, mean, var, roots, X, depth)
