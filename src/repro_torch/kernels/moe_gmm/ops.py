"""Dispatch for the grouped expert matmul (kernel K9).

``grouped_matmul(x, w, group_sizes=None)`` is the reference's
``moe_gmm/ops.py`` entry point: x (E, C, D) dispatched tokens, w (E, D, F)
stacked expert weights -> (E, C, F) in x's dtype, summed in float32, rows
``c >= group_sizes[e]`` set to 0 (``None``: every row is valid). Tensors on
the card launch the CUDA kernel (``csrc/moe_gmm.cu``); tensors on the CPU
take the plain version in ``ref.py``. There is no other route: a CUDA
tensor never reaches the plain version, and a build or launch failure
raises.

The reference halves its Pallas blocks (128 rows, 128 columns, 512-deep
slabs) until they divide C, F and D; the CUDA kernel masks its ragged
edges instead, so any C, D and F are taken.
"""

from __future__ import annotations

from typing import Optional

import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch
from .ref import gmm_plain

__all__ = ["grouped_matmul", "gmm_cuda", "gmm_plain"]

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_GRID = 65535  # gridDim.y (column tiles of 64 at the least) and gridDim.z (experts)


def _check(x: torch.Tensor, w: torch.Tensor, group_sizes: Optional[torch.Tensor]) -> tuple:
    """Raise unless x (E, C, D) and w (E, D, F) are of one dtype (bfloat16
    or float32), contiguous, on one device, with group_sizes an int32 (E,)
    tensor there or None; returns (E, C, D, F). Both routes take the same."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"moe_gmm: x and w must be 3-d, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    E, C, D = x.shape
    F = w.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"moe_gmm: dtype {x.dtype} not supported (bfloat16, float32)")
    if E > _MAX_GRID or (F + 63) // 64 > _MAX_GRID:
        raise ValueError(f"moe_gmm: {E} experts or {F} columns past the grid's limits")
    check("x", x, x.dtype, (E, C, D), x.device)
    check("w", w, x.dtype, (E, D, F), x.device)
    if group_sizes is not None:
        check("group_sizes", group_sizes, torch.int32, (E,), x.device)
    return E, C, D, F


def gmm_cuda(x: torch.Tensor, w: torch.Tensor,
             group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Launch K9 on the card (arguments as :func:`_check` takes them)."""
    E, C, D, F = _check(x, w, group_sizes)
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    launch("moe_gmm", f"moe_gmm_{_DTYPES[x.dtype]}", x.device, (x, w, group_sizes, out),
           (E, C, D, F))
    return out


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, D), w (E, D, F) -> (E, C, F): K9 on the card, the plain
    version (counted) on the CPU. group_sizes may be any integer tensor; it
    is moved to x's device as int32."""
    if group_sizes is not None:
        group_sizes = group_sizes.to(device=x.device, dtype=torch.int32).contiguous()
    if x.device.type == "cuda":
        return gmm_cuda(x, w, group_sizes)
    if x.device.type != "cpu":
        raise ValueError(f"moe_gmm: unsupported device {x.device}")
    _check(x, w, group_sizes)
    PLAIN_CALLS["moe_gmm"] += 1
    return gmm_plain(x, w, group_sizes)
