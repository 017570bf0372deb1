"""The control: the reference with every product's operands rounded to fp8
(e4m3, one scale a row of the left operand and a column of the right one,
as fp8 tensor-core GEMMs take them) and float32 sums: the nearest precision
below the bfloat16 that the configuration states."""

from __future__ import annotations

import torch

from .common import Numerics

_E4M3_MAX = 448.0


def fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to e4m3 with one scale per slice along ``dim``."""
    amax = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30)
    scale = amax / _E4M3_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


class Fp8(Numerics):
    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        return fp8(x.float(), -1) @ fp8(w.float(), -2)

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return fp8(a, -1) @ fp8(b, -2)
