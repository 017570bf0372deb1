"""numpy's reduction order, replayed with torch ops.

The reference's contract is bit-identity with numpy, and a float sum's bits
depend on the order of its adds. numpy's ``add.reduce`` starts from +0.0
and then

* over an axis that is the inner loop (the contiguous axis, or any axis
  whose other extents are all 1) adds by pairwise summation: blocks of up
  to 128 elements summed in 8 interleaved accumulators, larger runs split
  in halves rounded to a multiple of 8;
* over an outer axis adds the slices one after another.

``torch.sum`` uses other orders on the CPU and on the card, so the port's
reductions on the tuner path go through these helpers, which are plain
elementwise adds in numpy's order. Division by a constant goes through
:func:`div_scalar`: the CUDA division kernel turns a division by a host
scalar into a multiplication by its rounded reciprocal. Square roots go
through :func:`sqrt`: torch's CPU ``sqrt`` (MKL's vector math) is not
correctly rounded in float64, while IEEE ``sqrt`` (numpy's, CUDA's) is.
"""

from __future__ import annotations

import numpy as np
import torch

__all__ = ["pairwise_sum", "sequential_sum", "reduce_sum", "div_scalar", "sqrt"]


def sqrt(x: torch.Tensor) -> torch.Tensor:
    """Correctly rounded float64 square root on every device: CUDA's
    ``sqrt`` on the card, numpy's on the host."""
    if x.device.type == "cpu":
        return torch.from_numpy(np.sqrt(x.contiguous().numpy()))
    return torch.sqrt(x)


def div_scalar(x: torch.Tensor, c: float) -> torch.Tensor:
    """``x / c`` as an IEEE division on every device."""
    return x / torch.full((), float(c), dtype=x.dtype, device=x.device)


def sequential_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy's sum over an outer axis: +0.0, then each slice in order."""
    acc = x.select(dim, 0) + 0.0
    for i in range(1, x.shape[dim]):
        acc = acc + x.select(dim, i)
    return acc


def _pairwise(x: torch.Tensor, dim: int, start: int, n: int) -> torch.Tensor:
    if n < 8:
        acc = x.select(dim, start)
        for i in range(1, n):
            acc = acc + x.select(dim, start + i)
        return acc
    if n <= 128:
        r = [x.select(dim, start + j) for j in range(8)]
        i = 8
        stop = n - (n % 8)
        while i < stop:
            for j in range(8):
                r[j] = r[j] + x.select(dim, start + i + j)
            i += 8
        res = ((r[0] + r[1]) + (r[2] + r[3])) + ((r[4] + r[5]) + (r[6] + r[7]))
        for k in range(i, n):
            res = res + x.select(dim, start + k)
        return res
    n2 = n // 2
    n2 -= n2 % 8
    return _pairwise(x, dim, start, n2) + _pairwise(x, dim, start + n2, n - n2)


def pairwise_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy's sum over an inner-loop axis (pairwise summation)."""
    return _pairwise(x, dim, 0, x.shape[dim]) + 0.0


def reduce_sum(x: torch.Tensor, dim: int) -> torch.Tensor:
    """numpy's ``x.sum(axis=dim)`` for a C-contiguous array: pairwise when
    every axis after ``dim`` has extent 1 (the reduced axis is then the
    inner loop), else slice by slice."""
    dim = dim % x.dim()
    if all(s == 1 for s in x.shape[dim + 1:]):
        return pairwise_sum(x, dim)
    return sequential_sum(x, dim)
