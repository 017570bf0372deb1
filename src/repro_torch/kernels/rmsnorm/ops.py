"""Dispatch for the fused RMSNorm: the forward K10 and the backward K11.

``rmsnorm(x, w, eps)`` normalises the last axis of x (any leading shape)
through a ``torch.autograd.Function``, as the reference's ``rmsnorm/ops.py``
does through a ``jax.custom_vjp``: the forward runs K10 and keeps x, w and
rstd; the backward runs K11 for dx (in x's dtype) and the float32 dw
partials, and sums the partials outside the kernel, cast to w's dtype.
``rmsnorm_fwd`` and ``rmsnorm_bwd`` work on rows, x (N, D). Tensors on
the card launch the CUDA kernels (``csrc/rmsnorm.cu``); tensors on the CPU
take the plain versions in ``ref.py``, so the CPU runs the backward formula
that the card runs. There is no other route: a CUDA tensor never reaches a
plain version, and a build or launch failure raises.

K10 has two layouts on the card, picked by :func:`rmsnorm_fwd_route`:
``resident`` (D a multiple of 8 up to ``RESIDENT_MAX_D`` of x's dtype,
16-byte aligned rows) holds each row in registers in a persistent grid, so
it reads the row once; ``two_pass`` (any other row) is the first port's
design, which reads it twice. Both write the same out and rstd.

K11 has two layouts on the card, picked by :func:`rmsnorm_bwd_route`:
``cluster`` (D <= 8192, every model of the repo) splits each 128-row tile's
columns over a thread-block cluster of up to 8 blocks that exchange the row
sums through distributed shared memory; ``tile`` (wider rows) is the first
port's one block a tile. Both write the same dx and dw partials.

Both kernels are reductions over a row, and are written in CUDA C++ rather
than Triton: the port's other kernels are CUDA, and neither Triton nor a
GPU exists where the port's CPU tests run, so a Triton kernel would add a
second toolchain that only the card ever compiles.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch
from .ref import ROWS, rmsnorm_bwd_plain, rmsnorm_fwd_plain

__all__ = [
    "BWD_ROUTES", "FWD_ROUTES", "RESIDENT_MAX_D", "rmsnorm", "rmsnorm_bwd", "rmsnorm_bwd_cuda",
    "rmsnorm_bwd_plain", "rmsnorm_bwd_route", "rmsnorm_fwd", "rmsnorm_fwd_cuda",
    "rmsnorm_fwd_plain", "rmsnorm_fwd_route",
]

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# K10's routes -> the prefix of their C entry points
FWD_ROUTES = {"resident": "rmsnorm_fwd", "two_pass": "rmsnorm_fwd_two_pass"}
# the widest row K10's resident route holds in registers: 32 lanes of 32
# 16-byte vectors in bf16, of 16 pairs of them in float32
RESIDENT_MAX_D = {torch.bfloat16: 8192, torch.float32: 4096}
# K11's routes -> the prefix of their C entry points
BWD_ROUTES = {"cluster": "rmsnorm_bwd", "tile": "rmsnorm_bwd_tile"}
CLUSTER_MAX_D = 8 * 1024   # 8 blocks (the portable cluster size) of at most 1024 columns


def rmsnorm_fwd_route(dtype: torch.dtype, D: int, aligned: bool) -> str:
    """K10's layout for rows of D columns of ``dtype``; ``aligned``: x starts
    on a 16-byte boundary."""
    if aligned and D % 8 == 0 and 0 < D <= RESIDENT_MAX_D[dtype]:
        return "resident"
    return "two_pass"


def rmsnorm_bwd_route(D: int) -> str:
    """K11's layout for rows of D columns."""
    return "cluster" if D <= CLUSTER_MAX_D else "tile"


def _check(name: str, x: torch.Tensor, w: torch.Tensor) -> Tuple[int, int]:
    """Raise unless x (N, D) and w (D,) are contiguous bfloat16 or float32
    tensors on one device; returns (N, D). Both routes take the same."""
    if x.dim() != 2 or w.dim() != 1:
        raise ValueError(f"{name}: x must be (N, D) and w (D,), got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    for t in (x, w):
        if t.dtype not in _DTYPES:
            raise TypeError(f"{name}: dtype {t.dtype} not supported (bfloat16, float32)")
    N, D = x.shape
    if D <= 0:
        raise ValueError(f"{name}: rows of width {D}")
    check("x", x, x.dtype, (N, D), x.device)
    check("w", w, w.dtype, (D,), x.device)
    return N, D


def _symbol(name: str, x: torch.Tensor, w: torch.Tensor) -> str:
    return f"{name}_{_DTYPES[x.dtype]}_{_DTYPES[w.dtype]}"


def rmsnorm_fwd_cuda(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5,
                     route: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K10 on the card: x (N, D), w (D,) -> (out in x's dtype, rstd
    (N,) float32); by :func:`rmsnorm_fwd_route`'s layout, or ``route`` where
    the caller names one (the tests and the smoke's timings)."""
    N, D = _check("rmsnorm_fwd", x, w)
    aligned = x.data_ptr() % 16 == 0
    fits = rmsnorm_fwd_route(x.dtype, D, aligned)
    route = route or fits
    if route not in FWD_ROUTES or (route == "resident" and fits != route):
        raise ValueError(f"rmsnorm_fwd: route {route!r} does not take D = {D} of {x.dtype} "
                         f"(aligned: {aligned})")
    out = torch.empty_like(x)
    rstd = torch.empty((N,), dtype=torch.float32, device=x.device)
    launch("rmsnorm_fwd", _symbol(FWD_ROUTES[route], x, w), x.device, (x, w, out, rstd),
           (N, D), source="rmsnorm", floats=(eps,), route=route)
    return out, rstd


def _check_bwd(x, w, rstd, do) -> Tuple[int, int]:
    N, D = _check("rmsnorm_bwd", x, w)
    check("rstd", rstd, torch.float32, (N,), x.device)
    check("do", do, x.dtype, (N, D), x.device)
    return N, D


def rmsnorm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor, do: torch.Tensor,
                     route: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K11 on the card: x, do (N, D) of one dtype, w (D,), rstd (N,)
    float32 -> (dx in x's dtype, dw partials (ceil(N / 128), D) float32); by
    :func:`rmsnorm_bwd_route`'s layout, or ``route`` where the caller names
    one (the tests and the smoke's timings)."""
    N, D = _check_bwd(x, w, rstd, do)
    route = route or rmsnorm_bwd_route(D)
    if route not in BWD_ROUTES or (route == "cluster" and D > CLUSTER_MAX_D):
        raise ValueError(f"rmsnorm_bwd: route {route!r} does not take D = {D}")
    dx = torch.empty_like(x)
    parts = torch.empty((-(-N // ROWS), D), dtype=torch.float32, device=x.device)
    launch("rmsnorm_bwd", _symbol(BWD_ROUTES[route], x, w), x.device,
           (x, w, rstd, do, dx, parts), (N, D), source="rmsnorm", route=route)
    return dx, parts


def _on_cpu(name: str, x: torch.Tensor) -> bool:
    if x.device.type == "cuda":
        return False
    if x.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {x.device}")
    return True


def rmsnorm_fwd(x: torch.Tensor, w: torch.Tensor,
                eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """(out, rstd) of rows x (N, D): K10 on the card, the plain version
    (counted) on the CPU."""
    if not _on_cpu("rmsnorm_fwd", x):
        return rmsnorm_fwd_cuda(x, w, eps)
    _check("rmsnorm_fwd", x, w)
    PLAIN_CALLS["rmsnorm_fwd"] += 1
    return rmsnorm_fwd_plain(x, w, eps)


def rmsnorm_bwd(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                do: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dx, dw partials) of rows x (N, D): K11 on the card, the plain
    version (counted) on the CPU."""
    if not _on_cpu("rmsnorm_bwd", x):
        return rmsnorm_bwd_cuda(x, w, rstd, do)
    _check_bwd(x, w, rstd, do)
    PLAIN_CALLS["rmsnorm_bwd"] += 1
    return rmsnorm_bwd_plain(x, w, rstd, do)


class _RMSNorm(torch.autograd.Function):
    """out = rmsnorm(x, w) on rows x (N, D); the reference's ``_rmsnorm``
    custom VJP."""

    @staticmethod
    def forward(ctx, x, w, eps):
        out, rstd = rmsnorm_fwd(x, w, eps)
        ctx.save_for_backward(x, w, rstd)
        return out

    @staticmethod
    def backward(ctx, do):
        x, w, rstd = ctx.saved_tensors
        dx, parts = rmsnorm_bwd(x, w, rstd, do.contiguous())
        return dx, parts.sum(dim=0).to(w.dtype), None


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """x (..., D), w (D,) -> RMSNorm of x's last axis in x's dtype,
    differentiable in x and w."""
    shape = x.shape
    out = _RMSNorm.apply(x.reshape(-1, shape[-1]).contiguous(), w.contiguous(), float(eps))
    return out.reshape(shape)
