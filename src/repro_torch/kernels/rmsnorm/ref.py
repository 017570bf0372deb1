"""Plain PyTorch versions of the fused RMSNorm (kernels K10 and K11).

``rmsnorm_fwd_plain`` computes what the reference's ``_fwd_kernel``
(``rmsnorm/kernel.py``) computes for x (N, D): in float32, rstd =
rsqrt(mean(x^2) + eps) per row and out = x * rstd * w, returned in x's
dtype beside rstd (N,) in float32. ``rmsnorm_bwd_plain`` computes what
``_bwd_kernel`` computes, in the order of its body: xhat = x * rstd,
dxhat = do * w, dx = rstd * (dxhat - xhat * mean(dxhat * xhat)) in x's
dtype, and one float32 dw partial row, the sum of do * xhat, for each tile
of ``ROWS`` rows (the last tile may be short). The reference halves its
row block until it divides N; the port tiles by 128 rows and masks the
edge, so its partials differ in number but sum to the same dw.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["ROWS", "rmsnorm_bwd_plain", "rmsnorm_fwd_plain"]

ROWS = 128  # rows per K11 tile, one dw partial row each


def rmsnorm_fwd_plain(x: torch.Tensor, w: torch.Tensor,
                      eps: float = 1e-5) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (N, D), w (D,) -> (out (N, D) in x's dtype, rstd (N,) float32)."""
    x32 = x.float()
    rstd = torch.rsqrt((x32 * x32).mean(dim=-1, keepdim=True) + eps)
    out = (x32 * rstd * w.float()[None, :]).to(x.dtype)
    return out, rstd[:, 0]


def rmsnorm_bwd_plain(x: torch.Tensor, w: torch.Tensor, rstd: torch.Tensor,
                      do: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, do (N, D), w (D,), rstd (N,) float32 -> (dx (N, D) in x's dtype,
    dw partials (ceil(N / ROWS), D) float32)."""
    N, D = x.shape
    x32, do32 = x.float(), do.float()
    r = rstd[:, None]
    xhat = x32 * r
    dxhat = do32 * w.float()[None, :]
    mean_term = (dxhat * xhat).mean(dim=-1, keepdim=True)
    dx = (r * (dxhat - xhat * mean_term)).to(x.dtype)
    n_tiles = -(-N // ROWS)
    prod = do32 * xhat
    pad = n_tiles * ROWS - N
    if pad:
        prod = torch.cat([prod, prod.new_zeros((pad, D))])
    return dx, prod.reshape(n_tiles, ROWS, D).sum(dim=1)
