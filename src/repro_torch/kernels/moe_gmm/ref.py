"""Plain PyTorch version of the grouped expert matmul (kernel K9).

``gmm_plain`` is the oracle of the reference's ``moe_gmm/ref.py``
(``gmm_ref``): the einsum ``ecd,edf->ecf`` of x and w upcast to float32,
rows ``c >= group_sizes[e]`` set to 0, the result cast to x's dtype.
``gmm_bwd_plain`` is the plain version of its backward (kernel K9b), which
the reference takes from JAX's autodiff of ``gmm_ref``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["gmm_bwd_plain", "gmm_plain"]


def gmm_plain(x: torch.Tensor, w: torch.Tensor,
              group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, D), w (E, D, F), group_sizes (E,) valid rows per expert or
    None (all C) -> (E, C, F) in x's dtype."""
    out = torch.bmm(x.float(), w.float())
    if group_sizes is not None:
        C = x.shape[1]
        rows = torch.arange(C, device=x.device)
        valid = rows[None, :] < group_sizes.to(x.device)[:, None]
        out = torch.where(valid[..., None], out, 0.0)
    return out.to(x.dtype)


def gmm_bwd_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                  group_sizes: Optional[torch.Tensor] = None,
                  need: Tuple[bool, bool] = (True, True)) -> tuple:
    """The backward of :func:`gmm_plain` for the cotangent dy (E, C, F):
    (dx (E, C, D) = dy . w^T in x's dtype, dw (E, D, F) = x^T . dy in w's
    dtype), float32 products, each None unless ``need`` asks for it. Rows
    ``c >= group_sizes[e]`` of x and dy are never read (the forward wrote 0
    there whatever they held), and those rows of dx are 0."""
    xf, dyf = x.float(), dy.float()
    valid = None
    if group_sizes is not None:
        rows = torch.arange(x.shape[1], device=x.device)
        valid = (rows[None, :] < group_sizes.to(x.device)[:, None])[..., None]
        xf, dyf = torch.where(valid, xf, 0.0), torch.where(valid, dyf, 0.0)
    dx = dw = None
    if need[0]:
        dx = torch.bmm(dyf, w.float().transpose(1, 2))
        if valid is not None:
            dx = torch.where(valid, dx, 0.0)
        dx = dx.to(x.dtype)
    if need[1]:
        dw = torch.bmm(xf.transpose(1, 2), dyf).to(w.dtype)
    return dx, dw
