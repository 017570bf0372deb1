"""Plain PyTorch version of the grouped expert matmul (kernel K9).

``gmm_plain`` is the oracle of the reference's ``moe_gmm/ref.py``
(``gmm_ref``): the einsum ``ecd,edf->ecf`` of x and w upcast to float32,
rows ``c >= group_sizes[e]`` set to 0, the result cast to x's dtype.
"""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["gmm_plain"]


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
