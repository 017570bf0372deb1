"""Plain PyTorch version of the packed-forest gather descent (K1).

The same node encoding as the reference ``core/surrogate.py::packed_descend``:
leaves carry ``thr = +inf`` and self-loop children, and ``child`` holds
the two children of node ``i`` at ``[2i, 2i+1]``. ``depth`` rounds of four
gathers route every (tree, candidate) lane to its leaf with the float64
compare ``x > thr``; the result is the leaf (mean, var), each (T, N).
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["forest_eval_plain"]


def forest_eval_plain(feat, thr, child, mean, var, roots, X, depth: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    T = roots.shape[0]
    N, D = X.shape
    xflat = X.reshape(-1)
    col = (torch.arange(N, dtype=torch.int64, device=X.device) * D)[None, :]
    nid = roots[:, None].expand(T, N).clone()
    for _ in range(depth):
        f = feat[nid]
        go_right = (xflat[col + f] > thr[nid]).to(torch.int64)
        nid = child[2 * nid + go_right]
    return mean[nid], var[nid]
