"""Gradient compression, the reference's ``distributed/compression.py``.

Two schemes, each applied to every gradient leaf between the backward and
the optimizer, so the optimizer sees the error a compressed all-reduce
would carry (on one card no collective runs; the arithmetic is the
reference's):

  int8:  per-tensor symmetric quantisation to int8 and straight back: the
         scale is max |g| / 127 (1.0 for an all-zero tensor), the quotient
         rounded half to even and clipped to [-127, 127].
  topk:  per tensor, the elements whose |g| reaches the k-th largest |g|
         (k = max(int(size * frac), 1)), the rest set to 0. ``ErrorFeedback``
         carries what was dropped into the next step.

Everything is computed in float32 from the gradient and cast back to its
dtype, as in the reference, so both packages give the same bits: the
divisions are IEEE divisions (``numerics.div_scalar``; a 0-d tensor as
divisor), ``torch.round`` rounds half to even as ``jnp.round`` does, and
the k-th largest magnitude is one value however ties are broken.
"""

from __future__ import annotations

import torch

from ..models.params import tree_leaves, tree_map
from ..numerics import div_scalar

__all__ = ["compress_grads", "int8_roundtrip", "topk_mask", "ErrorFeedback"]


def int8_roundtrip(g: torch.Tensor) -> torch.Tensor:
    g32 = g.float()
    a = g32.abs().amax()
    scale = torch.where(a > 0, div_scalar(a, 127.0), torch.ones_like(a))
    q = torch.clamp(torch.round(g32 / scale), -127, 127).to(torch.int8)
    return (q.float() * scale).to(g.dtype)


def topk_mask(g: torch.Tensor, frac: float = 0.1) -> torch.Tensor:
    mag = g.float().abs()
    k = max(int(mag.numel() * frac), 1)
    thresh = torch.topk(mag.reshape(-1), k, sorted=False).values.amin()
    return torch.where(mag >= thresh, g, torch.zeros((), dtype=g.dtype, device=g.device))


def compress_grads(grads, scheme: str, topk_frac: float = 0.1):
    """``grads`` (a tree of tensors) with every leaf compressed by
    ``scheme`` ("int8" or "topk"); any other scheme returns them as they
    are, as the reference does."""
    if scheme == "int8":
        return tree_map(int8_roundtrip, grads)
    if scheme == "topk":
        return tree_map(lambda g: topk_mask(g, topk_frac), grads)
    return grads


class ErrorFeedback:
    """Residual-carrying top-k compression (EF-SGD style)."""

    def init(self, grads):
        return tree_map(lambda g: torch.zeros_like(g, dtype=torch.float32), grads)

    def compress(self, grads, residual, frac: float = 0.1):
        """(kept gradients in their dtypes, new float32 residuals): top-k of
        gradient plus residual, and what it dropped."""
        outs = []
        for g, r in zip(tree_leaves(grads), tree_leaves(residual)):
            acc = g.float() + r
            kept = topk_mask(acc, frac)
            outs.append((kept.to(g.dtype), acc - kept))
        kept_it, res_it = iter([o[0] for o in outs]), iter([o[1] for o in outs])
        return tree_map(lambda _: next(kept_it), grads), tree_map(lambda _: next(res_it), grads)
