"""Radix rank for weighted rank aggregation (kernel K2).

``aggregate_ranks`` needs, per score row, the float rank each candidate
gets under ``np.argsort(-scores, kind="stable")``: rank 0 = highest score,
ties broken by index. As in the reference (``repro/kernels/forest_eval/
rank.py``) the scores are first remapped to uint64 keys whose ascending
order is the descending float order (:func:`monotone_keys`), and a stable
LSD radix over the keys gives the ranks.

torch's ``uint64`` lacks ``>>``, negation and ``bincount``, so the keys
travel as ``int64`` tensors holding the same 64 bits; the CUDA kernel
reads them as ``unsigned long long``.

* ``radix_rank`` dispatches: a tensor on the card launches
  ``csrc/radix_rank.cu`` (8 passes of 8-bit digits, one block per row);
  a CPU tensor takes :func:`radix_rank_plain`, the same function stated
  plainly: one stable sort of the keys and a scatter of the positions.
* ``rank_rows`` = ``radix_rank(monotone_keys(scores))``.

Scores must be NaN-free (numpy sorts any NaN last; the remap would order
-NaN first). EI scores, the only caller's input, are >= 0.
"""

from __future__ import annotations

import torch

from ... import obs as _obs
from ..counts import PLAIN_CALLS
from ..launch import check, launch

__all__ = [
    "monotone_keys",
    "radix_rank",
    "radix_rank_cuda",
    "radix_rank_plain",
    "rank_rows",
]

_MSB = -(1 << 63)        # int64 with only bit 63 set
_LOW63 = (1 << 63) - 1   # ~_MSB


def monotone_keys(scores: torch.Tensor) -> torch.Tensor:
    """int64 tensors holding uint64 keys whose unsigned ascending order is
    the descending float order of ``scores`` (float64).

    All integer bit arithmetic, as in the reference: negation is a
    sign-bit XOR, ±0 canonicalize to one key, negatives complement and
    positives set the most significant bit.
    """
    if scores.dtype != torch.float64:
        raise TypeError(f"scores must be float64, got {scores.dtype}")
    bits = scores.contiguous().view(torch.int64) ^ _MSB
    bits = torch.where((bits & _LOW63) == 0, torch.zeros_like(bits), bits)
    return torch.where(bits < 0, ~bits, bits | _MSB)


def radix_rank_plain(keys: torch.Tensor) -> torch.Tensor:
    """(S, N) float64 ranks from (S, N) keys: each key's position under a
    stable ascending sort. Flipping bit 63 turns the unsigned key order
    into int64 order."""
    S, N = keys.shape
    perm = torch.argsort(keys ^ _MSB, dim=1, stable=True)
    pos = torch.arange(N, dtype=torch.float64, device=keys.device).expand(S, N)
    return torch.empty((S, N), dtype=torch.float64, device=keys.device).scatter_(1, perm, pos)


def radix_rank_cuda(keys: torch.Tensor) -> torch.Tensor:
    """Launch K2 on the card."""
    S, N = keys.shape
    check("keys", keys, torch.int64, (S, N), keys.device)
    ranks = torch.empty((S, N), dtype=torch.float64, device=keys.device)
    scratch = torch.empty((2, S, N), dtype=torch.int32, device=keys.device)
    launch("radix_rank", "radix_rank_launch", keys.device,
           (keys, ranks, scratch[0], scratch[1]), (S, N))
    return ranks


def radix_rank(keys: torch.Tensor) -> torch.Tensor:
    """Float rank matrix of (S, N) monotone keys (stable ascending)."""
    if keys.dim() != 2:
        raise ValueError(f"keys must be (S, N), got shape {tuple(keys.shape)}")
    if keys.device.type == "cuda":
        return radix_rank_cuda(keys)
    if keys.device.type != "cpu":
        raise ValueError(f"radix_rank: unsupported device {keys.device}")
    PLAIN_CALLS["radix_rank"] += 1
    return radix_rank_plain(keys)


def rank_rows(scores: torch.Tensor) -> torch.Tensor:
    """Ranks of ``np.argsort(-scores, axis=1, kind="stable")`` per row."""
    if scores.dim() == 1:
        scores = scores[None, :]
    _obs.count("rank_kernel/radix")
    return radix_rank(monotone_keys(scores).contiguous())
