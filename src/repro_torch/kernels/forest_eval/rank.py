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

* ``radix_rank`` dispatches: a CPU tensor takes :func:`radix_rank_plain`,
  the same function stated plainly: one stable sort of the keys and a
  scatter of the positions. A tensor on the card launches
  ``csrc/radix_rank.cu`` on the route :func:`rank_route` picks:

  - ``count`` (rows of at most ``COUNT_N`` keys, the tuner's): a block
    ranks each element by counting the keys below it in shared memory;
  - ``onesweep`` (longer rows): a histogram launch, then 8 digit passes
    over (row, tile) grids with a decoupled look-back, on a workspace
    cached per device and stream (:func:`_workspace`);
  - ``block``, the first design (one block a row), for what the others
    refuse (more than 65535 rows, or rows of 2**30 keys).

  There is no other route: a CUDA tensor never reaches the plain version,
  and a build or launch failure raises. No route makes a host sync.
* ``rank_rows`` = ``radix_rank(monotone_keys(scores))``.

Scores must be NaN-free (numpy sorts any NaN last; the remap would order
-NaN first). EI scores, the only caller's input, are >= 0.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ... import obs as _obs
from ..counts import PLAIN_CALLS
from ..launch import check, launch, n_sms

__all__ = [
    "COUNT_LIMIT",
    "COUNT_N",
    "ROUTES",
    "SWEEP_TILE",
    "ascending_keys",
    "monotone_keys",
    "radix_rank",
    "radix_rank_cuda",
    "radix_rank_plain",
    "rank_route",
    "rank_rows",
]

ROUTES = ("count", "onesweep", "block")
COUNT_N = 2048          # the longest row the plan gives the count route
COUNT_LIMIT = 6144      # the longest the count route takes: its row in 48 KB of shared memory
SWEEP_TILE = 4096       # keys a onesweep tile (256 threads x 16)
_MAX_ROWS = 65535       # gridDim.y of the count and onesweep routes
_SWEEP_MAX_N = (1 << 30) - 1   # a status word's count
_BINS, _PASSES = 256, 8
_PLAN_WORDS = _PASSES * _BINS + _PASSES + 1
_HIST_BLOCKS_PER_SM = 4

_MSB = -(1 << 63)        # int64 with only bit 63 set
_LOW63 = (1 << 63) - 1   # ~_MSB


def _keys(bits: torch.Tensor) -> torch.Tensor:
    """Ascending uint64 keys (held in int64) of float64 bit patterns: ±0
    canonicalize to one key, negatives complement and positives set the
    most significant bit."""
    bits = torch.where((bits & _LOW63) == 0, torch.zeros_like(bits), bits)
    return torch.where(bits < 0, ~bits, bits | _MSB)


def monotone_keys(scores: torch.Tensor) -> torch.Tensor:
    """int64 tensors holding uint64 keys whose unsigned ascending order is
    the descending float order of ``scores`` (float64).

    All integer bit arithmetic, as in the reference: negation is a
    sign-bit XOR, then :func:`_keys`.
    """
    if scores.dtype != torch.float64:
        raise TypeError(f"scores must be float64, got {scores.dtype}")
    return _keys(scores.contiguous().view(torch.int64) ^ _MSB)


def ascending_keys(v: torch.Tensor) -> torch.Tensor:
    """int64 tensors holding uint64 keys whose unsigned ascending order is
    the ascending float order of ``v`` (float64), ±0 as one key: the
    reference's ``_sort_perm_asc1d`` remap."""
    if v.dtype != torch.float64:
        raise TypeError(f"v must be float64, got {v.dtype}")
    return _keys(v.contiguous().view(torch.int64))


def radix_rank_plain(keys: torch.Tensor) -> torch.Tensor:
    """(S, N) float64 ranks from (S, N) keys: each key's position under a
    stable ascending sort. Flipping bit 63 turns the unsigned key order
    into int64 order."""
    S, N = keys.shape
    perm = torch.argsort(keys ^ _MSB, dim=1, stable=True)
    pos = torch.arange(N, dtype=torch.float64, device=keys.device).expand(S, N)
    return torch.empty((S, N), dtype=torch.float64, device=keys.device).scatter_(1, perm, pos)


def rank_route(S: int, N: int) -> str:
    """The route of an (S, N) key matrix on the card: ``count`` for rows of
    at most ``COUNT_N`` keys, ``onesweep`` for longer ones, ``block`` past
    65535 rows or 2**30 - 1 keys a row. A pure function of its arguments."""
    if S <= 0 or N <= 0:
        raise ValueError(f"radix_rank: S = {S}, N = {N} must be positive")
    if S > _MAX_ROWS or N > _SWEEP_MAX_N:
        return "block"
    return "count" if N <= COUNT_N else "onesweep"


def _sweep_region(S: int, N: int) -> int:
    """int32 words of one region of the onesweep route's counters and
    status words: S tile counters, then 256 status words a (row, tile)."""
    return S + S * -(-N // SWEEP_TILE) * _BINS


# (device index, stream) -> the onesweep route's workspace, grown as needed
_WORKSPACE: Dict[Tuple[int, int], Dict[str, torch.Tensor]] = {}


def _workspace(device: torch.device, S: int, N: int) -> Dict[str, torch.Tensor]:
    """The onesweep route's workspace on ``device``'s current stream: the
    (key, index) ping-pong (``keys``: (2, S N) int64, ``idx``: (2, S N)
    int32), the histograms and done counters (zero between calls), the
    per-row plan, and two regions of counters and status words (``sync``,
    zero between calls). Calls on one stream run in order, so they share
    one workspace; it only grows, and a grown part replaces the old one on
    that same stream, so no kernel still writes what goes back to the
    allocator. The kernels leave what must be zero at zero."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ws = _WORKSPACE.setdefault(key, {})

    def grow(name, n, dtype, zero):
        t = ws.get(name)
        if t is None or t.numel() < n:
            t = (torch.zeros if zero else torch.empty)((max(n, 1),), dtype=dtype, device=device)
            ws[name] = t
        return t

    grow("keys", 2 * S * N, torch.int64, False)
    grow("idx", 2 * S * N, torch.int32, False)
    grow("hist", S * _PASSES * _BINS, torch.int32, True)
    grow("done", S, torch.int32, True)
    grow("plan", S * _PLAN_WORDS, torch.int32, False)
    grow("sync", 2 * _sweep_region(S, N), torch.int32, True)
    return ws


def radix_rank_cuda(keys: torch.Tensor, route: Optional[str] = None) -> torch.Tensor:
    """Launch K2 on the card; ``route`` forces a route (default
    :func:`rank_route`'s)."""
    S, N = keys.shape
    dev = keys.device
    check("keys", keys, torch.int64, (S, N), dev)
    if dev.type != "cuda":
        raise ValueError(f"radix_rank: the CUDA kernel needs tensors on the card, got {dev}")
    if route is not None and route not in ROUTES:
        raise ValueError(f"radix_rank: unknown route {route!r} (one of {ROUTES})")
    ranks = torch.empty((S, N), dtype=torch.float64, device=dev)
    if S == 0 or N == 0:
        return ranks
    route = route or rank_route(S, N)
    if route == "block":
        scratch = torch.empty((2, S, N), dtype=torch.int32, device=dev)
        launch("radix_rank", "radix_rank_launch", dev, (keys, ranks, scratch[0], scratch[1]),
               (S, N), route="block")
        return ranks
    if S > _MAX_ROWS:
        raise ValueError(f"radix_rank: the {route} route takes at most {_MAX_ROWS} rows, got {S}")
    if route == "count":
        if N > COUNT_LIMIT:
            raise ValueError(f"radix_rank: the count route takes rows of at most {COUNT_LIMIT} "
                             f"keys, got {N}")
        launch("radix_rank", "radix_rank_count_launch", dev, (keys, ranks), (S, N),
               route="count")
        return ranks
    if N > _SWEEP_MAX_N:
        raise ValueError(f"radix_rank: the onesweep route takes rows of under 2**30 keys, got {N}")
    ws = _workspace(dev, S, N)
    hist_blocks = max(1, min(-(-N // 1024), -(-_HIST_BLOCKS_PER_SM * n_sms(dev) // S)))
    k, i = ws["keys"], ws["idx"]
    try:
        launch("radix_rank", "radix_rank_onesweep_launch", dev,
               (keys, ranks, k[:S * N], k[S * N:2 * S * N], i[:S * N], i[S * N:2 * S * N],
                ws["hist"], ws["done"], ws["plan"], ws["sync"]),
               (S, N, ws["sync"].numel() // 2, hist_blocks), route="onesweep")
    except RuntimeError:
        # a launch that failed part way may leave counters set: start anew
        _WORKSPACE.pop((dev.index, torch.cuda.current_stream(dev).cuda_stream), None)
        raise
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
