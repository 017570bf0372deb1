"""Dispatch for split-KV decode attention (kernel K7).

``decode_attention(q, k, v, lengths, *, kv_splits, kv_block)`` keeps the
reference's ``flash_decode/ops.py`` signature: q (B, Hkv, G, D), k and v
(B, S, Hkv, D), lengths (B,) -> o (B, Hkv, G, D). The reference moves the
cache to (B·Hkv, S, D) for its kernel; these kernels read it in the model's
layout where it lies, so a decode step copies nothing.

Tensors on the CPU take ``ref.decode_plain`` with the reference's plan
(:func:`split_plan`: fewer splits until ``kv_splits * kv_block`` divides S,
then blocks halved until they divide a split). Tensors on the card launch
``csrc/flash_decode.cu`` on one of two routes, picked by
:func:`decode_route`:

- ``ring`` (D a multiple of 8, 16-byte aligned bases): a cp.async ring of
  32-key tiles, the query rows in registers, the splits planned for the card
  by :func:`ring_plan` (a block an SM at least) and merged in the same
  launch by the last block of each (b, h) to finish;
- ``scalar`` (any other D <= 128 or alignment): the first design, with the
  reference's split count and a second launch for the merge.

There is no other route: a CUDA tensor never reaches the plain version, and
a build or launch failure raises. Both routes take any G and D <= 128; a
larger D is refused on every route.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch, n_sms
from .ref import decode_plain

__all__ = [
    "MAX_D", "RING_ROWS", "RING_TILE", "ROUTES", "decode_attention", "decode_cuda",
    "decode_plain", "decode_route", "ring_plan", "ring_rows", "route_of", "split_plan",
]

MAX_D = 128    # head dim the kernels hold
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
# route -> the prefix of its C entry points (csrc/flash_decode.cu)
ROUTES = {"ring": "flash_decode_ring", "scalar": "flash_decode"}
RING_TILE = 32     # keys a stage of the ring (the kernel's RTK)
RING_ROWS = 8      # query rows a ring block at most (the kernel's RGB)
RING_BLOCKS_PER_SM = 1   # blocks the ring plan asks for at least, per SM


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def split_plan(S: int, kv_splits: int, kv_block: int) -> Tuple[int, int]:
    """The reference's (splits, block) for a cache of S keys."""
    if S <= 0 or kv_splits <= 0 or kv_block <= 0:
        raise ValueError(f"flash_decode: S = {S}, kv_splits = {kv_splits}, kv_block = "
                         f"{kv_block} must be positive")
    while S % (kv_splits * kv_block) and kv_splits > 1:
        kv_splits -= 1
    kv_block = min(kv_block, S // kv_splits)
    while (S // kv_splits) % kv_block:
        kv_block //= 2
    return kv_splits, kv_block


def decode_route(D: int, aligned: bool) -> str:
    """The kernel that takes head dim D on the card; ``aligned``: q, k and v
    start on 16-byte boundaries."""
    return "ring" if aligned and D % 8 == 0 else "scalar"


def route_of(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> str:
    """The route :func:`decode_route` picks for these tensors."""
    aligned = q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
    return decode_route(q.shape[-1], aligned)


def ring_rows(G: int) -> int:
    """Query rows a ring block holds: the least of 1, 2, 4, 8 that takes G,
    8 beyond (blocks of 8 rows side by side)."""
    return next(r for r in (1, 2, 4, RING_ROWS) if G <= r or r == RING_ROWS)


@functools.lru_cache(maxsize=256)
def ring_plan(S: int, pairs: int, n_sms: int) -> Tuple[int, int]:
    """(splits, split_len) of the ring route for a cache of S keys and
    ``pairs`` (b, h, row block) triples on a card of ``n_sms`` SMs.

    Each split is a power-of-two number of RING_TILE-key tiles: the largest
    that still gives ``pairs * splits >= RING_BLOCKS_PER_SM * n_sms`` blocks
    (one tile a split where even that falls short): on an H100 that beat
    twice as many splits at every path's long-cache shape
    (``scripts/flash_decode_variants.py``). Every split but the last is full; the last ends at S and the kernel masks it
    there, so the splits divide S where split_len does. A pure function of
    its arguments: no device is read."""
    if S <= 0 or pairs <= 0 or n_sms <= 0:
        raise ValueError(f"flash_decode: S = {S}, {pairs} pairs and {n_sms} SMs must be positive")
    tiles = _cdiv(S, RING_TILE)
    tps = 1
    while 2 * tps <= tiles and pairs * _cdiv(tiles, 2 * tps) >= RING_BLOCKS_PER_SM * n_sms:
        tps *= 2
    split_len = tps * RING_TILE
    return _cdiv(S, split_len), split_len


# (device index, stream) -> (float32 workspace, int32 counters), grown as needed
_SCRATCH: Dict[Tuple[int, int], Tuple[torch.Tensor, torch.Tensor]] = {}


def _scratch(device: torch.device, n_ws: int, n_counters: int):
    """The ring route's workspace and counters on ``device``'s current
    stream. Calls on one stream run in order, so they share one pair; the
    counters start at 0 and every call leaves them at 0."""
    key = (device.index, torch.cuda.current_stream(device).cuda_stream)
    ws, cnt = _SCRATCH.get(key, (None, None))
    if ws is None or ws.numel() < n_ws:
        ws = torch.empty((max(n_ws, 1),), dtype=torch.float32, device=device)
    if cnt is None or cnt.numel() < n_counters:
        cnt = torch.zeros((max(n_counters, 1),), dtype=torch.int32, device=device)
    _SCRATCH[key] = (ws, cnt)
    return ws, cnt


def _check(q, k, v, lengths) -> Tuple[int, int, int, int, int]:
    """Raise unless q (B, Hkv, G, D) and k, v (B, S, Hkv, D) are contiguous
    tensors of one dtype (bfloat16 or float32), lengths (B,) int32, all on
    one device, and D <= 128; returns (B, Hkv, G, D, S). Every route takes
    the same."""
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"flash_decode: q must be (B, Hkv, G, D) and k (B, S, Hkv, D), got "
                         f"{tuple(q.shape)} and {tuple(k.shape)}")
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"flash_decode: dtype {q.dtype} not supported (bfloat16, float32)")
    if D > MAX_D:
        raise ValueError(f"flash_decode: D = {D}; the kernel's limit is {MAX_D}")
    dev, cache = q.device, (B, S, Hkv, D)
    want = (("q", q, q.dtype, (B, Hkv, G, D)), ("k", k, q.dtype, cache),
            ("v", v, q.dtype, cache), ("lengths", lengths, torch.int32, (B,)))
    # one pass over the table; check() only names what is wrong
    if not all(isinstance(t, torch.Tensor) and t.dtype == dt and t.shape == shape
               and t.device == dev and t.is_contiguous() for _, t, dt, shape in want):
        for name, t, dt, shape in want:
            check(name, t, dt, shape, dev)
    return B, Hkv, G, D, S


def decode_cuda(q, k, v, lengths, splits: Optional[int] = None, *,
                route: Optional[str] = None) -> torch.Tensor:
    """Launch K7 on the card: the arguments of ``ref.decode_plain`` but the
    block. ``route`` forces a route (default :func:`route_of`). ``splits``
    is the scalar route's split count, which must divide S (default the
    reference's 4, cut as :func:`split_plan` cuts it); the ring route plans
    its own (:func:`ring_plan`) and refuses one."""
    B, Hkv, G, D, S = _check(q, k, v, lengths)
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_decode: the CUDA kernel needs tensors on the card, got {dev}")
    fits = route_of(q, k, v)
    route = route or fits
    o = torch.empty_like(q)
    if route == "scalar":
        splits = splits or split_plan(S, 4, 128)[0]
        if S % splits:
            raise ValueError(f"flash_decode: {splits} splits do not divide {S} keys")
        o_part = torch.empty((B * Hkv, splits, G, D), dtype=torch.float32, device=dev)
        m_part = torch.empty((B * Hkv, splits, G), dtype=torch.float32, device=dev)
        l_part = torch.empty_like(m_part)
        launch("flash_decode", f"{ROUTES['scalar']}_{_DTYPES[q.dtype]}", dev,
               (q, k, v, lengths, o_part, m_part, l_part, o), (B, Hkv, S, G, D, splits),
               route="scalar")
        return o
    if route != "ring":
        raise ValueError(f"flash_decode: no route {route!r}")
    if splits is not None:
        raise ValueError(f"flash_decode: the ring route plans its own splits, got {splits}")
    if fits != "ring":
        raise ValueError(f"flash_decode: the ring route needs D % 8 == 0 and 16-byte aligned "
                         f"bases, got D = {D}")
    gz = _cdiv(G, ring_rows(G))
    n_splits, split_len = ring_plan(S, B * Hkv * gz, n_sms(dev))
    ws = cnt = None
    if n_splits > 1:
        ws, cnt = _scratch(dev, B * Hkv * n_splits * G * (D + 2), B * Hkv * gz)
    launch("flash_decode", f"{ROUTES['ring']}_{_DTYPES[q.dtype]}", dev,
           (q, k, v, lengths, ws, cnt, o),
           (B, Hkv, S, G, D, n_splits, split_len, gz), route="ring")
    return o


def decode_attention(q, k, v, lengths, *, kv_splits: int = 4,
                     kv_block: int = 128) -> torch.Tensor:
    """q (B, Hkv, G, D); k, v (B, S, Hkv, D); lengths (B,) int32 -> o (B,
    Hkv, G, D) in q's dtype. ``kv_splits`` and ``kv_block`` are the
    reference's plan, which the CPU and the scalar route follow; the ring
    route plans its own splits for the card."""
    if q.device.type == "cuda":
        route = route_of(q, k, v)
        if route == "ring":
            return decode_cuda(q, k, v, lengths, route=route)
        return decode_cuda(q, k, v, lengths, split_plan(k.shape[1], kv_splits, kv_block)[0],
                           route=route)
    if q.device.type != "cpu":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    splits, block = split_plan(k.shape[1], kv_splits, kv_block)
    _check(q, k, v, lengths)
    PLAIN_CALLS["flash_decode"] += 1
    return decode_plain(q, k, v, lengths, splits, block)
