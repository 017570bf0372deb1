"""Dispatch for split-KV decode attention (kernel K7).

``decode_attention(q, k, v, lengths, *, kv_splits, kv_block)`` keeps the
reference's ``flash_decode/ops.py`` signature: q (B, Hkv, G, D), k and v
(B, S, Hkv, D), lengths (B,) -> o (B, Hkv, G, D). The reference moves the
cache to (B·Hkv, S, D) for its kernel; this kernel reads it in the model's
layout where it lies, so a decode step copies nothing.

It cuts the splits and blocks as the reference does (fewer splits until
``kv_splits * kv_block`` divides S, then blocks halved until they divide a
split). Tensors on the card launch ``csrc/flash_decode.cu``, which writes
each split's partial (o, m, l) and merges them in a second kernel of the
same call; tensors on the CPU take ``ref.decode_plain``. There is no other
route: a CUDA tensor never reaches the plain version, and a build or
launch failure raises. The kernel takes any G (query rows per KV head, in
blocks of 8) and D <= 128; a larger D is refused on both routes.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch
from .ref import decode_plain

__all__ = ["MAX_D", "decode_attention", "decode_cuda", "decode_plain", "split_plan"]

MAX_D = 128    # head dim the kernel holds
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


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


def _check(q, k, v, lengths) -> Tuple[int, int, int, int, int]:
    """Raise unless q (B, Hkv, G, D) and k, v (B, S, Hkv, D) are contiguous
    tensors of one dtype (bfloat16 or float32), lengths (B,) int32, all on
    one device, and D <= 128; returns (B, Hkv, G, D, S). Both routes take
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
    check("q", q, q.dtype, (B, Hkv, G, D), q.device)
    check("k", k, q.dtype, (B, S, Hkv, D), q.device)
    check("v", v, q.dtype, (B, S, Hkv, D), q.device)
    check("lengths", lengths, torch.int32, (B,), q.device)
    return B, Hkv, G, D, S


def decode_cuda(q, k, v, lengths, splits: int) -> torch.Tensor:
    """Launch K7 on the card; the arguments of ``ref.decode_plain`` but the
    block (the kernel walks 32 keys at a time whatever the block says)."""
    B, Hkv, G, D, S = _check(q, k, v, lengths)
    if S % splits:
        raise ValueError(f"flash_decode: {splits} splits do not divide {S} keys")
    dev = q.device
    o = torch.empty_like(q)
    o_part = torch.empty((B * Hkv, splits, G, D), dtype=torch.float32, device=dev)
    m_part = torch.empty((B * Hkv, splits, G), dtype=torch.float32, device=dev)
    l_part = torch.empty_like(m_part)
    launch("flash_decode", f"flash_decode_{_DTYPES[q.dtype]}", dev,
           (q, k, v, lengths, o_part, m_part, l_part, o), (B, Hkv, S, G, D, splits))
    return o


def decode_attention(q, k, v, lengths, *, kv_splits: int = 4,
                     kv_block: int = 128) -> torch.Tensor:
    """q (B, Hkv, G, D); k, v (B, S, Hkv, D); lengths (B,) int32 -> o (B,
    Hkv, G, D) in q's dtype."""
    splits, block = split_plan(k.shape[1], kv_splits, kv_block)
    if q.device.type == "cuda":
        return decode_cuda(q, k, v, lengths, splits)
    if q.device.type != "cpu":
        raise ValueError(f"flash_decode: unsupported device {q.device}")
    _check(q, k, v, lengths)
    PLAIN_CALLS["flash_decode"] += 1
    return decode_plain(q, k, v, lengths, splits, block)
