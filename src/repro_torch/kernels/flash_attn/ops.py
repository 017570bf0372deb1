"""Dispatch for the flash-attention forward (kernel K4).

``flash_attention`` takes the model's grouped layout, q (B, Sq, Hkv, G, D)
and k, v (B, Sk, Hkv, D), moves it to the kernel's (B·Hkv, S, G, D) layout
as the reference's ``ops.py`` does, and returns o (B, Sq, Hkv, G, D).
``flash_fwd`` works in the kernel layout and returns (o, lse). Tensors on
the card launch the CUDA kernel ``csrc/flash_attn_fwd.cu``; tensors on the
CPU take the plain version in ``ref.py``. There is no other route: a CUDA
tensor never reaches the plain version, and a build or launch failure
raises.

Only the forward is ported: there is no autograd function yet (the
backward kernels K5/K6 come with training). ``q_block`` and ``kv_block``
are the reference's block sizes. Both packages take ``min(block, S)`` and
refuse blocks that do not divide the sequence lengths, so the same calls
succeed and fail in both. The CUDA kernel tiles by 64 rows and 64 keys
whatever the blocks say: the blocks change only the order of float32 sums.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch
from .ref import check_blocks, flash_fwd_plain

__all__ = ["HEAD_DIMS", "flash_attention", "flash_fwd", "flash_fwd_cuda", "flash_fwd_plain"]

HEAD_DIMS = (16, 32, 64, 128)  # the head dims the kernel is built for
_SYMBOLS = {torch.float32: "flash_attn_fwd_f32", torch.bfloat16: "flash_attn_fwd_bf16"}
_MAX_BH = 65535  # gridDim.y


def flash_fwd_cuda(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                   q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on the card: q (BH, Sq, G, D), k/v (BH, Sk, D), one dtype
    (bfloat16 or float32), contiguous, on one CUDA device."""
    dev = q.device
    BH, Sq, G, D = q.shape
    Sk = k.shape[1]
    if q.dtype not in _SYMBOLS:
        raise TypeError(f"flash_attn_fwd: dtype {q.dtype} not supported (bfloat16, float32)")
    if D not in HEAD_DIMS:
        raise ValueError(f"flash_attn_fwd: head dim {D} not in {HEAD_DIMS}")
    if BH > _MAX_BH:
        raise ValueError(f"flash_attn_fwd: {BH} batch x kv-head rows > {_MAX_BH}")
    if Sk <= 0 or Sq * G >= 2**31:
        raise ValueError(f"flash_attn_fwd: sequence lengths ({Sq}, {Sk}) out of range")
    check("q", q, q.dtype, (BH, Sq, G, D), dev)
    check("k", k, q.dtype, (BH, Sk, D), dev)
    check("v", v, q.dtype, (BH, Sk, D), dev)
    o = torch.empty((BH, Sq, G, D), dtype=q.dtype, device=dev)
    lse = torch.empty((BH, Sq, G), dtype=torch.float32, device=dev)
    launch("flash_attn_fwd", _SYMBOLS[q.dtype], dev, (q, k, v, o, lse),
           (BH, Sq, Sk, G, D, int(bool(causal)), int(window is not None),
            0 if window is None else int(window), int(q_offset)))
    return o, lse


def flash_fwd(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
              q_block: int = 128, kv_block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) in the kernel layout: q (BH, Sq, G, D), k/v (BH, Sk, D*)."""
    check_blocks(q.shape[1], k.shape[1], q_block, kv_block)
    if q.device.type == "cuda":
        return flash_fwd_cuda(q, k, v, causal=causal, window=window, q_offset=q_offset)
    if q.device.type != "cpu":
        raise ValueError(f"flash_attn_fwd: unsupported device {q.device}")
    PLAIN_CALLS["flash_attn_fwd"] += 1
    return flash_fwd_plain(q, k, v, causal=causal, window=window, q_offset=q_offset,
                           q_block=q_block, kv_block=kv_block)


def _to_kernel_layout(q, k, v):
    B, Sq, Hkv, G, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    qk = q.permute(0, 2, 1, 3, 4).reshape(B * Hkv, Sq, G, D).contiguous()
    kk = k.permute(0, 2, 1, 3).reshape(B * Hkv, Sk, D).contiguous()
    vk = v.permute(0, 2, 1, 3).reshape(B * Hkv, Sk, Dv).contiguous()
    return qk, kk, vk


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, q_block: int = 128, kv_block: int = 128) -> torch.Tensor:
    """q (B, Sq, Hkv, G, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv) ->
    o (B, Sq, Hkv, G, Dv)."""
    B, Sq, Hkv, G, D = q.shape
    Dv = v.shape[-1]
    qk, kk, vk = _to_kernel_layout(q, k, v)
    o, _ = flash_fwd(qk, kk, vk, causal=causal, window=window, q_offset=q_offset,
                     q_block=min(q_block, Sq), kv_block=min(kv_block, k.shape[1]))
    return o.reshape(B, Hkv, Sq, G, Dv).permute(0, 2, 1, 3, 4)
