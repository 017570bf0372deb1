"""Dispatch for flash attention: the forward K4 and the backward K5 (dq)
and K6 (dk, dv).

``flash_attention`` takes the model's grouped layout, q (B, Sq, Hkv, G, D)
and k, v (B, Sk, Hkv, D), moves it to the kernels' (B·Hkv, S, G, D) layout
as the reference's ``ops.py`` does, and returns o (B, Sq, Hkv, G, D)
through a ``torch.autograd.Function``: its forward runs K4 and keeps q, k,
v, o and lse; its backward computes delta = sum(do * o) in float32 outside
any kernel, as the reference's ``_flash_bwd`` does, then runs K5 for dq and
K6 for dk and dv. ``flash_fwd``, ``flash_dq`` and ``flash_dkv`` work in the
kernel layout. Tensors on the card launch the CUDA kernels
(``csrc/flash_attn_fwd.cu``, ``csrc/flash_attn_bwd.cu``); tensors on the
CPU take the plain versions in ``ref.py``, so both devices take one route.
There is no other route: a CUDA tensor never reaches a plain version, and
a build or launch failure raises.

``q_block`` and ``kv_block`` are the reference's block sizes. Both packages
take ``min(block, S)`` and refuse blocks that do not divide the sequence
lengths, so the same calls succeed and fail in both. The CUDA kernels tile
as their hardware wants whatever the blocks say (the blocks change only the
order of float32 sums): in bfloat16 on the tensor cores (``wgmma``, TMA),
K4 by 128 rows and 128 keys, K5 by 128 rows and 64 keys, K6 by 128 keys
and 64 rows; in float32 on the CUDA cores by 64 rows and 64 keys. All
three take the head dims of ``HEAD_DIMS`` in both dtypes.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch
from .ref import check_blocks, flash_dkv_plain, flash_dq_plain, flash_fwd_plain

__all__ = [
    "HEAD_DIMS", "flash_attention", "flash_dkv", "flash_dkv_cuda", "flash_dkv_plain", "flash_dq",
    "flash_dq_cuda", "flash_dq_plain", "flash_fwd", "flash_fwd_cuda", "flash_fwd_plain",
]

HEAD_DIMS = (16, 32, 64, 80, 128)  # K4-K6's; 80 is zamba2-2.7b's shared attention
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_BH = 65535  # gridDim.y


def _check_qkv(name: str, q, k, v) -> Tuple[int, int, int, int, int]:
    """Raise unless q (BH, Sq, G, D) and k, v (BH, Sk, D) are what the
    kernels take, D in ``HEAD_DIMS``; returns (BH, Sq, Sk, G, D)."""
    BH, Sq, G, D = q.shape
    Sk = k.shape[1]
    if q.dtype not in _DTYPES:
        raise TypeError(f"{name}: dtype {q.dtype} not supported (bfloat16, float32)")
    if D not in HEAD_DIMS:
        raise ValueError(f"{name}: head dim {D} not in {HEAD_DIMS}")
    if BH > _MAX_BH:
        raise ValueError(f"{name}: {BH} batch x kv-head rows > {_MAX_BH}")
    if Sk <= 0 or Sq * G >= 2**31:
        raise ValueError(f"{name}: sequence lengths ({Sq}, {Sk}) out of range")
    check("q", q, q.dtype, (BH, Sq, G, D), q.device)
    check("k", k, q.dtype, (BH, Sk, D), q.device)
    check("v", v, q.dtype, (BH, Sk, D), q.device)
    return BH, Sq, Sk, G, D


def _mask_ints(causal: bool, window: Optional[int], q_offset: int) -> Tuple[int, int, int, int]:
    return (int(bool(causal)), int(window is not None), 0 if window is None else int(window),
            int(q_offset))


def flash_fwd_cuda(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                   q_offset: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K4 on the card: q (BH, Sq, G, D), k/v (BH, Sk, D), one dtype
    (bfloat16 or float32), contiguous, on one CUDA device."""
    BH, Sq, Sk, G, D = _check_qkv("flash_attn_fwd", q, k, v)
    o = torch.empty((BH, Sq, G, D), dtype=q.dtype, device=q.device)
    lse = torch.empty((BH, Sq, G), dtype=torch.float32, device=q.device)
    launch("flash_attn_fwd", f"flash_attn_fwd_{_DTYPES[q.dtype]}", q.device, (q, k, v, o, lse),
           (BH, Sq, Sk, G, D, *_mask_ints(causal, window, q_offset)))
    return o, lse


def _check_grad_inputs(name: str, q, k, v, do, lse, delta) -> Tuple[int, int, int, int, int]:
    BH, Sq, Sk, G, D = _check_qkv(name, q, k, v)
    check("do", do, q.dtype, (BH, Sq, G, D), q.device)
    check("lse", lse, torch.float32, (BH, Sq, G), q.device)
    check("delta", delta, torch.float32, (BH, Sq, G), q.device)
    return BH, Sq, Sk, G, D


def flash_dq_cuda(q, k, v, do, lse, delta, *, causal: bool = True,
                  window: Optional[int] = None, q_offset: int = 0) -> torch.Tensor:
    """Launch K5 on the card: K4's inputs plus do (BH, Sq, G, D) in q's dtype
    and lse, delta (BH, Sq, G) float32 -> dq (BH, Sq, G, D) in q's dtype."""
    BH, Sq, Sk, G, D = _check_grad_inputs("flash_attn_dq", q, k, v, do, lse, delta)
    dq = torch.empty_like(q)
    launch("flash_attn_dq", f"flash_attn_dq_{_DTYPES[q.dtype]}", q.device,
           (q, k, v, do, lse, delta, dq),
           (BH, Sq, Sk, G, D, *_mask_ints(causal, window, q_offset)), source="flash_attn_bwd")
    return dq


def flash_dkv_cuda(q, k, v, do, lse, delta, *, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K6 on the card: the inputs of :func:`flash_dq_cuda` -> (dk,
    dv), each (BH, Sk, D) in k's and v's dtype."""
    BH, Sq, Sk, G, D = _check_grad_inputs("flash_attn_dkv", q, k, v, do, lse, delta)
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    launch("flash_attn_dkv", f"flash_attn_dkv_{_DTYPES[q.dtype]}", q.device,
           (q, k, v, do, lse, delta, dk, dv),
           (BH, Sq, Sk, G, D, *_mask_ints(causal, window, q_offset)), source="flash_attn_bwd")
    return dk, dv


def _dispatch(name: str, cuda_fn, plain_fn, args, causal, window, q_offset, q_block, kv_block):
    """``cuda_fn`` for tensors on the card, ``plain_fn`` (counted) for tensors
    on the CPU, after the reference's block checks."""
    q, k = args[0], args[1]
    check_blocks(q.shape[1], k.shape[1], q_block, kv_block)
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    if q.device.type == "cuda":
        return cuda_fn(*args, **mask)
    if q.device.type != "cpu":
        raise ValueError(f"{name}: unsupported device {q.device}")
    PLAIN_CALLS[name] += 1
    return plain_fn(*args, **mask, q_block=q_block, kv_block=kv_block)


def flash_fwd(q, k, v, *, causal: bool = True, window: Optional[int] = None, q_offset: int = 0,
              q_block: int = 128, kv_block: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """(o, lse) in the kernel layout: q (BH, Sq, G, D), k/v (BH, Sk, D*)."""
    return _dispatch("flash_attn_fwd", flash_fwd_cuda, flash_fwd_plain, (q, k, v),
                     causal, window, q_offset, q_block, kv_block)


def flash_dq(q, k, v, do, lse, delta, *, causal: bool = True, window: Optional[int] = None,
             q_offset: int = 0, q_block: int = 128, kv_block: int = 128) -> torch.Tensor:
    """dq in the kernel layout (K5 on the card)."""
    return _dispatch("flash_attn_dq", flash_dq_cuda, flash_dq_plain, (q, k, v, do, lse, delta),
                     causal, window, q_offset, q_block, kv_block)


def flash_dkv(q, k, v, do, lse, delta, *, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0, q_block: int = 128, kv_block: int = 128
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv) in the kernel layout (K6 on the card)."""
    return _dispatch("flash_attn_dkv", flash_dkv_cuda, flash_dkv_plain,
                     (q, k, v, do, lse, delta), causal, window, q_offset, q_block, kv_block)


class _FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) in the kernel layout; the reference's
    ``_flash`` custom VJP."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_block, kv_block):
        kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=q_block,
                  kv_block=kv_block)
        o, lse = flash_fwd(q, k, v, **kw)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.kw = kw
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.contiguous()
        delta = (do.float() * o.float()).sum(dim=-1)
        dq = flash_dq(q, k, v, do, lse, delta, **ctx.kw)
        dk, dv = flash_dkv(q, k, v, do, lse, delta, **ctx.kw)
        return dq, dk, dv, None, None, None, None, None


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
    o (B, Sq, Hkv, G, Dv), differentiable in q, k and v."""
    B, Sq, Hkv, G, D = q.shape
    Dv = v.shape[-1]
    qk, kk, vk = _to_kernel_layout(q, k, v)
    o = _FlashAttention.apply(qk, kk, vk, causal, window, q_offset, min(q_block, Sq),
                              min(kv_block, k.shape[1]))
    return o.reshape(B, Hkv, Sq, G, Dv).permute(0, 2, 1, 3, 4)
