"""Plain PyTorch versions of flash attention (kernel K4).

``attention_ref`` is the oracle of the reference's ``flash_attn/ref.py``:
full float32 scores, positional mask, softmax, in the model's grouped
layout (B, S, Hkv, G, D). ``flash_fwd_plain`` computes what the kernel
computes, in the kernel's layout (BH, S, G, D): the FlashAttention-2
forward recurrence of ``_fwd_kernel`` (q upcast and scaled by 1/sqrt(D),
online softmax in float32 over KV blocks of ``kv_block`` keys, masked
score -1e30), returning o in q's dtype and lse in float32. Query rows are
independent, so it runs every q block at once.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

__all__ = ["NEG_INF", "attention_ref", "check_blocks", "flash_fwd_plain", "positional_mask"]

NEG_INF = -1e30


def positional_mask(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool,
                    window: Optional[int]) -> torch.Tensor:
    """(Sq, Sk) bool: True where query position ``qpos`` may see key ``kpos``."""
    m = torch.ones((qpos.shape[0], kpos.shape[0]), dtype=torch.bool, device=qpos.device)
    if causal:
        m &= qpos[:, None] >= kpos[None, :]
    if window is not None:
        m &= (qpos[:, None] - kpos[None, :]) < window
    return m


def check_blocks(Sq: int, Sk: int, q_block: int, kv_block: int) -> Tuple[int, int]:
    """The reference's block sizes (``min(block, S)``), which must divide
    the sequence lengths, as ``flash_fwd_pallas`` asserts."""
    q_block, kv_block = min(q_block, Sq), min(kv_block, Sk)
    if q_block <= 0 or kv_block <= 0 or Sq % q_block or Sk % kv_block:
        raise ValueError(f"flash attention: blocks ({q_block}, {kv_block}) do not divide "
                         f"the sequence lengths ({Sq}, {Sk})")
    return q_block, kv_block


def attention_ref(q, k, v, causal: bool = True, window: Optional[int] = None,
                  q_offset: int = 0) -> torch.Tensor:
    """q (B, Sq, Hkv, G, D), k (B, Sk, Hkv, D), v (B, Sk, Hkv, Dv) ->
    (B, Sq, Hkv, G, Dv) in q's dtype."""
    B, Sq, Hkv, G, D = q.shape
    Sk = k.shape[1]
    s = torch.einsum("bqhgd,bkhd->bqhgk", q.float(), k.float()) / math.sqrt(D)
    qp = q_offset + torch.arange(Sq, device=q.device)
    kp = torch.arange(Sk, device=q.device)
    mask = positional_mask(qp, kp, causal, window)
    s = torch.where(mask[None, :, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bqhgk,bkhd->bqhgd", p, v.float()).to(q.dtype)


def flash_fwd_plain(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, q_block: int = 128, kv_block: int = 128
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (BH, Sq, G, D), k/v (BH, Sk, D*) -> (o (BH, Sq, G, Dv), lse (BH, Sq, G))."""
    BH, Sq, G, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    _, kv_block = check_blocks(Sq, Sk, q_block, kv_block)
    scale = 1.0 / math.sqrt(D)
    qs = q.float() * scale
    qpos = q_offset + torch.arange(Sq, device=q.device)
    m = torch.full((BH, Sq, G), NEG_INF, dtype=torch.float32, device=q.device)
    l = torch.zeros((BH, Sq, G), dtype=torch.float32, device=q.device)
    acc = torch.zeros((BH, Sq, G, Dv), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, kv_block):
        kb = k[:, k0:k0 + kv_block].float()
        vb = v[:, k0:k0 + kv_block].float()
        s = torch.einsum("bqgd,bkd->bqgk", qs, kb)
        kpos = k0 + torch.arange(kv_block, device=q.device)
        msk = positional_mask(qpos, kpos, causal, window)
        s = torch.where(msk[None, :, None, :], s, NEG_INF)
        m_new = torch.maximum(m, s.amax(dim=-1))
        p = torch.exp(s - m_new[..., None])
        corr = torch.exp(m - m_new)
        l = l * corr + p.sum(dim=-1)
        acc = acc * corr[..., None] + torch.einsum("bqgk,bkd->bqgd", p, vb)
        m = m_new
    o = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return o, lse
