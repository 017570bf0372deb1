"""Plain PyTorch versions of flash attention (kernels K4, K5 and K6).

``attention_ref`` is the oracle of the reference's ``flash_attn/ref.py``:
full float32 scores, positional mask, softmax, in the model's grouped
layout (B, S, Hkv, G, D). The others compute what the kernels compute, in
the kernels' layout (BH, S, G, D):

- ``flash_fwd_plain`` (K4): the FlashAttention-2 forward recurrence of
  ``_fwd_kernel`` (q upcast and scaled by 1/sqrt(D), online softmax in
  float32 over KV blocks of ``kv_block`` keys, masked score -1e30),
  returning o in q's dtype and lse in float32. Query rows are independent,
  so it runs every q block at once. With ``p_parts`` it states the P . V
  arithmetic of K4's bf16 route instead: p enters the product as
  ``bf16_parts`` (one bf16 value, or hi + lo halves) with float32 sums.
- ``flash_dq_plain`` (K5) and ``flash_dkv_plain`` (K6): the backward
  recurrences of ``_dq_kernel`` (a sum over KV blocks) and ``_dkv_kernel``
  (a sum over q blocks). Each recomputes s = (q * scale) . k^T in float32,
  masks it to -1e30, takes p = exp(s - lse) and ds = p * (dp - delta) *
  scale with dp = do . v^T; dq = sum ds . k, dv = sum p^T . do, dk = sum
  ds^T . q, each returned in q's, v's and k's dtype. A row that sees no
  key has lse = -1e30, so every key gets p = 1 there, as in the reference.
  With ``ds_parts`` (both) and ``p_parts`` (K6) they state the second-stage
  arithmetic of K5's and K6's bf16 routes instead: ds enters ds . k and
  ds^T . q, and p enters p^T . do, as ``bf16_parts`` with float32 sums.
"""

from __future__ import annotations

import math
from typing import List, Optional, Tuple

import torch

__all__ = [
    "NEG_INF", "attention_ref", "bf16_parts", "check_blocks", "flash_dkv_plain",
    "flash_dq_plain", "flash_fwd_plain", "positional_mask",
]

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


def bf16_parts(p: torch.Tensor, parts: int) -> List[torch.Tensor]:
    """float32 ``p`` as ``parts`` bf16-valued float32 tensors whose sum
    approximates it: one part is bf16(p), 2**-9 relative; two are hi =
    bf16(p) and lo = bf16(p - hi) (p - hi is exact in float32), about 16
    bits of p, the A operands of K4's two P . V products."""
    if parts not in (1, 2):
        raise ValueError(f"bf16_parts: parts must be 1 or 2, got {parts}")
    hi = p.to(torch.bfloat16).float()
    return [hi] if parts == 1 else [hi, (p - hi).to(torch.bfloat16).float()]


def _parts_sum(eq: str, x: torch.Tensor, y: torch.Tensor, parts: Optional[int]) -> torch.Tensor:
    """``einsum(eq, x, y)``, with x fed as ``bf16_parts(x, parts)`` (float32
    sums of each part's product) when ``parts`` is given."""
    xs = [x] if parts is None else bf16_parts(x, parts)
    out = torch.einsum(eq, xs[0], y)
    for part in xs[1:]:
        out = out + torch.einsum(eq, part, y)
    return out


def flash_fwd_plain(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, q_block: int = 128, kv_block: int = 128,
                    p_parts: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """q (BH, Sq, G, D), k/v (BH, Sk, D*) -> (o (BH, Sq, G, Dv), lse (BH, Sq, G)).
    ``p_parts`` (1 or 2) feeds P . V ``bf16_parts(p, p_parts)``; by default
    p stays float32, the reference's product."""
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
        acc = acc * corr[..., None] + _parts_sum("bqgk,bkd->bqgd", p, vb, p_parts)
        m = m_new
    o = (acc / torch.clamp(l, min=1e-30)[..., None]).to(q.dtype)
    lse = m + torch.log(torch.clamp(l, min=1e-30))
    return o, lse


def _probs(qs, kb, lse, qpos, kpos, causal: bool, window: Optional[int]) -> torch.Tensor:
    """p = exp(s - lse) of one block: qs (BH, Sq', G, D) scaled float32, kb
    (BH, Sk', D) float32, lse (BH, Sq', G); masked scores are -1e30."""
    s = torch.einsum("bqgd,bkd->bqgk", qs, kb)
    msk = positional_mask(qpos, kpos, causal, window)
    s = torch.where(msk[None, :, None, :], s, NEG_INF)
    return torch.exp(s - lse[..., None])


def flash_dq_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                   window: Optional[int] = None, q_offset: int = 0, q_block: int = 128,
                   kv_block: int = 128, ds_parts: Optional[int] = None) -> torch.Tensor:
    """q/do (BH, Sq, G, D), k/v (BH, Sk, D), lse/delta (BH, Sq, G) float32 ->
    dq (BH, Sq, G, D) in q's dtype, summed over KV blocks of ``kv_block``.
    ``ds_parts`` (1 or 2) feeds ds . k ``bf16_parts(ds, ds_parts)``; by
    default ds stays float32, the reference's product."""
    BH, Sq, G, D = q.shape
    Sk = k.shape[1]
    _, kv_block = check_blocks(Sq, Sk, q_block, kv_block)
    scale = 1.0 / math.sqrt(D)
    qs = q.float() * scale
    do32 = do.float()
    qpos = q_offset + torch.arange(Sq, device=q.device)
    dq = torch.zeros((BH, Sq, G, D), dtype=torch.float32, device=q.device)
    for k0 in range(0, Sk, kv_block):
        kb = k[:, k0:k0 + kv_block].float()
        vb = v[:, k0:k0 + kv_block].float()
        kpos = k0 + torch.arange(kv_block, device=q.device)
        p = _probs(qs, kb, lse, qpos, kpos, causal, window)
        dp = torch.einsum("bqgd,bkd->bqgk", do32, vb)
        ds = p * (dp - delta[..., None]) * scale
        dq = dq + _parts_sum("bqgk,bkd->bqgd", ds, kb, ds_parts)
    return dq.to(q.dtype)


def flash_dkv_plain(q, k, v, do, lse, delta, *, causal: bool = True,
                    window: Optional[int] = None, q_offset: int = 0, q_block: int = 128,
                    kv_block: int = 128, p_parts: Optional[int] = None,
                    ds_parts: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same inputs as :func:`flash_dq_plain` -> (dk (BH, Sk, D) in k's
    dtype, dv (BH, Sk, Dv) in v's dtype), summed over q blocks of
    ``q_block`` rows (all G query heads of each position). ``p_parts`` and
    ``ds_parts`` (1 or 2) feed p^T . do and ds^T . q ``bf16_parts`` of p
    and ds; by default both stay float32, the reference's products."""
    BH, Sq, G, D = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    q_block, _ = check_blocks(Sq, Sk, q_block, kv_block)
    scale = 1.0 / math.sqrt(D)
    k32, v32 = k.float(), v.float()
    kpos = torch.arange(Sk, device=q.device)
    dk = torch.zeros((BH, Sk, D), dtype=torch.float32, device=q.device)
    dv = torch.zeros((BH, Sk, Dv), dtype=torch.float32, device=q.device)
    for q0 in range(0, Sq, q_block):
        qb = q[:, q0:q0 + q_block].float()
        dob = do[:, q0:q0 + q_block].float()
        qpos = q_offset + q0 + torch.arange(q_block, device=q.device)
        p = _probs(qb * scale, k32, lse[:, q0:q0 + q_block], qpos, kpos, causal, window)
        dv = dv + _parts_sum("bqgk,bqgd->bkd", p, dob, p_parts)
        dp = torch.einsum("bqgd,bkd->bqgk", dob, v32)
        ds = p * (dp - delta[:, q0:q0 + q_block, :, None]) * scale
        dk = dk + _parts_sum("bqgk,bqgd->bkd", ds, qb, ds_parts)
    return dk.to(k.dtype), dv.to(v.dtype)
