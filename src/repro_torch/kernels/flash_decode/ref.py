"""Plain PyTorch versions of split-KV decode attention (kernel K7).

``decode_plain`` computes what ``flash_decode_pallas`` computes, in its
order: the cache is cut into ``splits`` equal splits; each split walks its
keys in blocks of ``kv_block`` with an online softmax in float32 (q upcast
and scaled by 1/sqrt(D), masked scores at -1e30) and keeps an
unnormalised partial o with its running max m and sum l; the partials are
merged by the log-sum-exp algebra, o = sum_s exp(m_s - m) o_s / max(sum_s
exp(m_s - m) l_s, 1e-30) with m the largest m_s, and o is rounded to q's
dtype. A row of length 0 masks every key: each split's m stays -1e30, every
p is exp(0) = 1, and the row gets the mean of V over the whole cache, as
the Pallas kernel and ``decode_ref`` give it.

``decode_ref`` is the reference's oracle (``flash_decode/ref.py``), kept
for the tests.
"""

from __future__ import annotations

import math

import torch

__all__ = ["NEG_INF", "decode_plain", "decode_ref"]

NEG_INF = -1e30


def decode_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, lengths: torch.Tensor,
                 splits: int, kv_block: int) -> torch.Tensor:
    """q (B, Hkv, G, D); k, v (B, S, Hkv, D); lengths (B,) valid prefix of
    each row; ``splits`` and ``kv_block`` as the reference cuts them (the
    blocks divide each split) -> o (B, Hkv, G, D) in q's dtype."""
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    split = S // splits
    qs = q.float() * (1.0 / math.sqrt(D))
    kpb = torch.arange(kv_block, device=q.device)
    os_, ms, ls = [], [], []
    for si in range(splits):
        m = torch.full((B, Hkv, G), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros((B, Hkv, G), dtype=torch.float32, device=q.device)
        acc = torch.zeros((B, Hkv, G, D), dtype=torch.float32, device=q.device)
        for base in range(si * split, (si + 1) * split, kv_block):
            kb = k[:, base:base + kv_block].float()
            vb = v[:, base:base + kv_block].float()
            s = torch.einsum("bhgd,bkhd->bhgk", qs, kb)
            valid = (base + kpb)[None, :] < lengths[:, None]           # (B, kb)
            s = torch.where(valid[:, None, None, :], s, NEG_INF)
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum("bhgk,bkhd->bhgd", p, vb)
            m = m_new
        os_.append(acc)
        ms.append(m)
        ls.append(l)
    o, m, l = torch.stack(os_, 2), torch.stack(ms, 2), torch.stack(ls, 2)   # split axis 2
    m_all = m.amax(dim=2, keepdim=True)
    corr = torch.exp(m - m_all)
    denom = (corr * l).sum(dim=2)
    o = (o * corr[..., None]).sum(dim=2) / torch.clamp(denom, min=1e-30)[..., None]
    return o.to(q.dtype)


def decode_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
               lengths: torch.Tensor) -> torch.Tensor:
    """q (B, Hkv, G, D); k/v (B, S, Hkv, D); lengths (B,) valid prefix ->
    (B, Hkv, G, D) in q's dtype: one softmax over the masked scores."""
    S = k.shape[1]
    s = torch.einsum("bhgd,bkhd->bhgk", q.float(), k.float()) / math.sqrt(q.shape[-1])
    valid = torch.arange(S, device=q.device)[None, :] < lengths[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    return torch.einsum("bhgk,bkhd->bhgd", p, v.float()).to(q.dtype)
