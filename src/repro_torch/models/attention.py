"""Attention: GQA (causal / bidirectional / sliding-window) and its decode step.

The prefill and training path has two routes, chosen by
``Runtime.attn_impl`` as in the reference. ``"flash"`` runs kernel K4
forward and K5/K6 backward through ``kernels/flash_attn/ops.flash_attention``.
Any other value runs ``flash_attention_xla``: the reference's
double-blocked, flash-style attention (a loop over query blocks, an inner
loop over KV chunks with a running logsumexp) in plain PyTorch, so S x S
score matrices are never materialised, with the reference's custom
backward as a ``torch.autograd.Function``: it keeps q, k, v, out and lse
and recomputes p from lse in two block sweeps (dq over q blocks; dk and dv
over KV blocks). The reference computes that route outside any Pallas
kernel, and so does the port. Its casts are the reference's: scores from a
compute-dtype product are rounded to that dtype before the softmax dtype
and the scale, ``p`` is cast to v's dtype before the P.V product, the
backward's products run in the softmax dtype, and dq, dk and dv are cast
back per block to q's, k's and v's dtypes.

GQA is computed in grouped layout (B, S, Hkv, G, D) so repeated KV heads
are never materialised. ``attention_decode_apply`` writes the new K/V into
the cache tensors it is given, in place (the reference returns new arrays);
the caller passes the returned cache on and does not reuse the old one.
MLA (``mla_*``) comes with the MoE family and cross-attention (the
reference's ``kv_x``) with the enc-dec family.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attn import ops as flash_ops
from ..kernels.flash_attn.ref import positional_mask
from .blocks import apply_rope
from .params import ParamSpec
from .runtime import Runtime, torch_dtype

__all__ = [
    "attention_specs", "attention_apply", "attention_decode_apply", "flash_attention_xla",
]

NEG_INF = -1e30
MROPE_SECTIONS = (16, 24, 24)


def _blk_bias(qpos: torch.Tensor, kpos: torch.Tensor, causal: bool, window: Optional[int],
              dt: torch.dtype) -> torch.Tensor:
    """Additive (qc, kc) mask bias: 0 where visible, -1e30 elsewhere."""
    mask = positional_mask(qpos, kpos, causal, window)
    return torch.where(mask, 0.0, NEG_INF).to(dt)


def _flash_fwd(q, k, v, causal, window, q_offset, q_chunk, kv_chunk, sm_dt):
    """Returns (out, lse). Shapes: q (B,Sq,Hkv,G,Dqk), k/v (B,Sk,Hkv,D*)."""
    B, Sq, Hkv, G, Dqk = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    dev = q.device
    scale = 1.0 / (Dqk ** 0.5)
    qpb = torch.arange(q_chunk, device=dev)
    kpb = torch.arange(kv_chunk, device=dev)
    outs, lses = [], []
    for q0 in range(0, Sq, q_chunk):
        qblk = q[:, q0:q0 + q_chunk]
        m = torch.full((B, q_chunk, Hkv, G), NEG_INF, dtype=sm_dt, device=dev)
        l = torch.zeros((B, q_chunk, Hkv, G), dtype=sm_dt, device=dev)
        o = torch.zeros((B, q_chunk, Hkv, G, Dv), dtype=sm_dt, device=dev)
        for k0 in range(0, Sk, kv_chunk):
            kblk = k[:, k0:k0 + kv_chunk]
            vblk = v[:, k0:k0 + kv_chunk]
            s = torch.einsum("bqhgd,bkhd->bqhgk", qblk, kblk).to(sm_dt) * scale
            bias = _blk_bias(q_offset + q0 + qpb, k0 + kpb, causal, window, sm_dt)
            s = s + bias[None, :, None, None, :]
            m_new = torch.maximum(m, s.amax(dim=-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(dim=-1)
            o = o * corr[..., None] + torch.einsum(
                "bqhgk,bkhd->bqhgd", p.to(vblk.dtype), vblk).to(sm_dt)
            m = m_new
        outs.append((o / torch.clamp(l[..., None], min=1e-30)).to(q.dtype))
        lses.append(m + torch.log(torch.clamp(l, min=1e-30)))
    return torch.cat(outs, dim=1), torch.cat(lses, dim=1)


def _flash_bwd_impl(q, k, v, o, lse, do, causal, window, q_offset, q_chunk, kv_chunk, sm_dt):
    """FlashAttention-2 backward: recompute p per block from lse; two block
    sweeps (dq over q blocks; dk/dv over KV blocks)."""
    B, Sq, Hkv, G, Dqk = q.shape
    Sk, Dv = k.shape[1], v.shape[-1]
    dev = q.device
    scale = 1.0 / (Dqk ** 0.5)
    qpb = torch.arange(q_chunk, device=dev)
    kpb = torch.arange(kv_chunk, device=dev)
    dsum = (do.to(sm_dt) * o.to(sm_dt)).sum(dim=-1)     # D_i = rowsum(do * o)

    def p_block(qblk, kblk, lse_i, q0, k0):
        s = torch.einsum("bqhgd,bkhd->bqhgk", qblk, kblk).to(sm_dt) * scale
        bias = _blk_bias(q_offset + q0 + qpb, k0 + kpb, causal, window, sm_dt)
        return torch.exp(s + bias[None, :, None, None, :] - lse_i[..., None])

    def q_slices(q0):
        sl = slice(q0, q0 + q_chunk)
        return q[:, sl], do[:, sl].to(sm_dt), lse[:, sl], dsum[:, sl]

    # pass 1: dq, over KV blocks inside each q block
    dq = torch.empty_like(q)
    for q0 in range(0, Sq, q_chunk):
        qblk, do_i, lse_i, d_i = q_slices(q0)
        acc = torch.zeros((B, q_chunk, Hkv, G, Dqk), dtype=sm_dt, device=dev)
        for k0 in range(0, Sk, kv_chunk):
            kblk, vblk = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
            p = p_block(qblk, kblk, lse_i, q0, k0)
            dp = torch.einsum("bqhgd,bkhd->bqhgk", do_i, vblk.to(sm_dt))
            ds = p * (dp - d_i[..., None]) * scale
            acc = acc + torch.einsum("bqhgk,bkhd->bqhgd", ds, kblk.to(sm_dt))
        dq[:, q0:q0 + q_chunk] = acc.to(q.dtype)

    # pass 2: dk/dv, over q blocks inside each KV block
    dk, dv = torch.empty_like(k), torch.empty_like(v)
    for k0 in range(0, Sk, kv_chunk):
        kblk, vblk = k[:, k0:k0 + kv_chunk], v[:, k0:k0 + kv_chunk]
        dk_acc = torch.zeros((B, kv_chunk, Hkv, Dqk), dtype=sm_dt, device=dev)
        dv_acc = torch.zeros((B, kv_chunk, Hkv, Dv), dtype=sm_dt, device=dev)
        for q0 in range(0, Sq, q_chunk):
            qblk, do_i, lse_i, d_i = q_slices(q0)
            p = p_block(qblk, kblk, lse_i, q0, k0)
            dv_acc = dv_acc + torch.einsum("bqhgk,bqhgd->bkhd", p, do_i)
            dp = torch.einsum("bqhgd,bkhd->bqhgk", do_i, vblk.to(sm_dt))
            ds = p * (dp - d_i[..., None]) * scale
            dk_acc = dk_acc + torch.einsum("bqhgk,bqhgd->bkhd", ds, qblk.to(sm_dt))
        dk[:, k0:k0 + kv_chunk] = dk_acc.to(k.dtype)
        dv[:, k0:k0 + kv_chunk] = dv_acc.to(v.dtype)
    return dq, dk, dv


class _FlashCore(torch.autograd.Function):
    """The reference's ``_flash_core`` custom VJP: the blocked forward,
    keeping (q, k, v, out, lse), and :func:`_flash_bwd_impl` as backward."""

    @staticmethod
    def forward(ctx, q, k, v, causal, window, q_offset, q_chunk, kv_chunk, sm_dt):
        out, lse = _flash_fwd(q, k, v, causal, window, q_offset, q_chunk, kv_chunk, sm_dt)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, window, q_offset, q_chunk, kv_chunk, sm_dt)
        return out

    @staticmethod
    def backward(ctx, do):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = _flash_bwd_impl(q, k, v, out, lse, do, *ctx.args)
        return dq, dk, dv, None, None, None, None, None, None


def flash_attention_xla(
    q: torch.Tensor,        # (B, Sq, Hkv, G, Dqk)
    k: torch.Tensor,        # (B, Sk, Hkv, Dqk)
    v: torch.Tensor,        # (B, Sk, Hkv, Dv)
    *,
    causal: bool = True,
    window: Optional[int] = None,
    q_offset: int = 0,       # absolute position of q[0] (prefill continuation)
    q_chunk: int = 1024,
    kv_chunk: int = 1024,
    softmax_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """Memory-efficient attention, the reference's route of the same name
    (custom backward: p recomputed from lse). Returns (B, Sq, Hkv, G, Dv)."""
    Sq, Sk = q.shape[1], k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Sk)
    while Sq % q_chunk:
        q_chunk //= 2
    while Sk % kv_chunk:
        kv_chunk //= 2
    return _FlashCore.apply(q, k, v, causal, window, q_offset, q_chunk, kv_chunk, softmax_dtype)


# ------------------------------------------------------------------ GQA block


def attention_specs(cfg: ArchConfig, stacked: Optional[int] = None,
                    dtype: torch.dtype = torch.bfloat16) -> Dict[str, ParamSpec]:
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead = (stacked,) if stacked else ()
    lax_ = ("layers",) if stacked else ()
    return {
        "wq": ParamSpec(lead + (d, hq, hd), lax_ + ("embed", "heads", "qk"), dtype, "scaled", fan_in_axis=-3),
        "wk": ParamSpec(lead + (d, hkv, hd), lax_ + ("embed", "kv_heads", "qk"), dtype, "scaled", fan_in_axis=-3),
        "wv": ParamSpec(lead + (d, hkv, hd), lax_ + ("embed", "kv_heads", "qk"), dtype, "scaled", fan_in_axis=-3),
        "wo": ParamSpec(lead + (hq, hd, d), lax_ + ("heads", "qk", "embed"), dtype, "scaled", fan_in_axis=-2),
    }


def _rope(x, positions, cfg: ArchConfig):
    if cfg.rope == "mrope":
        return apply_rope(x, positions, mrope_sections=MROPE_SECTIONS)
    return apply_rope(x, positions)


def _project_qkv(p, x, cfg: ArchConfig, positions):
    hkv = cfg.n_kv_heads
    g = cfg.n_heads // hkv
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    if cfg.rope != "none":
        q = _rope(q, positions, cfg)
        k = _rope(k, positions, cfg)
    B, S = x.shape[:2]
    q = q.reshape(B, S, hkv, g, cfg.head_dim)
    return q, k, v


def attention_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,
    cfg: ArchConfig,
    rt: Runtime,
    positions: torch.Tensor,
    causal: bool = True,
) -> torch.Tensor:
    q, k, v = _project_qkv(p, x, cfg, positions)
    if rt.attn_impl == "flash":
        o = flash_ops.flash_attention(
            q, k, v, causal=causal, window=cfg.window,
            q_block=rt.q_block, kv_block=rt.kv_block,
        )
    else:
        o = flash_attention_xla(
            q, k, v,
            causal=causal,
            window=cfg.window,
            q_chunk=rt.attn_chunk, kv_chunk=rt.attn_chunk,
            softmax_dtype=torch_dtype(rt.softmax_dtype),
        )
    B, S = x.shape[:2]
    o = o.reshape(B, S, cfg.n_heads, cfg.head_dim)
    return torch.einsum("bshe,hed->bsd", o, p["wo"])


def attention_decode_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, 1, D)
    cache: Dict[str, torch.Tensor],      # {"k": (B, S, Hkv, hd), "v": ..., "pos": (B,)}
    cfg: ArchConfig,
    rt: Runtime,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    B = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    g = hq // hkv
    pos = cache["pos"]                   # (B,) current length
    kc, vc = cache["k"], cache["v"]
    S = kc.shape[1]
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", x, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", x, p["wv"])
    if cfg.rope != "none":
        posb = pos[:, None]
        if cfg.rope == "mrope":
            posb = posb[..., None].expand(B, 1, 3)
        q = _rope(q, posb, cfg)
        k = _rope(k, posb, cfg)
    # ring-buffer write (sliding window) or linear write, in place
    ring = cfg.window is not None and S == cfg.window
    slot = pos % S if ring else torch.clamp(pos, max=S - 1)
    bidx = torch.arange(B, device=x.device)
    kc[bidx, slot.long()] = k[:, 0]
    vc[bidx, slot.long()] = v[:, 0]
    # attend: q (B,hkv,g,hd) over the cache (B,S,hkv,hd)
    qg = q.reshape(B, hkv, g, hd)
    s = torch.einsum("bhgd,bkhd->bhgk", qg, kc)
    s = s.float() / (hd ** 0.5)
    kpos = torch.arange(S, device=x.device)[None, :]                 # (1, S)
    if ring:
        valid = kpos < torch.clamp(pos + 1, max=S)[:, None]          # all written slots
    else:
        valid = kpos <= pos[:, None]
    s = torch.where(valid[:, None, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(vc.dtype)
    o = torch.einsum("bhgk,bkhd->bhgd", a, vc).reshape(B, 1, hq, hd)
    out = torch.einsum("bshe,hed->bsd", o, p["wo"])
    return out, {"k": kc, "v": vc, "pos": pos + 1}
