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
the caller passes the returned cache on and does not reuse the old one. Its
attend step has the same two routes: ``"flash"`` runs kernel K7 through
``kernels/flash_decode/ops.decode_attention`` over the written prefix of
the cache, where the reference's model computes the same function in jnp;
any other value runs the reference's inline code, which rounds the
probabilities to V's dtype before the P.V product.

MLA (``mla_*``, deepseek-v3) is the reference's: low-rank projections of q
and of a 512-wide latent ``c_kv`` beside a shared 64-wide rotary key
``k_rope``. Its prefill and training path materialises per-head K (192
wide: 128 from the latent, 64 rotary) and V (128 wide) and always takes the
plain blocked route ``flash_attention_xla``, as the reference's
``mla_apply`` does whatever ``rt.attn_impl`` says (K4 takes head dims up to
128). Its decode step caches only (c_kv, k_rope), absorbs ``w_uk`` into q
and attends in the latent; it writes the cache in place as the GQA step
does. Both norms of ``_mla_qkv`` take RMSNorm's default eps 1e-5, not
``cfg.norm_eps``, as the reference's do.

Cross-attention is the reference's ``kv_x``: ``attention_apply(...,
kv_x=e)`` takes K and V from the encoder output ``e`` (B, Se, D), applies
rope nowhere, and masks nothing, on both routes (K4 at Sq != Sk on
``"flash"``). Its decode step, ``cross_decode_apply``, attends over a
filled encoder cache (B, Se, Hkv, hd): on ``"flash"`` through K7 with every
row at full length, otherwise the reference's inline softmax, rounded step
by step as its ``decode_step`` rounds it.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.flash_attn import ops as flash_ops
from ..kernels.flash_decode import ops as decode_ops
from ..kernels.flash_attn.ref import positional_mask
from .blocks import apply_rope, rmsnorm
from .params import ParamSpec
from .runtime import Runtime, torch_dtype

__all__ = [
    "attention_specs", "attention_apply", "attention_decode_apply", "cross_decode_apply",
    "flash_attention_xla", "mla_specs", "mla_apply", "mla_decode_apply",
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
                    dtype: torch.dtype = torch.bfloat16, cross: bool = False
                    ) -> Dict[str, ParamSpec]:
    """The GQA block's weights; ``cross`` (an enc-dec decoder's
    cross-attention) takes the same shapes, as in the reference."""
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


def _project_qkv(p, x, cfg: ArchConfig, positions, kv_x=None, rope: bool = True):
    """q (B, S, Hkv, G, hd) from ``x``; k, v (B, Sk, Hkv, hd) from ``kv_x``
    (cross-attention) or ``x``; rope on q and k where ``rope`` says so."""
    hkv = cfg.n_kv_heads
    g = cfg.n_heads // hkv
    src = x if kv_x is None else kv_x
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    k = torch.einsum("bsd,dhe->bshe", src, p["wk"])
    v = torch.einsum("bsd,dhe->bshe", src, p["wv"])
    if rope and cfg.rope != "none":
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
    kv_x: Optional[torch.Tensor] = None,   # cross-attention source
) -> torch.Tensor:
    q, k, v = _project_qkv(p, x, cfg, positions, kv_x=kv_x, rope=kv_x is None)
    causal = causal and kv_x is None
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
    if rt.attn_impl == "flash":
        # the written slots: a prefix of min(pos + 1, S) keys in the linear
        # cache and in the ring alike
        lengths = torch.clamp(pos + 1, max=S).to(torch.int32)
        o = decode_ops.decode_attention(qg, kc, vc, lengths).reshape(B, 1, hq, hd)
        return torch.einsum("bshe,hed->bsd", o, p["wo"]), {"k": kc, "v": vc, "pos": pos + 1}
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


def cross_decode_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, 1, D), normed
    enc_k: torch.Tensor,                 # (B, Se, Hkv, hd), the encoder's K
    enc_v: torch.Tensor,
    cfg: ArchConfig,
    rt: Runtime,
) -> torch.Tensor:
    """One decode step of cross-attention over a filled encoder cache: no
    rope, no mask, nothing written. ``"flash"`` runs K7 with every row at
    length Se; otherwise the reference's inline code: the bf16 score
    product, float32 divided by sqrt(hd), the softmax, cast to V's dtype,
    then the P.V product."""
    B = x.shape[0]
    hq, hkv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = torch.einsum("bsd,dhe->bshe", x, p["wq"])
    qg = q.reshape(B, hkv, hq // hkv, hd)
    if rt.attn_impl == "flash":
        lengths = torch.full((B,), enc_k.shape[1], dtype=torch.int32, device=x.device)
        o = decode_ops.decode_attention(qg, enc_k, enc_v, lengths)
    else:
        s = torch.einsum("bhgd,bkhd->bhgk", qg, enc_k).float() / (hd ** 0.5)
        a = torch.softmax(s, dim=-1).to(enc_v.dtype)
        o = torch.einsum("bhgk,bkhd->bhgd", a, enc_v)
    return torch.einsum("bshe,hed->bsd", o.reshape(B, 1, hq, hd), p["wo"])


# ----------------------------------------------------------------------- MLA


def mla_specs(cfg: ArchConfig, stacked: Optional[int] = None,
              dtype: torch.dtype = torch.bfloat16) -> Dict[str, ParamSpec]:
    m = cfg.mla
    d, h = cfg.d_model, cfg.n_heads
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    return {
        "w_dq": ParamSpec(lead + (d, m.q_lora_rank), lx + ("embed", "rank"), dtype, "scaled"),
        "q_norm": ParamSpec(lead + (m.q_lora_rank,), lx + ("rank",), dtype, "ones"),
        "w_uq": ParamSpec(lead + (m.q_lora_rank, h, m.qk_nope_head_dim + m.qk_rope_head_dim),
                          lx + ("rank", "heads", "qk"), dtype, "scaled", fan_in_axis=-3),
        "w_dkv": ParamSpec(lead + (d, m.kv_lora_rank + m.qk_rope_head_dim),
                           lx + ("embed", "rank"), dtype, "scaled"),
        "kv_norm": ParamSpec(lead + (m.kv_lora_rank,), lx + ("rank",), dtype, "ones"),
        "w_uk": ParamSpec(lead + (m.kv_lora_rank, h, m.qk_nope_head_dim),
                          lx + ("rank", "heads", "qk"), dtype, "scaled", fan_in_axis=-3),
        "w_uv": ParamSpec(lead + (m.kv_lora_rank, h, m.v_head_dim),
                          lx + ("rank", "heads", "qk"), dtype, "scaled", fan_in_axis=-3),
        "wo": ParamSpec(lead + (h, m.v_head_dim, d), lx + ("heads", "qk", "embed"), dtype,
                        "scaled", fan_in_axis=-2),
    }


def _mla_qkv(p, x: torch.Tensor, cfg: ArchConfig, positions: torch.Tensor):
    """(q_nope (B,S,H,nope), q_rope (B,S,H,rope), c_kv (B,S,rkv), k_rope
    (B,S,1,rope)); both norms at the default eps, as the reference's."""
    m = cfg.mla
    cq = rmsnorm(x @ p["w_dq"], p["q_norm"])                         # (B,S,rq)
    q = torch.einsum("bsr,rhe->bshe", cq, p["w_uq"])                 # (B,S,H,nope+rope)
    q_nope, q_rope = q[..., :m.qk_nope_head_dim], q[..., m.qk_nope_head_dim:]
    q_rope = apply_rope(q_rope, positions)
    ckv_full = x @ p["w_dkv"]                                        # (B,S,rkv+rope)
    c_kv, k_rope = ckv_full[..., :m.kv_lora_rank], ckv_full[..., m.kv_lora_rank:]
    c_kv = rmsnorm(c_kv, p["kv_norm"])
    k_rope = apply_rope(k_rope[:, :, None, :], positions)            # (B,S,1,rope)
    return q_nope, q_rope, c_kv, k_rope


def mla_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig, rt: Runtime,
              positions: torch.Tensor, causal: bool = True) -> torch.Tensor:
    """Prefill/train MLA: per-head K/V materialised from the latent, the
    plain blocked attention whatever ``rt.attn_impl`` says."""
    m = cfg.mla
    B, S, _ = x.shape
    h = cfg.n_heads
    q_nope, q_rope, c_kv, k_rope = _mla_qkv(p, x, cfg, positions)
    k_nope = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uk"])
    v = torch.einsum("bsr,rhe->bshe", c_kv, p["w_uv"])
    q = torch.cat([q_nope, q_rope], dim=-1)                          # (B,S,H,192)
    k = torch.cat([k_nope, k_rope.expand(B, S, h, m.qk_rope_head_dim)], dim=-1)
    qg = q.reshape(B, S, h, 1, q.shape[-1])                          # Hkv = H
    o = flash_attention_xla(
        qg, k, v, causal=causal, q_chunk=rt.attn_chunk, kv_chunk=rt.attn_chunk,
        softmax_dtype=torch_dtype(rt.softmax_dtype),
    ).reshape(B, S, h, m.v_head_dim)
    return torch.einsum("bshe,hed->bsd", o, p["wo"])


def mla_decode_apply(
    p: Dict[str, torch.Tensor],
    x: torch.Tensor,                     # (B, 1, D)
    cache: Dict[str, torch.Tensor],      # {"c_kv": (B, S, rkv), "k_rope": (B, S, rope), "pos"}
    cfg: ArchConfig,
    rt: Runtime,
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Absorbed-matmul MLA decode: the new latent and rotary key written into
    the cache in place, attention in the latent space, the softmax cast to
    the cache's dtype before the context product."""
    m = cfg.mla
    B = x.shape[0]
    pos = cache["pos"]
    ckv, krope = cache["c_kv"], cache["k_rope"]
    S = ckv.shape[1]
    q_nope, q_rope, c_kv_new, k_rope_new = _mla_qkv(p, x, cfg, pos[:, None])
    slot = torch.clamp(pos, max=S - 1).long()
    bidx = torch.arange(B, device=x.device)
    ckv[bidx, slot] = c_kv_new[:, 0]
    krope[bidx, slot] = k_rope_new[:, 0, 0]
    q_lat = torch.einsum("bshe,rhe->bshr", q_nope, p["w_uk"])       # (B,1,H,rkv)
    s = torch.einsum("bhr,bkr->bhk", q_lat[:, 0], ckv)
    s = s + torch.einsum("bhe,bke->bhk", q_rope[:, 0], krope)
    s = s.float() / ((m.qk_nope_head_dim + m.qk_rope_head_dim) ** 0.5)
    valid = torch.arange(S, device=x.device)[None, :] <= pos[:, None]
    s = torch.where(valid[:, None, :], s, NEG_INF)
    a = torch.softmax(s, dim=-1).to(ckv.dtype)
    ctx = torch.einsum("bhk,bkr->bhr", a, ckv)                       # latent context
    o = torch.einsum("bhr,rhe->bhe", ctx, p["w_uv"])                 # (B,H,v_dim)
    out = torch.einsum("bhe,hed->bd", o, p["wo"])[:, None, :]
    return out, {"c_kv": ckv, "k_rope": krope, "pos": pos + 1}
