"""Model assembly: param specs, forward, cache and decode for the dense
family (``dense``, and the ``vlm`` backbone, which shares its code path).

Layer stacks are *stacked* (leading "layers" axis) as in the reference,
which scans over them; the port runs a Python loop over layer slices, and
autograd sums each slice's gradient into the stacked leaf. The other
families (MoE, MLA, SSM, hybrid, enc-dec) raise ``NotImplementedError``
naming their ``ROADMAP.md`` item.

The loss (``loss_fn``) is the next-token cross-entropy of ``chunked_ce``
over the hidden states that ``forward(..., return_hidden=True)`` returns.
Only ``Runtime.remat == "none"`` is taken (the value the reference's
training launcher uses); DeepSeek's multi-token prediction comes with the
MoE family.

The decode path operates on a cache dict stacked over layers: K and V of
shape (L, B, S, Hkv, hd) and ``pos`` (B,). ``decode_step`` writes the new
K/V into those tensors in place and returns the same tensors with ``pos``
advanced (the reference returns new arrays); do not reuse a cache after
passing it on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from .attention import attention_apply, attention_decode_apply, attention_specs
from .blocks import ffn_apply, ffn_specs, mrope_positions, rmsnorm
from .params import ParamSpec, tree_map
from .runtime import Runtime

__all__ = ["build_param_specs", "chunked_ce", "forward", "decode_step", "init_cache", "loss_fn"]

_DENSE = ("dense", "vlm")
_TODO = {
    "moe": "10(c) (the MoE family, with MLA)",
    "ssm": "10(c) (the SSM family: RWKV6)",
    "hybrid": "10(c) (the hybrid family: Mamba2 with shared attention)",
    "encdec": "10(c) (the enc-dec family)",
}


def _require_dense(cfg: ArchConfig) -> None:
    if cfg.family in _DENSE:
        return
    item = _TODO.get(cfg.family)
    if item is None:
        raise ValueError(f"unknown family {cfg.family!r}")
    raise NotImplementedError(
        f"{cfg.name}: family {cfg.family!r} is not ported yet (ROADMAP.md item {item})")


def _ln(stacked: Optional[int], d: int, dtype: torch.dtype) -> ParamSpec:
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    return ParamSpec(lead + (d,), lx + ("embed",), dtype, "ones")


def _layer(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    return tree_map(lambda a: a[i], stacked)


# =========================================================== param specs


def build_param_specs(cfg: ArchConfig, rt: Optional[Runtime] = None):
    _require_dense(cfg)
    rt = rt or Runtime()
    dt = rt.pdtype
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    specs: Dict[str, Any] = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), dt, "normal"),
        "final_ln": _ln(None, d, dt),
    }
    if not cfg.tie_embeddings:
        specs["out"] = ParamSpec((V, d), ("vocab", "embed"), dt, "scaled", fan_in_axis=-1)
    specs["blocks"] = {
        "attn": attention_specs(cfg, stacked=L, dtype=dt),
        "ffn": ffn_specs(d, cfg.d_ff, cfg.act, stacked=L, dtype=dt),
        "ln1": _ln(L, d, dt),
        "ln2": _ln(L, d, dt),
    }
    return specs


# =============================================================== forward


def _head(params, cfg: ArchConfig) -> torch.Tensor:
    return params["embed"] if cfg.tie_embeddings else params["out"]


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return torch.einsum("bsd,vd->bsv", x, _head(params, cfg))


def forward(
    params,
    cfg: ArchConfig,
    rt: Runtime,
    tokens: Optional[torch.Tensor] = None,        # (B, S) integer
    inputs_embeds: Optional[torch.Tensor] = None,  # (B, S, D) modality stub
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Returns logits (B, S, V) in the compute dtype, or with
    ``return_hidden`` the hidden states (B, S, D) after ``final_ln``."""
    _require_dense(cfg)
    if inputs_embeds is not None:
        x = inputs_embeds.to(rt.cdtype)
    else:
        x = params["embed"][tokens.long()].to(rt.cdtype)
    B, S = x.shape[:2]
    if positions is None:
        if cfg.rope == "mrope":
            positions = mrope_positions(B, S, device=x.device)
        else:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)

    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        p = _layer(blocks, i)
        x = x + attention_apply(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, rt,
                                positions, causal)
        x = x + ffn_apply(p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.act)
    if return_hidden:
        return rmsnorm(x, params["final_ln"], cfg.norm_eps)
    return _logits(params, cfg, x)


# ================================================================= loss


class _HeadLogits(torch.autograd.Function):
    """x (N, D) . w (V, D)^T -> float32 logits (N, V) from the stored dtype
    without rounding, as ``preferred_element_type=jnp.float32`` takes them,
    and without a float32 copy of the whole head: on the card a bf16
    product writes float32 (``out_dtype``); otherwise, and in the backward
    on both devices, the head is upcast ``_VOCAB_SLAB`` rows at a time.
    The gradients are the float32 products, cast to x's and w's dtypes."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        if x.device.type == "cuda" and x.dtype == w.dtype == torch.bfloat16:
            return torch.mm(x, w.t(), out_dtype=torch.float32)
        out = torch.empty((x.shape[0], w.shape[0]), dtype=torch.float32, device=x.device)
        x32 = x.float()
        for v0 in range(0, w.shape[0], _VOCAB_SLAB):
            out[:, v0:v0 + _VOCAB_SLAB] = x32 @ w[v0:v0 + _VOCAB_SLAB].float().t()
        return out

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        x32 = x.float()
        gx = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
        gw = torch.empty_like(w)
        for v0 in range(0, w.shape[0], _VOCAB_SLAB):
            gs = g[:, v0:v0 + _VOCAB_SLAB]
            gx += gs @ w[v0:v0 + _VOCAB_SLAB].float()
            gw[v0:v0 + _VOCAB_SLAB] = (gs.t() @ x32).to(w.dtype)
        return gx.to(x.dtype), gw


_VOCAB_SLAB = 16384  # head rows upcast at a time: 256 MB of float32 at d_model 4096


def _chunk_ce_sum(xk: torch.Tensor, out_w: torch.Tensor, lk: torch.Tensor) -> torch.Tensor:
    """Summed next-token CE of one chunk: xk (B, c, D), lk (B, c)."""
    B, c, D = xk.shape
    lg = _HeadLogits.apply(xk.reshape(B * c, D), out_w)
    lse = torch.logsumexp(lg, dim=-1)
    gold = lg.gather(-1, lk.reshape(B * c, 1).long())[:, 0]
    return (lse - gold).sum()


def chunked_ce(x: torch.Tensor, out_w: torch.Tensor, labels: torch.Tensor,
               chunk: int = 512) -> torch.Tensor:
    """Mean cross-entropy over the vocab head without materialising (B, S, V).

    Loops over sequence chunks (halved until they divide S, as the
    reference does); each chunk's float32 logits live only inside the
    checkpointed chunk body and are recomputed in the backward
    (``torch.utils.checkpoint``, the reference's ``jax.checkpoint``). The
    gold logit is gathered, which equals the reference's one-hot sum."""
    B, S, D = x.shape
    chunk = min(chunk, S)
    while S % chunk:
        chunk //= 2
    tot = torch.zeros((), dtype=torch.float32, device=x.device)
    for s0 in range(0, S, chunk):
        xk, lk = x[:, s0:s0 + chunk], labels[:, s0:s0 + chunk]
        if torch.is_grad_enabled():
            tot = tot + checkpoint(_chunk_ce_sum, xk, out_w, lk, use_reentrant=False)
        else:
            tot = tot + _chunk_ce_sum(xk, out_w, lk)
    return tot / (B * S)


def loss_fn(params, cfg: ArchConfig, rt: Runtime, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token CE of the ``dense`` and ``vlm`` families."""
    _require_dense(cfg)
    if rt.remat != "none":
        raise NotImplementedError(
            f"Runtime.remat={rt.remat!r} is not ported yet (ROADMAP.md item 11, with the "
            f"memory scheduling of the distribution work); use remat='none'")
    if cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: multi-token prediction is not ported yet (ROADMAP.md item 10(c))")
    x = forward(params, cfg, rt, tokens=batch.get("tokens"),
                inputs_embeds=batch.get("inputs_embeds"), positions=batch.get("positions"),
                return_hidden=True)
    return chunked_ce(x, _head(params, cfg), batch["labels"])


# ================================================================ decode


def _cache_len(cfg: ArchConfig, max_len: int) -> int:
    if cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len


def init_cache(cfg: ArchConfig, rt: Runtime, batch: int, max_len: int, enc_len: int = 0,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Stacked-over-layers cache dict. ``pos`` counts tokens generated."""
    _require_dense(cfg)
    dev = resolve_device(device)
    S = _cache_len(cfg, max_len)
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=rt.cdtype, device=dev),
        "v": torch.zeros(shape, dtype=rt.cdtype, device=dev),
        "pos": torch.zeros((batch,), dtype=torch.int32, device=dev),
    }


def decode_step(params, cfg: ArchConfig, rt: Runtime, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor):
    """One decode step. tokens: (B, 1) -> logits (B, 1, V), cache."""
    _require_dense(cfg)
    x = params["embed"][tokens.long()].to(rt.cdtype)
    pos = cache["pos"]
    blocks = params["blocks"]
    for i in range(cfg.n_layers):
        p = _layer(blocks, i)
        sub = {"k": cache["k"][i], "v": cache["v"][i], "pos": pos}
        a, _ = attention_decode_apply(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), sub, cfg, rt)
        x = x + a
        x = x + ffn_apply(p["ffn"], rmsnorm(x, p["ln2"], cfg.norm_eps), cfg.act)
    return _logits(params, cfg, x), {"k": cache["k"], "v": cache["v"], "pos": pos + 1}
