"""Model assembly: param specs, forward, cache and decode for the dense
family (``dense``, and the ``vlm`` backbone, which shares its code path),
the MoE family without MLA (mixtral-8x22b: leading dense blocks, if any,
then blocks whose FFN is ``moe_apply``), the SSM family (rwkv6-7b: a
time-mix block, ``rwkv6_apply``, and a channel-mix block, ``_rwkv_cmix``,
each behind an RMSNorm) and the hybrid family (zamba2-2.7b: groups of
``attn_every`` Mamba2 blocks, ``mamba2_apply`` behind an RMSNorm, each
group followed by one shared attention + FFN block whose parameters every
group reuses).

Layer stacks are *stacked* (leading "layers" axis) as in the reference,
which scans over them; the port runs a Python loop over layer slices, and
autograd sums each slice's gradient into the stacked leaf. What is not
ported raises ``NotImplementedError`` naming its ``ROADMAP.md`` item: MLA
(deepseek-v3), the enc-dec family, and training of the MoE family.

The loss (``loss_fn``) is the next-token cross-entropy of ``chunked_ce``
over the hidden states that ``forward(..., return_hidden=True)`` returns.
Only ``Runtime.remat == "none"`` is taken (the value the reference's
training launcher uses); DeepSeek's multi-token prediction comes with
MLA.

The decode path operates on a cache dict stacked over layers: K and V of
shape (L, B, S, Hkv, hd) and ``pos`` (B,); for the SSM family the float32
WKV states ``wkv`` (L, B, H, K, K) and the two token-shift carries
``shift1``, ``shift2`` (L, B, 1, D); for the hybrid family the float32
SSM states ``ssm`` (L, B, H, P, N), the conv carries ``conv`` (L, B, K - 1,
d_inner + 2HN) and the shared block's K and V, ``attn_k``, ``attn_v`` (one
per group, (G, B, S, Hkv, hd)). ``decode_step`` writes the new entries
into those tensors in place and returns the same tensors with ``pos``
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
from .blocks import ffn_apply, ffn_specs, mrope_positions, rmsnorm, sigmoid
from .mamba2 import mamba2_apply, mamba2_decode_apply, mamba2_specs
from .moe import moe_apply, moe_specs
from .params import ParamSpec, tree_leaves, tree_map
from .runtime import Runtime
from .rwkv6 import _token_shift, rwkv6_apply, rwkv6_decode_apply, rwkv6_specs

__all__ = ["build_param_specs", "chunked_ce", "forward", "decode_step", "init_cache", "loss_fn"]

_DENSE = ("dense", "vlm")
_TODO = {
    "encdec": "10(c) (the enc-dec family)",
}
_MLA = "10(c) (MLA and deepseek-v3)"
# families that serve but do not train yet: what their training needs
_UNTRAINED = {"moe": ("MoE", "K9")}


def _require_ported(cfg: ArchConfig) -> None:
    """Raise unless the inference path of ``cfg``'s family is ported."""
    if cfg.family in _DENSE or cfg.family in ("ssm", "hybrid") or (
            cfg.family == "moe" and cfg.mla is None):
        return
    item = _MLA if cfg.family == "moe" else _TODO.get(cfg.family)
    if item is None:
        raise ValueError(f"unknown family {cfg.family!r}")
    what = "MLA attention" if cfg.family == "moe" else f"family {cfg.family!r}"
    raise NotImplementedError(f"{cfg.name}: {what} is not ported yet (ROADMAP.md item {item})")


def _ln(stacked: Optional[int], d: int, dtype: torch.dtype) -> ParamSpec:
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    return ParamSpec(lead + (d,), lx + ("embed",), dtype, "ones")


def _layer(stacked: Dict[str, Any], i: int) -> Dict[str, Any]:
    return tree_map(lambda a: a[i], stacked)


def _depth(stacked: Dict[str, Any]) -> int:
    return tree_leaves(stacked)[0].shape[0]


def _stacks(params):
    """(stack, index of its first layer) of each layer stack in forward
    order: the MoE family's leading dense blocks (if any), then the blocks."""
    dense = params.get("dense_blocks")
    if dense is None:
        return [(params["blocks"], 0)]
    return [(dense, 0), (params["blocks"], _depth(dense))]


def _ffn(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime) -> torch.Tensor:
    if "moe" in p:
        return moe_apply(p["moe"], x, cfg, rt)
    return ffn_apply(p["ffn"], x, cfg.act)


# =========================================================== param specs


def _dense_blocks(cfg: ArchConfig, n: int, dt: torch.dtype) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "attn": attention_specs(cfg, stacked=n, dtype=dt),
        "ffn": ffn_specs(d, cfg.d_ff, cfg.act, stacked=n, dtype=dt),
        "ln1": _ln(n, d, dt),
        "ln2": _ln(n, d, dt),
    }


def build_param_specs(cfg: ArchConfig, rt: Optional[Runtime] = None):
    _require_ported(cfg)
    rt = rt or Runtime()
    dt = rt.pdtype
    d, L, V = cfg.d_model, cfg.n_layers, cfg.vocab
    specs: Dict[str, Any] = {
        "embed": ParamSpec((V, d), ("vocab", "embed"), dt, "normal"),
        "final_ln": _ln(None, d, dt),
    }
    if not cfg.tie_embeddings:
        specs["out"] = ParamSpec((V, d), ("vocab", "embed"), dt, "scaled", fan_in_axis=-1)
    if cfg.family in _DENSE:
        specs["blocks"] = _dense_blocks(cfg, L, dt)
        return specs
    if cfg.family == "ssm":
        specs["blocks"] = {
            "tmix": rwkv6_specs(cfg, stacked=L, dtype=dt),
            "cmix": {
                "w_k": ParamSpec((L, d, cfg.d_ff), ("layers", "embed", "mlp"), dt, "scaled"),
                "w_v": ParamSpec((L, cfg.d_ff, d), ("layers", "mlp", "embed"), dt, "scaled"),
                "w_r": ParamSpec((L, d, d), ("layers", "embed", "heads"), dt, "scaled"),
                "mix": ParamSpec((L, 2, d), ("layers", None, "embed"), dt, "zeros"),
            },
            "ln1": _ln(L, d, dt),
            "ln2": _ln(L, d, dt),
        }
        return specs
    if cfg.family == "hybrid":
        specs["blocks"] = {
            "mamba": mamba2_specs(cfg, stacked=L, dtype=dt),
            "ln": _ln(L, d, dt),
        }
        specs["shared_attn"] = {
            "attn": attention_specs(cfg, stacked=None, dtype=dt),
            "ffn": ffn_specs(d, cfg.d_ff, cfg.act, stacked=None, dtype=dt),
            "ln1": _ln(None, d, dt),
            "ln2": _ln(None, d, dt),
        }
        return specs
    nd = cfg.moe.first_dense_layers
    if nd:
        specs["dense_blocks"] = _dense_blocks(cfg, nd, dt)
    specs["blocks"] = {
        "attn": attention_specs(cfg, stacked=L - nd, dtype=dt),
        "moe": moe_specs(cfg, stacked=L - nd, dtype=dt),
        "ln1": _ln(L - nd, d, dt),
        "ln2": _ln(L - nd, d, dt),
    }
    return specs


# =============================================================== forward


def _rwkv_cmix(p, x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """RWKV's channel mix: a squared-ReLU FFN on a token-shifted input,
    gated by a sigmoid receptance."""
    shifted = _token_shift(x, prev)
    lam_k = sigmoid(p["mix"][0]).to(x.dtype)
    lam_r = sigmoid(p["mix"][1]).to(x.dtype)
    xk = x + (shifted - x) * lam_k
    xr = x + (shifted - x) * lam_r
    k = torch.relu(xk @ p["w_k"])
    return sigmoid(xr @ p["w_r"]) * ((k * k) @ p["w_v"])


def _groups(cfg: ArchConfig) -> tuple:
    """(groups, layers a group) of the hybrid family: a shared attention +
    FFN block after every ``attn_every`` Mamba2 layers."""
    every = cfg.attn_every or cfg.n_layers
    if cfg.n_layers % every:
        raise ValueError(f"{cfg.name}: {cfg.n_layers} layers are not groups of {every}")
    return cfg.n_layers // every, every


def _shared_block(sa, x: torch.Tensor, cfg: ArchConfig, attend) -> torch.Tensor:
    """The hybrid family's shared attention + FFN block; ``attend`` maps the
    normed input to the attention's output."""
    x = x + attend(sa["attn"], rmsnorm(x, sa["ln1"], cfg.norm_eps))
    return x + ffn_apply(sa["ffn"], rmsnorm(x, sa["ln2"], cfg.norm_eps), cfg.act)


def _stacked_forward(params, cfg: ArchConfig, rt: Runtime, x: torch.Tensor,
                     positions: torch.Tensor, causal: bool) -> torch.Tensor:
    for blocks, _ in _stacks(params):
        for i in range(_depth(blocks)):
            p = _layer(blocks, i)
            if cfg.family == "ssm":
                x = x + rwkv6_apply(p["tmix"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, rt)
                x = x + _rwkv_cmix(p["cmix"], rmsnorm(x, p["ln2"], cfg.norm_eps))
                continue
            x = x + attention_apply(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), cfg, rt,
                                    positions, causal)
            x = x + _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg, rt)
    return x


def _hybrid_forward(params, cfg: ArchConfig, rt: Runtime, x: torch.Tensor,
                    positions: torch.Tensor, causal: bool) -> torch.Tensor:
    groups, every = _groups(cfg)
    for g in range(groups):
        for i in range(g * every, (g + 1) * every):
            p = _layer(params["blocks"], i)
            x = x + mamba2_apply(p["mamba"], rmsnorm(x, p["ln"], cfg.norm_eps), cfg, rt)
        x = _shared_block(params["shared_attn"], x, cfg, lambda pa, h: attention_apply(
            pa, h, cfg, rt, positions, causal))
    return x


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
    _require_ported(cfg)
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

    if cfg.family == "hybrid":
        x = _hybrid_forward(params, cfg, rt, x, positions, causal)
    else:
        x = _stacked_forward(params, cfg, rt, x, positions, causal)
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
    """Next-token CE of the ``dense``, ``vlm``, ``ssm`` and ``hybrid``
    families (the SSM's and hybrid's scans differentiate through K12b and
    K8b)."""
    _require_ported(cfg)
    if cfg.family in _UNTRAINED:
        name, kernel = _UNTRAINED[cfg.family]
        raise NotImplementedError(
            f"{cfg.name}: training the {name} family is not ported yet (ROADMAP.md item "
            f"10(c) (training the {name} family, with {kernel}'s backward, the next slice))")
    if rt.remat != "none":
        raise NotImplementedError(
            f"Runtime.remat={rt.remat!r} is not ported yet (ROADMAP.md item 11, with the "
            f"memory scheduling of the distribution work); use remat='none'")
    if cfg.mtp_depth:
        raise NotImplementedError(
            f"{cfg.name}: multi-token prediction is not ported yet (ROADMAP.md item {_MLA})")
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
    _require_ported(cfg)
    dev = resolve_device(device)
    pos = torch.zeros((batch,), dtype=torch.int32, device=dev)
    if cfg.family == "ssm":
        H, K, L = cfg.n_heads, cfg.d_model // cfg.n_heads, cfg.n_layers
        shift = (L, batch, 1, cfg.d_model)
        return {
            "wkv": torch.zeros((L, batch, H, K, K), dtype=torch.float32, device=dev),
            "shift1": torch.zeros(shift, dtype=rt.cdtype, device=dev),
            "shift2": torch.zeros(shift, dtype=rt.cdtype, device=dev),
            "pos": pos,
        }
    S = _cache_len(cfg, max_len)
    if cfg.family == "hybrid":
        di, P, N = cfg.ssm.expand * cfg.d_model, cfg.ssm.head_dim, cfg.ssm.d_state
        H = di // P
        kv = (_groups(cfg)[0], batch, S, cfg.n_kv_heads, cfg.head_dim)
        c = {
            "ssm": torch.zeros((cfg.n_layers, batch, H, P, N), dtype=torch.float32, device=dev),
            "attn_k": torch.zeros(kv, dtype=rt.cdtype, device=dev),
            "attn_v": torch.zeros(kv, dtype=rt.cdtype, device=dev),
            "pos": pos,
        }
        if cfg.ssm.conv_dim:
            c["conv"] = torch.zeros((cfg.n_layers, batch, cfg.ssm.conv_dim - 1, di + 2 * H * N),
                                    dtype=rt.cdtype, device=dev)
        return c
    shape = (cfg.n_layers, batch, S, cfg.n_kv_heads, cfg.head_dim)
    return {
        "k": torch.zeros(shape, dtype=rt.cdtype, device=dev),
        "v": torch.zeros(shape, dtype=rt.cdtype, device=dev),
        "pos": pos,
    }


def decode_step(params, cfg: ArchConfig, rt: Runtime, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor):
    """One decode step. tokens: (B, 1) -> logits (B, 1, V), cache."""
    _require_ported(cfg)
    x = params["embed"][tokens.long()].to(rt.cdtype)
    pos = cache["pos"]
    if cfg.family == "ssm":
        return _ssm_decode_step(params, cfg, rt, cache, x)
    if cfg.family == "hybrid":
        return _hybrid_decode_step(params, cfg, rt, cache, x)
    for blocks, first in _stacks(params):
        for i in range(_depth(blocks)):
            p = _layer(blocks, i)
            sub = {"k": cache["k"][first + i], "v": cache["v"][first + i], "pos": pos}
            a, _ = attention_decode_apply(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), sub,
                                          cfg, rt)
            x = x + a
            x = x + _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg, rt)
    return _logits(params, cfg, x), {"k": cache["k"], "v": cache["v"], "pos": pos + 1}


def _ssm_decode_step(params, cfg: ArchConfig, rt: Runtime, cache: Dict[str, torch.Tensor],
                     x: torch.Tensor):
    blocks = params["blocks"]
    for i in range(_depth(blocks)):
        p = _layer(blocks, i)
        state = {"wkv": cache["wkv"][i], "shift": cache["shift1"][i]}
        a, st = rwkv6_decode_apply(p["tmix"], rmsnorm(x, p["ln1"], cfg.norm_eps), state, cfg, rt)
        x = x + a
        inner = rmsnorm(x, p["ln2"], cfg.norm_eps)
        x = x + _rwkv_cmix(p["cmix"], inner, prev=cache["shift2"][i])
        cache["wkv"][i].copy_(st["wkv"])
        cache["shift1"][i].copy_(st["shift"])
        cache["shift2"][i].copy_(inner)
    return _logits(params, cfg, x), dict(cache, pos=cache["pos"] + 1)


def _hybrid_decode_step(params, cfg: ArchConfig, rt: Runtime, cache: Dict[str, torch.Tensor],
                        x: torch.Tensor):
    groups, every = _groups(cfg)
    pos = cache["pos"]
    for g in range(groups):
        for i in range(g * every, (g + 1) * every):
            p = _layer(params["blocks"], i)
            state = {"ssm": cache["ssm"][i]}
            if "conv" in cache:
                state["conv"] = cache["conv"][i]
            a, st = mamba2_decode_apply(p["mamba"], rmsnorm(x, p["ln"], cfg.norm_eps), state,
                                        cfg, rt)
            x = x + a
            for key in state:
                cache[key][i].copy_(st[key])
        sub = {"k": cache["attn_k"][g], "v": cache["attn_v"][g], "pos": pos}
        x = _shared_block(params["shared_attn"], x, cfg, lambda pa, h: attention_decode_apply(
            pa, h, sub, cfg, rt)[0])
    return _logits(params, cfg, x), dict(cache, pos=pos + 1)
