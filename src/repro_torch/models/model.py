"""Model assembly: param specs, forward, cache and decode for the dense
family (``dense``, and the ``vlm`` backbone, which shares its code path),
the MoE family (mixtral-8x22b with GQA, deepseek-v3 with MLA: leading
dense blocks, if any, then blocks whose FFN is ``moe_apply``), the SSM family (rwkv6-7b: a
time-mix block, ``rwkv6_apply``, and a channel-mix block, ``_rwkv_cmix``,
each behind an RMSNorm) and the hybrid family (zamba2-2.7b: groups of
``attn_every`` Mamba2 blocks, ``mamba2_apply`` behind an RMSNorm, each
group followed by one shared attention + FFN block whose parameters every
group reuses) and the enc-dec family (seamless-m4t-medium: a bidirectional
encoder stack over ``enc_embeds``, the audio frontend's stand-in, then
``enc_ln``; a decoder stack whose layers run causal self-attention,
cross-attention on ``ln3`` over the encoder output, then the FFN).

Layer stacks are *stacked* (leading "layers" axis) as in the reference,
which scans over them; the port runs a Python loop over layer slices, and
autograd sums each slice's gradient into the stacked leaf. Each layer of
every stack runs under ``Runtime.remat``'s policy, as the reference's
``_scan_stack`` wraps its body: ``"none"`` as it is, ``"dots"`` under
``torch.utils.checkpoint`` keeping the results of matrix products and
recomputing the rest, any other value under a full recomputation; the
hybrid's shared block and the MTP block are not wrapped. The kernels'
autograd functions inside a wrapped layer run again in the backward.

The loss (``loss_fn``) is the next-token cross-entropy of ``chunked_ce``
over the hidden states that ``forward(..., return_hidden=True)`` returns,
plus, where the config has ``mtp_depth`` and the tree an ``mtp`` subtree
(deepseek-v3), 0.3 times the reference's multi-token-prediction loss: one
extra block on the token embeddings and the next token's, predicting the
token after next.

The decode path operates on a cache dict stacked over layers: K and V of
shape (L, B, S, Hkv, hd) and ``pos`` (B,); for the SSM family the float32
WKV states ``wkv`` (L, B, H, K, K) and the two token-shift carries
``shift1``, ``shift2`` (L, B, 1, D); for the hybrid family the float32
SSM states ``ssm`` (L, B, H, P, N), the conv carries ``conv`` (L, B, K - 1,
d_inner + 2HN) and the shared block's K and V, ``attn_k``, ``attn_v`` (one
per group, (G, B, S, Hkv, hd)); for MLA the latent ``c_kv`` (L, B, S,
kv_lora_rank) and the rotary key ``k_rope`` (L, B, S, qk_rope_head_dim); for
the enc-dec family the decoder's K and V beside the encoder's, ``enc_k`` and
``enc_v`` (L, B, Se, Hkv, hd), which ``init_cache`` leaves at zero, as the
reference's does (its serving engine attends over that zero cache).
``decode_step`` writes the new entries into those tensors in place and
returns the same tensors with ``pos`` advanced (the reference returns new
arrays); do not reuse a cache after passing it on.
"""

from __future__ import annotations

import functools
from typing import Any, Dict, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from .attention import (attention_apply, attention_decode_apply, attention_specs,
                        cross_decode_apply, mla_apply, mla_decode_apply, mla_specs)
from .blocks import ffn_apply, ffn_specs, mrope_positions, rmsnorm, shard_batch, sigmoid
from .mamba2 import mamba2_apply, mamba2_decode_apply, mamba2_specs
from .moe import moe_apply, moe_specs
from .params import ParamSpec, tree_leaves, tree_map
from .runtime import Runtime
from .rwkv6 import _token_shift, rwkv6_apply, rwkv6_decode_apply, rwkv6_specs

__all__ = ["abstract_cache", "build_param_specs", "chunked_ce", "forward", "decode_step",
           "init_cache", "loss_fn"]

_DENSE = ("dense", "vlm")
_FAMILIES = _DENSE + ("moe", "ssm", "hybrid", "encdec")
# the matrix products whose results remat="dots" keeps (jax's checkpoint_dots)
_DOTS = (torch.ops.aten.mm, torch.ops.aten.bmm, torch.ops.aten.addmm, torch.ops.aten.baddbmm)


def _check_family(cfg: ArchConfig) -> None:
    if cfg.family not in _FAMILIES:
        raise ValueError(f"{cfg.name}: unknown family {cfg.family!r}")


def _save_dots(ctx, op, *args, **kwargs):
    """``remat="dots"``'s policy: keep what a matrix product returns,
    recompute everything else."""
    if op.overloadpacket in _DOTS:
        return CheckpointPolicy.MUST_SAVE
    return CheckpointPolicy.PREFER_RECOMPUTE


def _remat(fn, rt: Runtime):
    """``fn`` under ``rt.remat``'s policy (the reference's ``_remat``):
    ``"none"`` keeps what the backward needs, ``"dots"`` keeps the products'
    results, anything else recomputes the whole body in the backward."""
    if rt.remat == "none":
        return fn

    def wrapped(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        kw = {}
        if rt.remat == "dots":
            kw["context_fn"] = functools.partial(create_selective_checkpoint_contexts, _save_dots)
        return checkpoint(fn, *args, use_reentrant=False, **kw)

    return wrapped


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


def _attn(cfg: ArchConfig):
    """The prefill/train attention of ``cfg``: MLA or GQA."""
    return mla_apply if cfg.mla is not None else attention_apply


def _ffn(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime) -> torch.Tensor:
    if "moe" in p:
        return moe_apply(p["moe"], x, cfg, rt)
    return ffn_apply(p["ffn"], x, cfg.act)


# =========================================================== param specs


def _attn_specs(cfg: ArchConfig, stacked: Optional[int], dt: torch.dtype):
    fn = mla_specs if cfg.mla is not None else attention_specs
    return fn(cfg, stacked=stacked, dtype=dt)


def _dense_blocks(cfg: ArchConfig, n: int, dt: torch.dtype) -> Dict[str, Any]:
    d = cfg.d_model
    return {
        "attn": _attn_specs(cfg, n, dt),
        "ffn": ffn_specs(d, cfg.d_ff, cfg.act, stacked=n, dtype=dt),
        "ln1": _ln(n, d, dt),
        "ln2": _ln(n, d, dt),
    }


def build_param_specs(cfg: ArchConfig, rt: Optional[Runtime] = None):
    _check_family(cfg)
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
    if cfg.family == "encdec":
        specs["enc_blocks"] = _dense_blocks(cfg, cfg.n_encoder_layers, dt)
        specs["blocks"] = {
            "attn": attention_specs(cfg, stacked=L, dtype=dt),
            "xattn": attention_specs(cfg, stacked=L, dtype=dt, cross=True),
            "ffn": ffn_specs(d, cfg.d_ff, cfg.act, stacked=L, dtype=dt),
            "ln1": _ln(L, d, dt),
            "ln2": _ln(L, d, dt),
            "ln3": _ln(L, d, dt),
        }
        specs["enc_ln"] = _ln(None, d, dt)
        return specs
    nd = cfg.moe.first_dense_layers
    if nd:
        specs["dense_blocks"] = _dense_blocks(cfg, nd, dt)
    specs["blocks"] = {
        "attn": _attn_specs(cfg, L - nd, dt),
        "moe": moe_specs(cfg, stacked=L - nd, dtype=dt),
        "ln1": _ln(L - nd, d, dt),
        "ln2": _ln(L - nd, d, dt),
    }
    if cfg.mtp_depth:
        specs["mtp"] = {
            "proj": ParamSpec((2 * d, d), ("embed", "embed"), dt, "scaled"),
            "attn": _attn_specs(cfg, None, dt),
            "ffn": ffn_specs(d, cfg.moe.d_ff_expert, cfg.act, stacked=None, dtype=dt),
            "ln1": _ln(None, d, dt),
            "ln2": _ln(None, d, dt),
            "ln_h": _ln(None, d, dt),
            "ln_e": _ln(None, d, dt),
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


def _run_stack(blk, x: torch.Tensor, blocks, rt: Runtime, layers=None) -> torch.Tensor:
    """``blk(h, layer)`` over ``layers`` (all by default) of a stacked tree,
    each under ``rt.remat``'s policy with its input and output placed by
    ``shard_batch``: the reference's ``_scan_stack``."""

    def constrained(h, p):
        return shard_batch(blk(shard_batch(h, rt), p), rt)

    body = _remat(constrained, rt)
    for i in range(_depth(blocks)) if layers is None else layers:
        x = body(x, _layer(blocks, i))
    return x


def _block(cfg: ArchConfig, rt: Runtime, positions: torch.Tensor, causal: bool,
           enc: Optional[torch.Tensor] = None):
    """The layer body of the stacked families: RWKV's time and channel mix,
    or attention then the FFN (or MoE), with cross-attention over the
    encoder output ``enc`` between them where the layer has ``xattn``."""
    eps = cfg.norm_eps

    def blk(h, p):
        if cfg.family == "ssm":
            h = h + rwkv6_apply(p["tmix"], rmsnorm(h, p["ln1"], eps), cfg, rt)
            return h + _rwkv_cmix(p["cmix"], rmsnorm(h, p["ln2"], eps))
        h = h + _attn(cfg)(p["attn"], rmsnorm(h, p["ln1"], eps), cfg, rt, positions, causal)
        if "xattn" in p:
            h = h + attention_apply(p["xattn"], rmsnorm(h, p["ln3"], eps), cfg, rt, positions,
                                    causal=False, kv_x=enc)
        return h + _ffn(p, rmsnorm(h, p["ln2"], eps), cfg, rt)

    return blk


def _stacked_forward(params, cfg: ArchConfig, rt: Runtime, x: torch.Tensor,
                     positions: torch.Tensor, causal: bool,
                     enc: Optional[torch.Tensor] = None) -> torch.Tensor:
    blk = _block(cfg, rt, positions, causal, enc)
    for blocks, _ in _stacks(params):
        x = _run_stack(blk, x, blocks, rt)
    return x


def _encode(params, cfg: ArchConfig, rt: Runtime, enc_embeds: torch.Tensor) -> torch.Tensor:
    """The enc-dec encoder: ``enc_embeds`` (B, Se, D) in the compute dtype at
    positions 0 ... Se - 1 through the bidirectional stack, then
    ``enc_ln``."""
    e = enc_embeds.to(rt.cdtype)
    B, S = e.shape[:2]
    epos = torch.arange(S, dtype=torch.int32, device=e.device)[None].expand(B, S)
    e = _run_stack(_block(cfg, rt, epos, causal=False), e, params["enc_blocks"], rt)
    return rmsnorm(e, params["enc_ln"], cfg.norm_eps)


def _hybrid_forward(params, cfg: ArchConfig, rt: Runtime, x: torch.Tensor,
                    positions: torch.Tensor, causal: bool) -> torch.Tensor:
    groups, every = _groups(cfg)

    def mblk(h, p):
        return h + mamba2_apply(p["mamba"], rmsnorm(h, p["ln"], cfg.norm_eps), cfg, rt)

    for g in range(groups):
        x = _run_stack(mblk, x, params["blocks"], rt, range(g * every, (g + 1) * every))
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
    enc_embeds: Optional[torch.Tensor] = None,     # (B, Se, D) enc-dec encoder input
    causal: bool = True,
    return_hidden: bool = False,
) -> torch.Tensor:
    """Returns logits (B, S, V) in the compute dtype, or with
    ``return_hidden`` the hidden states (B, S, D) after ``final_ln``. For
    the enc-dec family ``tokens`` are the decoder's, and the decoder's
    self-attention is causal whatever ``causal`` says, as in the
    reference."""
    _check_family(cfg)
    if inputs_embeds is not None:
        x = inputs_embeds.to(rt.cdtype)
    else:
        x = params["embed"][tokens.long()].to(rt.cdtype)
    x = shard_batch(x, rt)
    B, S = x.shape[:2]
    if positions is None:
        if cfg.rope == "mrope":
            positions = mrope_positions(B, S, device=x.device)
        else:
            positions = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)

    if cfg.family == "hybrid":
        x = _hybrid_forward(params, cfg, rt, x, positions, causal)
    elif cfg.family == "encdec":
        if enc_embeds is None:
            raise ValueError(f"{cfg.name}: the enc-dec family needs encoder inputs: pass "
                             f"enc_embeds (B, Se, d_model), or a batch that holds them")
        enc = _encode(params, cfg, rt, enc_embeds)
        x = _stacked_forward(params, cfg, rt, x, positions, True, enc)
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


def _mtp_loss(params, cfg: ArchConfig, rt: Runtime, tokens: torch.Tensor,
              labels: torch.Tensor) -> torch.Tensor:
    """DeepSeek's multi-token-prediction loss (depth 1), the reference's: the
    normed token embeddings beside the next token's, projected, through one
    attention + FFN block, predicting the token after next."""
    m = params["mtp"]
    h = params["embed"][tokens.long()].to(rt.cdtype)
    e_next = params["embed"][torch.roll(tokens, -1, dims=1).long()].to(rt.cdtype)
    hm = torch.cat([rmsnorm(h, m["ln_h"], cfg.norm_eps),
                    rmsnorm(e_next, m["ln_e"], cfg.norm_eps)], dim=-1) @ m["proj"]
    B, S = tokens.shape
    pos = torch.arange(S, dtype=torch.int32, device=hm.device)[None].expand(B, S)
    hm = hm + _attn(cfg)(m["attn"], rmsnorm(hm, m["ln1"], cfg.norm_eps), cfg, rt, pos, True)
    hm = hm + ffn_apply(m["ffn"], rmsnorm(hm, m["ln2"], cfg.norm_eps), cfg.act)
    return chunked_ce(hm, _head(params, cfg), torch.roll(labels, -1, dims=1))


def loss_fn(params, cfg: ArchConfig, rt: Runtime, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Next-token CE of every family (the SSM's and hybrid's scans
    differentiate through K12b and K8b, the MoE expert products through
    K9b; the enc-dec family reads ``batch["enc_embeds"]``), plus 0.3 times
    the MTP loss where the config asks for it and the tree has its ``mtp``
    subtree (a config without one ignores ``mtp_depth``, as the reference
    does)."""
    _check_family(cfg)
    tokens, labels = batch.get("tokens"), batch["labels"]
    x = forward(params, cfg, rt, tokens=tokens,
                inputs_embeds=batch.get("inputs_embeds"), positions=batch.get("positions"),
                enc_embeds=batch.get("enc_embeds"), return_hidden=True)
    loss = chunked_ce(x, _head(params, cfg), labels)
    if cfg.mtp_depth and "mtp" in params and tokens is not None:
        loss = loss + 0.3 * _mtp_loss(params, cfg, rt, tokens, labels)
    return loss


# ================================================================ decode


def _cache_len(cfg: ArchConfig, max_len: int) -> int:
    if cfg.window is not None:
        return min(cfg.window, max_len)
    return max_len


def init_cache(cfg: ArchConfig, rt: Runtime, batch: int, max_len: int, enc_len: int = 0,
               device: DeviceLike = None) -> Dict[str, torch.Tensor]:
    """Stacked-over-layers cache dict. ``pos`` counts tokens generated;
    ``enc_len`` is the length of the enc-dec family's encoder cache."""
    _check_family(cfg)
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
    if cfg.mla is not None:
        m = cfg.mla
        return {
            "c_kv": torch.zeros((cfg.n_layers, batch, S, m.kv_lora_rank), dtype=rt.cdtype,
                                device=dev),
            "k_rope": torch.zeros((cfg.n_layers, batch, S, m.qk_rope_head_dim), dtype=rt.cdtype,
                                  device=dev),
            "pos": pos,
        }
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
    c = {
        "k": torch.zeros(shape, dtype=rt.cdtype, device=dev),
        "v": torch.zeros(shape, dtype=rt.cdtype, device=dev),
    }
    if cfg.family == "encdec":
        enc = (cfg.n_layers, batch, enc_len, cfg.n_kv_heads, cfg.head_dim)
        c["enc_k"] = torch.zeros(enc, dtype=rt.cdtype, device=dev)
        c["enc_v"] = torch.zeros(enc, dtype=rt.cdtype, device=dev)
    c["pos"] = pos
    return c


def abstract_cache(cfg: ArchConfig, rt: Runtime, batch: int, max_len: int,
                   enc_len: int = 0) -> Dict[str, torch.Tensor]:
    """``init_cache``'s tree on the ``meta`` device: shapes, no storage."""
    return init_cache(cfg, rt, batch, max_len, enc_len, device="meta")


def decode_step(params, cfg: ArchConfig, rt: Runtime, cache: Dict[str, torch.Tensor],
                tokens: torch.Tensor):
    """One decode step. tokens: (B, 1) -> logits (B, 1, V), cache. An
    enc-dec decoder layer attends over the encoder cache between its
    self-attention and its FFN."""
    _check_family(cfg)
    x = params["embed"][tokens.long()].to(rt.cdtype)
    pos = cache["pos"]
    if cfg.family == "ssm":
        return _ssm_decode_step(params, cfg, rt, cache, x)
    if cfg.family == "hybrid":
        return _hybrid_decode_step(params, cfg, rt, cache, x)
    # the layers' cache entries (views, written in place) and their step
    keys, attend = (("c_kv", "k_rope"), mla_decode_apply) if cfg.mla is not None else (
        ("k", "v"), attention_decode_apply)
    for blocks, first in _stacks(params):
        for i in range(_depth(blocks)):
            p = _layer(blocks, i)
            sub = {k: cache[k][first + i] for k in keys}
            sub["pos"] = pos
            a, _ = attend(p["attn"], rmsnorm(x, p["ln1"], cfg.norm_eps), sub, cfg, rt)
            x = x + a
            if "xattn" in p:
                x = x + cross_decode_apply(p["xattn"], rmsnorm(x, p["ln3"], cfg.norm_eps),
                                           cache["enc_k"][first + i], cache["enc_v"][first + i],
                                           cfg, rt)
            x = x + _ffn(p, rmsnorm(x, p["ln2"], cfg.norm_eps), cfg, rt)
    return _logits(params, cfg, x), dict(cache, pos=pos + 1)


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
