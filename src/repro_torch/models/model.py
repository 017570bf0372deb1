"""Model assembly: param specs, forward, cache and decode for the dense
family (``dense``, and the ``vlm`` backbone, which shares its code path).

Layer stacks are *stacked* (leading "layers" axis) as in the reference,
which scans over them; the port runs a Python loop over layer slices.
The other families (MoE, MLA, SSM, hybrid, enc-dec) raise
``NotImplementedError`` naming their ``ROADMAP.md`` item, and the loss
(``loss_fn``, ``chunked_ce``) comes with training.

The decode path operates on a cache dict stacked over layers: K and V of
shape (L, B, S, Hkv, hd) and ``pos`` (B,). ``decode_step`` writes the new
K/V into those tensors in place and returns the same tensors with ``pos``
advanced (the reference returns new arrays); do not reuse a cache after
passing it on.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ArchConfig
from ..device import DeviceLike, resolve_device
from .attention import attention_apply, attention_decode_apply, attention_specs
from .blocks import ffn_apply, ffn_specs, mrope_positions, rmsnorm
from .params import ParamSpec, tree_map
from .runtime import Runtime

__all__ = ["build_param_specs", "forward", "decode_step", "init_cache"]

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


def _logits(params, cfg: ArchConfig, x: torch.Tensor) -> torch.Tensor:
    x = rmsnorm(x, params["final_ln"], cfg.norm_eps)
    out_w = params["embed"] if cfg.tie_embeddings else params["out"]
    return torch.einsum("bsd,vd->bsv", x, out_w)


def forward(
    params,
    cfg: ArchConfig,
    rt: Runtime,
    tokens: Optional[torch.Tensor] = None,        # (B, S) integer
    inputs_embeds: Optional[torch.Tensor] = None,  # (B, S, D) modality stub
    positions: Optional[torch.Tensor] = None,
    causal: bool = True,
) -> torch.Tensor:
    """Returns logits (B, S, V) in the compute dtype."""
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
    return _logits(params, cfg, x)


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
