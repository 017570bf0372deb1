"""Architecture registry: ``get_arch(id)``, ``reduced(cfg)`` smoke variants,
cell enumeration for the dry-run, and shape applicability rules.

The port's own copy of the reference's ``configs`` package (plain
dataclasses, no JAX), kept identical so that a name sizes a model the same
way in both packages."""

from __future__ import annotations

from dataclasses import replace
from typing import Dict, List, Optional, Tuple

from .base import ArchConfig, MLAConfig, MoEConfig, SHAPES, ShapeConfig, SSMConfig
from . import (
    zamba2_2p7b,
    rwkv6_7b,
    deepseek_v3_671b,
    mixtral_8x22b,
    nemotron_4_340b,
    llama3_8b,
    starcoder2_7b,
    deepseek_coder_33b,
    qwen2_vl_72b,
    seamless_m4t_medium,
)

__all__ = [
    "ArchConfig", "ShapeConfig", "SHAPES", "ARCHS",
    "get_arch", "reduced", "shape_applicable", "all_cells",
    "MLAConfig", "MoEConfig", "SSMConfig",
]

ARCHS: Dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (
        zamba2_2p7b, rwkv6_7b, deepseek_v3_671b, mixtral_8x22b, nemotron_4_340b,
        llama3_8b, starcoder2_7b, deepseek_coder_33b, qwen2_vl_72b, seamless_m4t_medium,
    )
}


def get_arch(name: str) -> ArchConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; known: {sorted(ARCHS)}")
    return ARCHS[name]


def reduced(cfg: ArchConfig) -> ArchConfig:
    """Family-preserving smoke-test variant (runs a real step on CPU)."""
    kw: dict = dict(
        n_layers=min(cfg.n_layers, 4 if cfg.family != "hybrid" else 6),
        d_model=128,
        n_heads=4,
        n_kv_heads=min(cfg.n_kv_heads, 2) if cfg.n_kv_heads < cfg.n_heads else 4,
        d_ff=256,
        vocab=512,
        d_head=32,
    )
    if cfg.moe is not None:
        kw["moe"] = replace(
            cfg.moe, n_experts=4, top_k=2, d_ff_expert=128,
            first_dense_layers=min(cfg.moe.first_dense_layers, 1),
        )
    if cfg.mla is not None:
        kw["mla"] = MLAConfig(
            q_lora_rank=64, kv_lora_rank=32, qk_nope_head_dim=32,
            qk_rope_head_dim=16, v_head_dim=32,
        )
    if cfg.ssm is not None:
        kw["ssm"] = replace(cfg.ssm, d_state=16, head_dim=32, chunk=32)
    if cfg.attn_every is not None:
        kw["attn_every"] = 3
    if cfg.n_encoder_layers:
        kw["n_encoder_layers"] = 2
        kw["n_layers"] = 2
    return replace(cfg, **kw)


def shape_applicable(arch: ArchConfig, shape: ShapeConfig) -> Tuple[bool, str]:
    """(runnable, reason-if-skipped). DESIGN.md §7 documents the skips."""
    if shape.name == "long_500k" and not arch.subquadratic:
        return False, "full quadratic attention cannot decode at 524k context (DESIGN.md §7)"
    return True, ""


def all_cells() -> List[Tuple[str, str]]:
    """The 40 (arch x shape) cells, skips included (marked by dry-run)."""
    return [(a, s) for a in sorted(ARCHS) for s in SHAPES]
