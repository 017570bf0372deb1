"""Architecture and shape configuration.

Every assigned architecture is an ``ArchConfig``; the four input-shape sets
are ``ShapeConfig``s. ``reduced()`` yields the family-preserving smoke-test
variant (small widths/depths/experts) that runs a real forward/train step
on CPU.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Dict, List, Optional, Tuple

__all__ = ["ArchConfig", "ShapeConfig", "SHAPES", "MLAConfig", "MoEConfig", "SSMConfig"]


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-style Multi-head Latent Attention dims (arXiv:2412.19437)."""

    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int = 8
    top_k: int = 2
    n_shared: int = 0           # shared (always-on) experts
    d_ff_expert: int = 2048     # per-expert FFN width
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    first_dense_layers: int = 0  # leading layers that stay dense (DeepSeek-V3: 3)


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    expand: int = 2
    head_dim: int = 64
    conv_dim: int = 4
    chunk: int = 128


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                   # dense | moe | ssm | hybrid | encdec | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    d_head: Optional[int] = None  # default: d_model // n_heads
    act: str = "swiglu"           # swiglu | sq_relu
    rope: str = "standard"        # standard | mrope | none
    window: Optional[int] = None  # sliding-window attention size
    moe: Optional[MoEConfig] = None
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    attn_every: Optional[int] = None   # hybrid: shared attn block cadence
    n_encoder_layers: int = 0          # enc-dec only
    mtp_depth: int = 0                 # DeepSeek multi-token prediction heads
    tie_embeddings: bool = False
    frontend: Optional[str] = None     # vision | audio modality stub
    norm_eps: float = 1e-5

    @property
    def head_dim(self) -> int:
        return self.d_head if self.d_head is not None else self.d_model // self.n_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm" and self.attn_every is None

    @property
    def subquadratic(self) -> bool:
        """Can this arch decode at 500k context with bounded state?"""
        return self.family in ("ssm", "hybrid") or self.window is not None

    @property
    def has_decoder(self) -> bool:
        return True  # all assigned archs have decode paths (enc-dec included)

    def param_count(self) -> int:
        """Analytic parameter count (embeddings included once)."""
        d, f, L = self.d_model, self.d_ff, self.n_layers
        hd = self.head_dim
        nq, nkv = self.n_heads, self.n_kv_heads
        total = self.vocab * d * (1 if self.tie_embeddings else 2)
        per_layer_attn = 0
        if self.mla is not None:
            m = self.mla
            per_layer_attn = (
                d * m.q_lora_rank + m.q_lora_rank * nq * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                + m.kv_lora_rank * nq * (m.qk_nope_head_dim + m.v_head_dim)
                + nq * m.v_head_dim * d
            )
        elif self.family in ("ssm",) and self.ssm is not None:
            pass  # handled below per block type
        else:
            per_layer_attn = d * nq * hd + 2 * d * nkv * hd + nq * hd * d

        def ffn_params(width: int) -> int:
            return d * width * (3 if self.act == "swiglu" else 2)

        total_layers = 0
        for layer in range(L):
            if self.family == "ssm" and self.ssm is not None:
                di = self.ssm.expand * d
                nh = di // self.ssm.head_dim
                total_layers += d * (2 * di + 2 * nh * self.ssm.d_state + nh) + di * d + di * self.ssm.conv_dim
                if self.name.startswith("rwkv"):
                    # rwkv6 block: r,k,v,g,w projections + output + ffn
                    total_layers += 4 * d * d + d * d
                total_layers += ffn_params(f) if f else 0
            elif self.family == "hybrid" and self.ssm is not None:
                di = self.ssm.expand * d
                nh = di // self.ssm.head_dim
                total_layers += d * (2 * di + 2 * nh * self.ssm.d_state + nh) + di * d + di * self.ssm.conv_dim
            else:
                is_moe = (
                    self.moe is not None and layer >= self.moe.first_dense_layers
                )
                total_layers += per_layer_attn
                if is_moe:
                    e = self.moe
                    total_layers += (
                        (e.n_experts + e.n_shared) * d * e.d_ff_expert * (3 if self.act == "swiglu" else 2)
                        + d * e.n_experts
                    )
                else:
                    total_layers += ffn_params(f)
        total += total_layers
        if self.family == "hybrid" and self.attn_every:
            # one shared attention+FFN block
            total += per_layer_attn or (d * nq * hd + 2 * d * nkv * hd + nq * hd * d)
            total += ffn_params(f)
        if self.n_encoder_layers:
            total += self.n_encoder_layers * (per_layer_attn + ffn_params(f))
            total += L * per_layer_attn  # decoder cross-attention
        return total

    def active_param_count(self) -> int:
        """Active params per token (MoE: top-k + shared only)."""
        if self.moe is None:
            return self.param_count()
        e = self.moe
        d = self.d_model
        glu = 3 if self.act == "swiglu" else 2
        moe_layers = self.n_layers - e.first_dense_layers
        all_experts = moe_layers * e.n_experts * d * e.d_ff_expert * glu
        active = moe_layers * e.top_k * d * e.d_ff_expert * glu
        return self.param_count() - all_experts + active


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


SHAPES: Dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeConfig("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeConfig("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeConfig("long_500k", 524288, 1, "decode"),
}
