"""Shared building blocks: norms, FFN variants, rotary embeddings.

Each function computes what its namesake in the reference's
``models/blocks.py`` computes, with the same casts. ``rmsnorm`` runs the
fused RMSNorm of ``kernels/rmsnorm`` (K10 forward, K11 backward on the
card), which computes the reference's jnp norm. XLA rounds each step of
a bf16 activation to bf16, where one fused torch call (``F.silu``,
``torch.sigmoid``, ``F.gelu``) rounds once, so ``silu``, ``sigmoid`` and
``gelu_tanh`` replay the reference's ``jax.nn`` functions step by step
(``jax.nn.gelu`` defaults to the tanh form). Autograd differentiates them;
``sigmoid`` takes s (1 - s) from its output as its backward, as
``lax.logistic`` does, where differentiating 1 / (1 + exp(-x)) as written
gives NaN once exp(-x) overflows. ``shard_batch`` places an activation
on the current mesh (``distributed.sharding.use_mesh``) as the reference's
constrains it; without a mesh, or on a mesh of one rank, it is the
identity.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..distributed import sharding
from ..kernels.rmsnorm.ops import rmsnorm
from .params import ParamSpec
from .runtime import Runtime

__all__ = [
    "rmsnorm", "silu", "sigmoid", "gelu_tanh", "ffn_specs", "ffn_apply", "rope_freqs",
    "apply_rope", "mrope_positions", "shard_batch",
]


class _Sigmoid(torch.autograd.Function):
    """1 / (1 + exp(-x)), each step rounded in x's dtype; backward
    g (s (1 - s)) from the output s, as ``lax.logistic``'s."""

    @staticmethod
    def forward(ctx, x):
        s = 1 / (1 + torch.exp(-x))
        ctx.save_for_backward(s)
        return s

    @staticmethod
    def backward(ctx, g):
        (s,) = ctx.saved_tensors
        return g * (s * (1 - s))


def sigmoid(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.sigmoid``: 1 / (1 + exp(-x)), each step rounded in x's dtype
    as XLA computes it (``torch.sigmoid`` rounds once)."""
    return _Sigmoid.apply(x)


def silu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.silu``: x * (1 / (1 + exp(-x))), each step rounded in x's
    dtype, as XLA computes it (``F.silu`` rounds once)."""
    return x * sigmoid(x)


@functools.lru_cache(maxsize=None)
def _gelu_constants(dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """sqrt(2 / pi) and 0.044715 as 0-dim CPU tensors in ``dtype``: a CUDA
    op takes them as scalars, so no call copies them to the card. Made as
    real tensors even under a fake-tensor trace (the dry-run), which must
    not leave a fake constant in this cache."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily

    with unset_fake_temporarily():
        return (torch.tensor(0.7978845608028654, dtype=dtype),
                torch.tensor(0.044715, dtype=dtype))


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu`` (tanh form): x * (0.5 * (1 + tanh(c * (x + k x^3))))
    with c = sqrt(2 / pi) and k = 0.044715 rounded to x's dtype (0.796875
    and 0.044677734375 in bf16), each step rounded in x's dtype as XLA
    computes it (``F.gelu`` rounds once)."""
    c, k = _gelu_constants(x.dtype)
    return x * (0.5 * (1 + torch.tanh(c * (x + k * x ** 3))))


# ---------------------------------------------------------------------- FFN


def ffn_specs(d_model: int, d_ff: int, act: str, stacked: Optional[int] = None,
              dtype: torch.dtype = torch.bfloat16) -> Dict[str, ParamSpec]:
    lead = (stacked,) if stacked else ()
    lax = ("layers",) if stacked else ()
    if act == "swiglu":
        return {
            "w_gate": ParamSpec(lead + (d_model, d_ff), lax + ("embed", "mlp"), dtype, "scaled"),
            "w_up": ParamSpec(lead + (d_model, d_ff), lax + ("embed", "mlp"), dtype, "scaled"),
            "w_down": ParamSpec(lead + (d_ff, d_model), lax + ("mlp", "embed"), dtype, "scaled"),
        }
    # two-matrix FFNs: squared-ReLU (Primer / Nemotron-4) or GELU (StarCoder2)
    return {
        "w_up": ParamSpec(lead + (d_model, d_ff), lax + ("embed", "mlp"), dtype, "scaled"),
        "w_down": ParamSpec(lead + (d_ff, d_model), lax + ("mlp", "embed"), dtype, "scaled"),
    }


def ffn_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, act: str) -> torch.Tensor:
    if act == "swiglu":
        h = silu(x @ p["w_gate"]) * (x @ p["w_up"])
    elif act == "gelu":
        h = gelu_tanh(x @ p["w_up"])
    else:
        r = F.relu(x @ p["w_up"])
        h = r * r
    return h @ p["w_down"]


# --------------------------------------------------------------------- RoPE


def rope_freqs(head_dim: int, theta: float = 10000.0, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32, device=device)
                            / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float = 10000.0,
               mrope_sections: Optional[Tuple[int, ...]] = None) -> torch.Tensor:
    """Rotary embedding. x: (..., seq, heads, head_dim); positions: (..., seq)
    or (..., seq, 3) for M-RoPE (t/h/w position ids, arXiv:2409.12191)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)  # (hd/2,)
    if mrope_sections is None:
        ang = positions[..., None].float() * freqs  # (..., seq, hd/2)
    else:
        # split the rotary dims into (t, h, w) sections, each section driven
        # by its own position id stream
        secs = []
        start = 0
        for i, n in enumerate(mrope_sections):
            f = freqs[start:start + n]
            secs.append(positions[..., i][..., None].float() * f)
            start += n
        ang = torch.cat(secs, dim=-1)
    cos = torch.cos(ang)[..., None, :]  # broadcast over heads
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = torch.chunk(x.float(), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def mrope_positions(batch: int, seq: int, device=None) -> torch.Tensor:
    """Stub 3D positions for the VLM backbone: text-linear in all sections.
    The vision frontend would supply true (t, h, w) ids per patch."""
    p = torch.arange(seq, dtype=torch.int32, device=device)
    return p[None, :, None].expand(batch, seq, 3)


def shard_batch(x: torch.Tensor, rt: Runtime, seq_dim: int = 1) -> torch.Tensor:
    """Place an activation in the batch-DP (+ optional sequence-parallel)
    layout: the batch over the data axes where it divides, and with
    ``rt.seq_shard`` dimension ``seq_dim`` over the model axis. The
    reference constrains this layout because GSPMD has been seen to carry a
    d_model-sharded, batch-replicated layout from the FSDP-sharded embedding
    into the whole residual stream. The identity without ``rt.act_shard``,
    outside a mesh or on a mesh of one rank."""
    if not rt.act_shard:
        return x
    mesh = sharding.current_mesh()
    if mesh is None or mesh.size() == 1:
        return x
    return sharding.place(x, sharding.activation_spec(x.shape, mesh, rt.seq_shard, seq_dim))
