"""RWKV-6 "Finch" block (arXiv:2404.05892): attention-free, with a
data-dependent per-channel decay.

Ported from the reference's ``models/rwkv6.py``, with its simplifications
(single linear maps for the decay and token-shift generators, RMSNorm as
the per-head output norm) and its casts: the decay w is computed in
float32 and floored at -2.0 a step, ``u_bonus`` is float32, the decode
recurrence runs in float32, and ``ln_x`` takes the default eps of 1e-5.
The prefill's chunked WKV is kernel K12 (``kernels/rwkv6_wkv``) in the
reference model's function, whose two intra-chunk products take bfloat16
operands; the decode step is the O(1) recurrence in plain PyTorch (the
reference has no kernel for it either).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.rwkv6_wkv.ops import wkv_heads
from .blocks import rmsnorm, sigmoid, silu
from .params import ParamSpec
from .runtime import Runtime

__all__ = ["rwkv6_specs", "rwkv6_apply", "rwkv6_decode_apply", "rwkv6_init_state"]


def _dims(cfg: ArchConfig) -> Tuple[int, int]:
    H = cfg.n_heads
    return H, cfg.d_model // H


def rwkv6_specs(cfg: ArchConfig, stacked: Optional[int] = None,
                dtype: torch.dtype = torch.bfloat16) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    H, K = _dims(cfg)
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    return {
        "w_r": ParamSpec(lead + (d, d), lx + ("embed", "heads"), dtype, "scaled"),
        "w_k": ParamSpec(lead + (d, d), lx + ("embed", "heads"), dtype, "scaled"),
        "w_v": ParamSpec(lead + (d, d), lx + ("embed", "heads"), dtype, "scaled"),
        "w_g": ParamSpec(lead + (d, d), lx + ("embed", "heads"), dtype, "scaled"),
        "w_decay": ParamSpec(lead + (d, d), lx + ("embed", "heads"), dtype, "scaled"),
        "u_bonus": ParamSpec(lead + (H, K), lx + (None, None), torch.float32, "zeros"),
        "mix": ParamSpec(lead + (5, d), lx + (None, "embed"), dtype, "zeros"),
        "w_o": ParamSpec(lead + (d, d), lx + ("heads", "embed"), dtype, "scaled"),
        "ln_x": ParamSpec(lead + (d,), lx + ("embed",), dtype, "ones"),
    }


def _token_shift(x: torch.Tensor, prev: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The x_{t-1} stream; ``prev`` (B, 1, D) is the carried last token of
    decode."""
    if prev is None:
        return torch.cat([torch.zeros_like(x[:, :1]), x[:, :-1]], dim=1)
    return prev


def _wkv_chunked(r, k, v, w, u, chunk: int) -> torch.Tensor:
    """r, k, v (B, S, H, K); w (B, S, H, K) float32 log decay (<= 0); u
    (H, K) float32 -> y (B, S, H, K) in r's dtype, through K12."""
    return wkv_heads(r, k, v, w, u, chunk=chunk)[0]


def _time_mix(p, x: torch.Tensor, cfg: ArchConfig, rt: Runtime, shifted: torch.Tensor):
    H, K = _dims(cfg)
    B, S, D = x.shape
    mix = p["mix"]  # (5, D): learned interpolation toward the shifted stream

    def lerp(i):
        lam = sigmoid(mix[i]).to(x.dtype)
        return x + (shifted - x) * lam

    r = (lerp(0) @ p["w_r"]).reshape(B, S, H, K)
    kk = (lerp(1) @ p["w_k"]).reshape(B, S, H, K)
    v = (lerp(2) @ p["w_v"]).reshape(B, S, H, K)
    g = silu(lerp(3) @ p["w_g"])
    # w_t = -softplus(decay(x)) - 0.1 in log space, floored at -2.0 a step so
    # the separable intra-chunk factors stay in float32 range at chunk <= 64
    z = (lerp(4) @ p["w_decay"]).float()
    w = -torch.logaddexp(z, torch.zeros_like(z)).reshape(B, S, H, K) - 0.1
    return r, kk, v, g, torch.clamp_min(w, -2.0)


def rwkv6_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
                rt: Runtime) -> torch.Tensor:
    B, S, D = x.shape
    r, kk, v, g, w = _time_mix(p, x, cfg, rt, _token_shift(x))
    y = _wkv_chunked(r, kk, v, w, p["u_bonus"], cfg.ssm.chunk if cfg.ssm else 128)
    y = rmsnorm(y.reshape(B, S, D), p["ln_x"]) * g
    return y @ p["w_o"]


def rwkv6_init_state(cfg: ArchConfig, batch: int, dtype: torch.dtype = torch.bfloat16,
                     device=None) -> Dict[str, torch.Tensor]:
    H, K = _dims(cfg)
    return {
        "wkv": torch.zeros((batch, H, K, K), dtype=torch.float32, device=device),
        "shift": torch.zeros((batch, 1, cfg.d_model), dtype=dtype, device=device),
    }


def rwkv6_decode_apply(p, x: torch.Tensor, state: Dict[str, torch.Tensor], cfg: ArchConfig,
                       rt: Runtime):
    """One token, x (B, 1, D) -> (out (B, 1, D), {"wkv": new state, "shift":
    x}); the state is not written in place."""
    B = x.shape[0]
    r, kk, v, g, w = _time_mix(p, x, cfg, rt, _token_shift(x, state["shift"]))
    r1, k1, v1, w1 = r[:, 0], kk[:, 0], v[:, 0], w[:, 0]      # (B, H, K)
    S = state["wkv"]
    cur = (r1 * p["u_bonus"][None] * k1).sum(-1, keepdim=True)   # float32, (B, H, 1)
    y = torch.einsum("bhk,bhkv->bhv", r1.float(), S) + cur.float() * v1.float()
    S_new = torch.exp(w1.float())[..., None] * S + torch.einsum(
        "bhk,bhv->bhkv", k1.float(), v1.float())
    y = y.reshape(B, 1, cfg.d_model).to(x.dtype)
    y = rmsnorm(y, p["ln_x"]) * g
    return y @ p["w_o"], {"wkv": S_new, "shift": x}
