"""Mamba2 (SSD) block (arXiv:2405.21060): the chunked state-space dual form
for the prefill, the O(1) recurrence for decode.

Ported from the reference's ``models/mamba2.py`` with its layout (d_inner =
expand * d_model, H = d_inner / head_dim heads of P = head_dim, state width
N = d_state, a scalar-identity A per head) and its casts: the step dt and
the log decay a are float32; the forward rounds x * dt to the compute dtype
and the decode step keeps it float32; the depthwise causal conv sums its
taps in the compute dtype in Python's order, ``0 + t0 + t1 + ...``, each
product and add rounded there (``F.conv1d`` sums in float32 and would not
match), then applies silu in that dtype; the gated norm is
``rmsnorm(out, norm) * silu(z)``. The prefill's chunked scan is kernel K8
(``kernels/mamba2_ssd``) in the reference model's function (``ssd_heads``,
its roundings to the compute dtype); the decode step is the float32 (P, N)
recurrence in plain PyTorch, as in the reference, which has no kernel for
it either.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..configs.base import ArchConfig
from ..kernels.mamba2_ssd.ops import ssd_heads
from .blocks import rmsnorm, silu
from .params import ParamSpec
from .runtime import Runtime

__all__ = ["mamba2_specs", "mamba2_apply", "mamba2_decode_apply", "mamba2_init_state"]


def _dims(cfg: ArchConfig) -> Tuple[int, int, int, int]:
    s = cfg.ssm
    d_inner = s.expand * cfg.d_model
    return d_inner, d_inner // s.head_dim, s.head_dim, s.d_state


def mamba2_specs(cfg: ArchConfig, stacked: Optional[int] = None,
                 dtype: torch.dtype = torch.bfloat16) -> Dict[str, ParamSpec]:
    d = cfg.d_model
    di, H, P, N = _dims(cfg)
    conv = cfg.ssm.conv_dim
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    specs = {
        # fused input projection: [z (gate), x, B, C, dt]
        "w_in": ParamSpec(lead + (d, 2 * di + 2 * H * N + H), lx + ("embed", "ssm_inner"), dtype,
                          "scaled"),
        "w_out": ParamSpec(lead + (di, d), lx + ("ssm_inner", "embed"), dtype, "scaled"),
        "A_log": ParamSpec(lead + (H,), lx + (None,), torch.float32, "zeros"),
        "D": ParamSpec(lead + (H,), lx + (None,), torch.float32, "zeros"),
        "dt_bias": ParamSpec(lead + (H,), lx + (None,), torch.float32, "zeros"),
        "norm": ParamSpec(lead + (di,), lx + ("ssm_inner",), dtype, "ones"),
    }
    if conv:
        specs["w_conv"] = ParamSpec(lead + (conv, di + 2 * H * N), lx + (None, "ssm_inner"), dtype,
                                    "scaled", fan_in_axis=-2)
    return specs


def _split_in(y: torch.Tensor, cfg: ArchConfig):
    """(z, x, B, C, dt), views of the input projection."""
    di, H, P, N = _dims(cfg)
    return torch.split(y, [di, di, H * N, H * N, H], dim=-1)


def _causal_conv(xbc: torch.Tensor, w_conv: torch.Tensor,
                 state: Optional[torch.Tensor] = None):
    """Depthwise causal conv over time. xbc (B, S, F), w_conv (K, F), state
    (B, K - 1, F) the carried last inputs -> (silu of the conv, new state)."""
    K = w_conv.shape[0]
    S = xbc.shape[1]
    pad = xbc.new_zeros((xbc.shape[0], K - 1, xbc.shape[-1])) if state is None else state
    xp = torch.cat([pad, xbc], dim=1)
    out = xp[:, 0:S] * w_conv[0]
    for i in range(1, K):
        out = out + xp[:, i:i + S] * w_conv[i]
    new_state = xp[:, S:] if K > 1 else None
    return silu(out), new_state


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.softplus``: logaddexp(x, 0)."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _ssd_chunked(xh, Bh, Ch, a, chunk: int) -> torch.Tensor:
    """xh (B, S, H, P), Bh/Ch (B, S, H, N), a (B, S, H) float32 log decay
    -> y (B, S, H, P) in xh's dtype, through K8."""
    return ssd_heads(xh, Bh, Ch, a, chunk=chunk)[0]


def _conv_split(p, x, Bv, Cv, cfg: ArchConfig, state=None):
    """The conv over [x, B, C] where the config has one; returns (x, B, C,
    new conv state or None)."""
    if not cfg.ssm.conv_dim:
        return x, Bv, Cv, None
    di, H, P, N = _dims(cfg)
    xbc, new_state = _causal_conv(torch.cat([x, Bv, Cv], dim=-1), p["w_conv"], state)
    x, Bv, Cv = torch.split(xbc, [di, H * N, H * N], dim=-1)
    return x, Bv, Cv, new_state


def mamba2_apply(p: Dict[str, torch.Tensor], u: torch.Tensor, cfg: ArchConfig,
                 rt: Runtime) -> torch.Tensor:
    """u (B, S, D) -> (B, S, D)."""
    di, H, P, N = _dims(cfg)
    B_, S, _ = u.shape
    z, x, Bv, Cv, dt = _split_in(u @ p["w_in"], cfg)
    x, Bv, Cv, _ = _conv_split(p, x, Bv, Cv, cfg)
    dt = _softplus(dt.float() + p["dt_bias"])                               # (B, S, H)
    a = -torch.exp(p["A_log"]) * dt                                         # log decay <= 0
    xh = (x * dt.repeat_interleave(P, dim=-1)).to(u.dtype).reshape(B_, S, H, P)
    yh = _ssd_chunked(xh, Bv.reshape(B_, S, H, N), Cv.reshape(B_, S, H, N), a, cfg.ssm.chunk)
    yh = yh + x.reshape(B_, S, H, P) * p["D"][None, None, :, None].to(u.dtype)
    out = rmsnorm(yh.reshape(B_, S, di), p["norm"]) * silu(z)
    return out @ p["w_out"]


def mamba2_init_state(cfg: ArchConfig, batch: int, dtype: torch.dtype = torch.float32,
                      device=None) -> Dict[str, torch.Tensor]:
    di, H, P, N = _dims(cfg)
    st = {"ssm": torch.zeros((batch, H, P, N), dtype=torch.float32, device=device)}
    if cfg.ssm.conv_dim:
        st["conv"] = torch.zeros((batch, cfg.ssm.conv_dim - 1, di + 2 * H * N), dtype=dtype,
                                 device=device)
    return st


def mamba2_decode_apply(p, u: torch.Tensor, state: Dict[str, torch.Tensor], cfg: ArchConfig,
                        rt: Runtime):
    """One token, u (B, 1, D) -> (out (B, 1, D), new state); the state is not
    written in place."""
    di, H, P, N = _dims(cfg)
    B_ = u.shape[0]
    z, x, Bv, Cv, dt = _split_in(u @ p["w_in"], cfg)
    new_state = dict(state)
    x, Bv, Cv, conv_state = _conv_split(p, x, Bv, Cv, cfg, state.get("conv"))
    if conv_state is not None:
        new_state["conv"] = conv_state
    dt = _softplus(dt[:, 0].float() + p["dt_bias"])                         # (B, H)
    a = torch.exp(-torch.exp(p["A_log"]) * dt)                              # (B, H)
    xh = (x[:, 0] * dt.repeat_interleave(P, dim=-1)).reshape(B_, H, P)      # float32
    Bh = Bv[:, 0].reshape(B_, H, N)
    Ch = Cv[:, 0].reshape(B_, H, N)
    s = state["ssm"] * a[:, :, None, None] + torch.einsum("bhn,bhp->bhpn", Bh.float(), xh.float())
    new_state["ssm"] = s
    yh = torch.einsum("bhpn,bhn->bhp", s, Ch.float()).to(u.dtype)
    yh = yh + x[:, 0].reshape(B_, H, P) * p["D"][None, :, None].to(u.dtype)
    out = rmsnorm(yh.reshape(B_, 1, di), p["norm"]) * silu(z)
    return out @ p["w_out"], new_state
