"""Plain float32 building blocks of the references.

Written from the architectures' published descriptions, in plain PyTorch;
nothing here imports the program or takes anything it made. Every product
of a weight goes through ``Numerics.lin`` and every attention product
through ``Numerics.mm``, so that the control (``lowp.py``) can put the
same model in a lower precision.
"""

from __future__ import annotations

import math
from typing import Optional

import torch


class Numerics:
    """Float32 products, TF32 off: the reference."""

    def lin(self, x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
        """x (..., K) @ w (K, N) with w given in its stored dtype."""
        return x @ w.float()

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        return a @ b


class highest_precision:
    """While active, float32 matrix products are float32, not TF32."""

    def __enter__(self):
        self.saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
                      torch.get_float32_matmul_precision())
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        return self

    def __exit__(self, *exc):
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32, prec) = self.saved
        torch.set_float32_matmul_precision(prec)


def rmsnorm(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    """x / sqrt(mean(x^2) + eps) * w over the last axis."""
    return x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps) * w.float()


def silu(x: torch.Tensor) -> torch.Tensor:
    return x * torch.sigmoid(x)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding with the halves of each head rotated as pairs:
    x (B, S, H, D), positions (B, S)."""
    D = x.shape[-1]
    freqs = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = positions.float()[..., None] * freqs                       # (B, S, D/2)
    cos, sin = torch.cos(ang)[:, :, None], torch.sin(ang)[:, :, None]
    x1, x2 = x[..., :D // 2], x[..., D // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def attention(num: Numerics, q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              q_pos: torch.Tensor, k_pos: torch.Tensor, window: Optional[int],
              q_block: int = 512) -> torch.Tensor:
    """Causal (and windowed) grouped-query attention of one row: q (Sq, Hq,
    D), k, v (Sk, Hkv, D); query head h reads key head h // (Hq / Hkv); key
    j is visible to query i where k_pos[j] <= q_pos[i] and q_pos[i] -
    k_pos[j] < window. Queries in blocks, so that no (Hq, Sq, Sk) score
    tensor is held whole."""
    Sq, Hq, D = q.shape
    Hkv = k.shape[1]
    g = Hq // Hkv
    kh = k.permute(1, 0, 2).repeat_interleave(g, dim=0)               # (Hq, Sk, D)
    vh = v.permute(1, 0, 2).repeat_interleave(g, dim=0)
    out = torch.empty((Sq, Hq, D), dtype=torch.float32, device=q.device)
    scale = 1.0 / math.sqrt(D)
    for q0 in range(0, Sq, q_block):
        qb = q[q0:q0 + q_block].permute(1, 0, 2)                      # (Hq, b, D)
        s = num.mm(qb, kh.transpose(1, 2)) * scale                    # (Hq, b, Sk)
        qp = q_pos[q0:q0 + q_block, None]
        vis = k_pos[None, :] <= qp
        if window is not None:
            vis &= (qp - k_pos[None, :]) < window
        s = s.masked_fill(~vis[None], float("-inf"))
        p = torch.softmax(s, dim=-1)
        out[q0:q0 + q_block] = num.mm(p, vh).permute(1, 0, 2)
    return out


def head_logits(num: Numerics, x: torch.Tensor, final_ln, out_w, eps: float) -> torch.Tensor:
    """Logits (..., V) of hidden states x (..., D): the final norm, then the
    output head (V, D) transposed."""
    return num.lin(rmsnorm(x, final_ln, eps), out_w.t())


def gap_rows(logits: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    """For each row of reference logits (R, V), how far the logit of the
    given token (R,) lies below the row's largest."""
    return logits.max(-1).values - logits.gather(-1, tokens[:, None].long())[:, 0]
