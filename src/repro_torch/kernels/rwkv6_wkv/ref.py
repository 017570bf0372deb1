"""Plain PyTorch versions of the RWKV6 chunked WKV scan (kernel K12).

``wkv_plain`` runs the chunked form with the separable decay and the
midpoint shift, chunk by chunk with a float32 (K, K) state per (batch,
head), in the order of the reference's bodies: y = (r * exp(cs - w)) . S,
then + the strictly lower-triangular intra-chunk product, then + the
current-token bonus (r * u * k summed) * v; then S = exp(total) * S +
(k * exp(total - cs))^T . v. It serves both of K12's functions:

- ``bf16_intra=False`` is the Pallas kernel's (``rwkv6_wkv/kernel.py``,
  ``_wkv_kernel``): every product in float32;
- ``bf16_intra=True`` is the reference model's (``models/rwkv6.py``,
  ``_wkv_chunked``): r_f, k_f, the masked att and v are rounded to
  bfloat16 before the two intra-chunk products, whose sums are float32.

Only the lower triangle of att enters y. The reference model multiplies
the whole (c, c) product by a 0/1 mask, so where an upper entry overflows
float32 (its exponent reaches sum |w| over the chunk, up to 128 at the
decay floor) it gets 0 * inf = NaN; the Pallas kernel's ``jnp.where``, and
the port, give the finite lower-triangular result.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["wkv_plain"]


def _bf16(t: torch.Tensor) -> torch.Tensor:
    return t.to(torch.bfloat16).float()


def wkv_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
              u: torch.Tensor, chunk: int, bf16_intra: bool
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, K) with w the log decay, u (Bu, H, K) with Bu
    1 or B, ``chunk`` dividing S -> (y (B, S, H, K) in r's dtype, final
    state (B, H, K, K) float32)."""
    B, S, H, K = r.shape
    c = chunk
    dev = r.device
    state = torch.zeros((B, H, K, K), dtype=torch.float32, device=dev)
    y = torch.empty_like(r)
    lower = torch.ones((c, c), dtype=torch.bool, device=dev).tril(-1)[None, :, :, None]
    u4 = u.float()[:, None]                                   # (Bu, 1, H, K)
    for t0 in range(0, S, c):
        sl = slice(t0, t0 + c)
        rk, kk, vk = r[:, sl].float(), k[:, sl].float(), v[:, sl].float()
        wk = w[:, sl].float()
        cs = torch.cumsum(wk, dim=1)                          # (B, c, H, K)
        total = cs[:, -1]                                     # (B, H, K)
        y_state = torch.einsum("bqhk,bhkv->bqhv", rk * torch.exp(cs - wk), state)
        m = 0.5 * (total - wk[:, 0])
        r_f = rk * torch.exp(cs - wk - m[:, None])
        k_f = kk * torch.exp(m[:, None] - cs)
        vi = vk
        if bf16_intra:
            r_f, k_f, vi = _bf16(r_f), _bf16(k_f), _bf16(vk)
        att = torch.einsum("bqhk,bshk->bqsh", r_f, k_f)
        att = torch.where(lower, att, 0.0)
        if bf16_intra:
            att = _bf16(att)
        y_intra = torch.einsum("bqsh,bshv->bqhv", att, vi)
        cur = (rk * u4 * kk).sum(-1, keepdim=True)
        y[:, sl] = (y_state + y_intra + cur * vk).to(r.dtype)
        wts = torch.exp(total[:, None] - cs)
        state = torch.exp(total)[..., None] * state + torch.einsum(
            "bshk,bshv->bhkv", kk * wts, vk)
    return y, state

