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

``wkv_chunk_states``, ``wkv_state_pass`` and ``wkv_chunk_outputs`` (and
``wkv_chunked``, which runs the three) emulate the ``chunked`` route's
three launches: every chunk's increment (k * exp(total - cs))^T . v and
decay exp(total) at once, then the short sequential pass S = exp(total) *
S + inc over the chunks, which keeps each chunk's starting state, then
every chunk's y from its starting state at once. The state pass computes
what ``wkv_plain``'s loop computes, one multiply and one add a chunk.
"""

from __future__ import annotations

from typing import Tuple

import torch

__all__ = ["wkv_chunk_outputs", "wkv_chunk_states", "wkv_chunked", "wkv_plain",
           "wkv_state_pass"]


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



def _chunks(t: torch.Tensor, c: int) -> torch.Tensor:
    """(B, S, H, K) -> float32 (B, S / c, c, H, K)."""
    return t.float().reshape(t.shape[0], t.shape[1] // c, c, *t.shape[2:])


def wkv_chunk_states(k: torch.Tensor, v: torch.Tensor, w: torch.Tensor, chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 1, every chunk at once: k, v, w (B, S, H, K) -> (inc (B, H, nc,
    K, K) = (k * exp(total - cs))^T . v, decay (B, H, nc, K) = exp(total)),
    float32, nc = S / chunk."""
    kk, vk = _chunks(k, chunk), _chunks(v, chunk)
    cs = torch.cumsum(_chunks(w, chunk), dim=2)                        # (B, nc, c, H, K)
    total = cs[:, :, -1]
    inc = torch.einsum("bjshk,bjshv->bhjkv", kk * torch.exp(total[:, :, None] - cs), vk)
    return inc, torch.exp(total).transpose(1, 2)


def wkv_state_pass(inc: torch.Tensor, decay: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 2: S = decay_j * S + inc_j (the decay per row) over the chunks
    j, from S = 0 -> (each chunk's starting state (B, H, nc, K, K), the
    final state (B, H, K, K))."""
    starts = torch.empty_like(inc)
    st = inc.new_zeros(inc.shape[:2] + inc.shape[3:])
    for j in range(inc.shape[2]):
        starts[:, :, j] = st
        st = decay[:, :, j, :, None] * st + inc[:, :, j]
    return starts, st


def wkv_chunk_outputs(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                      u: torch.Tensor, starts: torch.Tensor, chunk: int, bf16_intra: bool
                      ) -> torch.Tensor:
    """Step 3, every chunk at once from its starting state (B, H, nc, K,
    K): y (B, S, H, K) in r's dtype, computed and rounded as ``wkv_plain``
    computes it."""
    c = chunk
    rk, kk, vk, wk = (_chunks(t, c) for t in (r, k, v, w))             # (B, nc, c, H, K)
    cs = torch.cumsum(wk, dim=2)
    total = cs[:, :, -1]                                              # (B, nc, H, K)
    y_state = torch.einsum("bjqhk,bhjkv->bjqhv", rk * torch.exp(cs - wk), starts)
    m = 0.5 * (total - wk[:, :, 0])
    r_f = rk * torch.exp(cs - wk - m[:, :, None])
    k_f = kk * torch.exp(m[:, :, None] - cs)
    vi = vk
    if bf16_intra:
        r_f, k_f, vi = _bf16(r_f), _bf16(k_f), _bf16(vk)
    att = torch.einsum("bjqhk,bjshk->bjqsh", r_f, k_f)
    lower = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)[None, None, :, :, None]
    att = torch.where(lower, att, 0.0)
    if bf16_intra:
        att = _bf16(att)
    y_intra = torch.einsum("bjqsh,bjshv->bjqhv", att, vi)
    cur = (rk * u.float()[:, None, None] * kk).sum(-1, keepdim=True)
    return (y_state + y_intra + cur * vk).to(r.dtype).reshape(r.shape)


def wkv_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                u: torch.Tensor, chunk: int, bf16_intra: bool
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``chunked`` route's three steps in plain PyTorch; the arguments
    and results of ``wkv_plain``."""
    inc, decay = wkv_chunk_states(k, v, w, chunk)
    starts, state = wkv_state_pass(inc, decay)
    return wkv_chunk_outputs(r, k, v, w, u, starts, chunk, bf16_intra), state
