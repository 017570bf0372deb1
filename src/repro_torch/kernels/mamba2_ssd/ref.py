"""Plain PyTorch versions of the Mamba2 SSD chunk scan (kernel K8).

``ssd_plain`` runs the chunked state-space dual form chunk by chunk with a
float32 (P, N) state per (batch, head), in the order of the reference's
bodies: with cs the float32 cumulative sum of the log decay a over the
chunk and total its last entry,

    s       = (C . B^T) * exp(cs_q - cs_s)      for s <= q, else 0
    y       = s . x  +  (C * exp(cs)) . h^T
    h       = exp(total) * h + x^T . (B * exp(total - cs))

It serves both of K8's functions:

- ``model=False`` is the Pallas kernel's (``mamba2_ssd/kernel.py``,
  ``_ssd_kernel``): every product in float32, y rounded to x's dtype once;
- ``model=True`` is the reference model's (``models/mamba2.py``,
  ``_ssd_chunked``), which in bfloat16 activations rounds the scores C . B^T
  to x's dtype before the float32 mask, the masked scores to x's dtype
  before the intra-chunk product, that product and the state's part each to
  x's dtype, and sums the two in x's dtype. In float32 activations none of
  these roundings happens and the two functions are one.

Only the lower triangle of exp(cs_q - cs_s) is evaluated: an upper entry's
exponent is a sum of -a over the chunk and can overflow float32. The
reference's ``jnp.where`` discards those entries, and so does the port.

``ssd_chunk_states``, ``ssd_state_pass`` and ``ssd_chunk_outputs`` (and
``ssd_chunked``, which runs the three) emulate the ``chunked`` route's
three launches: every chunk's increment x^T . (B * exp(total - cs)) and
decay exp(total) at once, then the short sequential pass h = exp(total) *
h + inc over the chunks, which keeps each chunk's starting state, then
every chunk's y from its starting state at once. The state pass computes
what ``ssd_plain``'s loop computes, one multiply and one add a chunk, so
the two give the same final state where they compute the increments alike.

``ssd_ref`` is the reference's sequential oracle (``mamba2_ssd/ref.py``),
kept for the tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["ssd_chunk_outputs", "ssd_chunk_states", "ssd_chunked", "ssd_plain", "ssd_ref",
           "ssd_state_pass"]


def ssd_plain(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, a: torch.Tensor,
              chunk: int, model: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (Bt, S, H, P), Bm and Cm (Bt, S, H, N) of x's dtype, a (Bt, S, H)
    the log decay (<= 0), ``chunk`` dividing S -> (y (Bt, S, H, P) in x's
    dtype, final state (Bt, H, P, N) float32)."""
    Bt, S, H, P = x.shape
    N = Bm.shape[-1]
    c = chunk
    dt = x.dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:   # a model-form rounding to x's dtype
        return t.to(dt).float() if model else t

    state = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    y = torch.empty((Bt, S, H, P), dtype=dt, device=x.device)
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    for t0 in range(0, S, c):
        sl = slice(t0, t0 + c)
        xk, bk, ck = x[:, sl].float(), Bm[:, sl].float(), Cm[:, sl].float()
        cs = torch.cumsum(a[:, sl].float(), dim=1)                     # (Bt, c, H)
        total = cs[:, -1:]                                             # (Bt, 1, H)
        rel = cs[:, :, None] - cs[:, None]                             # (Bt, q, s, H)
        L = torch.exp(torch.where(tri, rel, 0.0)).masked_fill(~tri, 0.0)
        s = rnd(torch.einsum("bqhn,bkhn->bqkh", ck, bk)) * L
        y_intra = rnd(torch.einsum("bqkh,bkhp->bqhp", rnd(s), xk))
        y_state = rnd(torch.einsum("bqhn,bhpn->bqhp", ck * torch.exp(cs)[..., None], state))
        y[:, sl] = rnd(y_intra + y_state).to(dt)
        w = torch.exp(total - cs)                                      # (Bt, c, H)
        state = torch.exp(total)[:, 0, :, None, None] * state + torch.einsum(
            "bkhn,bkhp->bhpn", bk * w[..., None], xk)
    return y, state


def _chunks(t: torch.Tensor, c: int) -> torch.Tensor:
    """(Bt, S, ...) -> float32 (Bt, S / c, c, ...)."""
    return t.float().reshape(t.shape[0], t.shape[1] // c, c, *t.shape[2:])


def ssd_chunk_states(x: torch.Tensor, Bm: torch.Tensor, a: torch.Tensor, chunk: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 1, every chunk at once: x (Bt, S, H, P), Bm (Bt, S, H, N), a
    (Bt, S, H) -> (inc (Bt, H, nc, P, N) = x^T . (B * exp(total - cs)),
    decay (Bt, H, nc) = exp(total)), float32, nc = S / chunk."""
    xk, bk = _chunks(x, chunk), _chunks(Bm, chunk)
    cs = torch.cumsum(_chunks(a, chunk), dim=2)                        # (Bt, nc, c, H)
    total = cs[:, :, -1:]
    w = torch.exp(total - cs)
    inc = torch.einsum("bjkhn,bjkhp->bhjpn", bk * w[..., None], xk)
    return inc, torch.exp(total[:, :, 0]).transpose(1, 2)


def ssd_state_pass(inc: torch.Tensor, decay: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Step 2: h = decay_j * h + inc_j over the chunks j, from h = 0 ->
    (each chunk's starting state (Bt, H, nc, P, N), the final state (Bt,
    H, P, N))."""
    starts = torch.empty_like(inc)
    h = inc.new_zeros(inc.shape[:2] + inc.shape[3:])
    for j in range(inc.shape[2]):
        starts[:, :, j] = h
        h = decay[:, :, j, None, None] * h + inc[:, :, j]
    return starts, h


def ssd_chunk_outputs(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, a: torch.Tensor,
                      starts: torch.Tensor, chunk: int, model: bool) -> torch.Tensor:
    """Step 3, every chunk at once from its starting state (Bt, H, nc, P,
    N): y (Bt, S, H, P) in x's dtype, rounded as ``ssd_plain`` rounds it."""
    dt = x.dtype

    def rnd(t: torch.Tensor) -> torch.Tensor:
        return t.to(dt).float() if model else t

    c = chunk
    xk, bk, ck = _chunks(x, c), _chunks(Bm, c), _chunks(Cm, c)
    cs = torch.cumsum(_chunks(a, c), dim=2)                            # (Bt, nc, c, H)
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()[None, None, :, :, None]
    rel = cs[:, :, :, None] - cs[:, :, None]                           # (Bt, nc, q, s, H)
    L = torch.exp(torch.where(tri, rel, 0.0)).masked_fill(~tri, 0.0)
    s = rnd(torch.einsum("bjqhn,bjkhn->bjqkh", ck, bk)) * L
    y_intra = rnd(torch.einsum("bjqkh,bjkhp->bjqhp", rnd(s), xk))
    y_state = rnd(torch.einsum("bjqhn,bhjpn->bjqhp", ck * torch.exp(cs)[..., None], starts))
    return rnd(y_intra + y_state).to(dt).reshape(x.shape)


def ssd_chunked(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, a: torch.Tensor,
                chunk: int, model: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """The ``chunked`` route's three steps in plain PyTorch; the arguments
    and results of ``ssd_plain``."""
    inc, decay = ssd_chunk_states(x, Bm, a, chunk)
    starts, state = ssd_state_pass(inc, decay)
    return ssd_chunk_outputs(x, Bm, Cm, a, starts, chunk, model), state


def ssd_ref(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, a: torch.Tensor,
            h0: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The sequential recurrence h_t = exp(a_t) h_{t-1} + x_t B_t^T, y_t =
    h_t . C_t in float32. x (Bt, S, H, P); Bm/Cm (Bt, S, H, N); a (Bt, S,
    H) -> (y (Bt, S, H, P) in x's dtype, h_final (Bt, H, P, N))."""
    Bt, S, H, P = x.shape
    N = Bm.shape[-1]
    h = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device) if h0 is None else h0
    ys = []
    for t in range(S):
        h = h * torch.exp(a[:, t].float())[..., None, None] + torch.einsum(
            "bhn,bhp->bhpn", Bm[:, t].float(), x[:, t].float())
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cm[:, t].float()))
    return torch.stack(ys, dim=1).to(x.dtype), h
