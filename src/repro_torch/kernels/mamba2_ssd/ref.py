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

The backward K8b has the same two routes. ``ssd_bwd_chunks`` models the
``serial`` one (a forward walk for the starting states, then the chunks
backward with dh carried), ``ssd_bwd_chunked`` the ``chunked`` one (every
chunk's two increments, the state pass forward and, with
``state_reverse_pass``, backward, every chunk's gradients). Both take each
chunk's increments and gradients from the same per-chunk functions, so
their states (``ssd_bwd_states``) are equal. The card's tensor-core form of
the chunked route (bf16 activations, the model's function) takes the state
products' float32 operands as hi + lo bf16 halves; these models take them
in float32, and the card is held to its plain version within two bf16
steps.

``ssd_ref`` is the reference's sequential oracle (``mamba2_ssd/ref.py``),
kept for the tests.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..rwkv6_wkv.ref import state_reverse_pass

__all__ = ["ssd_bwd_chunked", "ssd_bwd_chunks", "ssd_bwd_plain", "ssd_bwd_states",
           "ssd_chunk_outputs", "ssd_chunk_states", "ssd_chunked", "ssd_plain", "ssd_ref",
           "ssd_state_pass", "state_reverse_pass"]


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


def ssd_bwd_plain(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, a: torch.Tensor,
                  dy: torch.Tensor, dstate: Optional[torch.Tensor], chunk: int, model: bool
                  ) -> Tuple[torch.Tensor, ...]:
    """The plain version of K8's backward (K8b): autograd of ``ssd_plain``
    recomputed from the saved inputs, as the reference's backward is
    ``jax.vjp`` of its oracle. ``dy`` is y's gradient, ``dstate`` the final
    state's (or None) -> (dx, dB, dC, da) of the inputs' shapes and dtypes.
    Each model-form rounding to x's dtype rounds the gradient that crosses
    it, as JAX's transpose of a cast does."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (x, Bm, Cm, a)]
        y, state = ssd_plain(*leaves, chunk, model)
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate)
        return torch.autograd.grad(outs, leaves, grads)


def _ssd_increments(xk, bk, ck, g, ak):
    """One chunk's float32 slices (x, B, C, dy (Bt, c, H, W); a (Bt, c, H))
    -> (the forward's increment x^T (B e^(total - cs)), the backward's dy^T
    (C e^cs), both (Bt, H, P, N), and e^total (Bt, H)), as both CPU models
    of K8b compute them."""
    cs = torch.cumsum(ak, dim=1)
    fwd = torch.einsum("bkhn,bkhp->bhpn", bk * torch.exp(cs[:, -1:] - cs)[..., None], xk)
    bwd = torch.einsum("bqhp,bqhn->bhpn", g, ck * torch.exp(cs)[..., None])
    return fwd, bwd, torch.exp(cs[:, -1])


def _ssd_chunk_grads(xk, bk, ck, g, ak, h0, dh, rnd, tri):
    """One chunk's gradients from its starting state h0 and its end state's
    gradient dh (Bt, H, P, N), with the closed forms of K8b's header -> (dx,
    dB, dC (Bt, c, H, W), da (Bt, c, H)), float32."""
    cs = torch.cumsum(ak, dim=1)                                       # (Bt, c, H)
    tot = cs[:, -1]
    e, wg = torch.exp(cs), torch.exp(tot[:, None] - cs)
    L = torch.where(tri, torch.exp(torch.where(tri, cs[:, :, None] - cs[:, None], 0.0)), 0.0)
    SC = torch.where(tri, rnd(torch.einsum("bqhn,bshn->bqsh", ck, bk)), 0.0)
    gs = torch.where(tri, rnd(torch.einsum("bqhp,bshp->bqsh", g, xk)), 0.0)
    grel = gs * SC * L
    rs, gSC = rnd(SC * L), rnd(gs * L)
    dCE = torch.einsum("bqhp,bhpn->bqhn", g, h0)
    dBw = torch.einsum("bshp,bhpn->bshn", xk, dh)
    dC = torch.einsum("bqsh,bshn->bqhn", gSC, bk) + dCE * e[..., None]
    dB = torch.einsum("bqsh,bqhn->bshn", gSC, ck) + dBw * wg[..., None]
    dx = (torch.einsum("bqsh,bqhp->bshp", rs, g)
          + torch.einsum("bshn,bhpn->bshp", bk * wg[..., None], dh))
    ex1 = (dCE * ck).sum(-1) * e
    ex2 = (dBw * bk).sum(-1)
    gcs = grel.sum(2) - grel.sum(1) + ex1 - ex2 * wg
    gcs[:, -1] += torch.exp(tot) * (dh * h0).sum((-2, -1)) + (ex2 * wg).sum(1)
    return dx, dB, dC, gcs.flip(1).cumsum(1).flip(1)


def _ssd_bwd(x, Bm, Cm, a, dy, dstate, chunk: int, model: bool, chunked: bool):
    """Both CPU models of K8b -> (the gradients as ``ssd_bwd_plain``
    returns them, each chunk's starting state and its end state's gradient,
    (Bt, H, nc, P, N) each). ``chunked``: the chunked route's three launches
    (every chunk's two increments, the two state passes, every chunk's
    gradients); else the serial route's walks (the starting states forward,
    then the chunks backward with dh carried)."""
    Bt, S, H, P = x.shape
    N = Bm.shape[-1]
    c = chunk
    nc = S // c if S else 0
    dt = x.dtype
    rnd = (lambda t: t.to(dt).float()) if model else (lambda t: t)
    tri = torch.ones((c, c), dtype=torch.bool, device=x.device).tril()[None, :, :, None]
    f = [t.float() for t in (x, Bm, Cm, dy)] + [a.float()]
    slices = [[t[:, j * c:(j + 1) * c] for t in f] for j in range(nc)]
    d0 = torch.zeros((Bt, H, P, N), dtype=torch.float32, device=x.device)
    dlast = d0 if dstate is None else dstate.float()
    empty = torch.zeros((Bt, H, 0, P, N), dtype=torch.float32, device=x.device)
    if chunked:
        incs = [_ssd_increments(*sl) for sl in slices]
        if nc:
            decay = torch.stack([i[2] for i in incs], 2)
            starts = ssd_state_pass(torch.stack([i[0] for i in incs], 2), decay)[0]
            ends = state_reverse_pass(torch.stack([i[1] for i in incs], 2),
                                      decay[..., None, None], dlast)
        else:
            starts = ends = empty
    else:
        h, sts = d0, []
        for sl in slices:
            fwd, _, dec = _ssd_increments(*sl)
            sts.append(h)
            h = dec[:, :, None, None] * h + fwd
        dh, en = dlast, [None] * nc
        for j in reversed(range(nc)):
            en[j] = dh
            _, bwd, dec = _ssd_increments(*slices[j])
            dh = dec[:, :, None, None] * dh + bwd
        starts = torch.stack(sts, 2) if nc else empty
        ends = torch.stack(en, 2) if nc else empty
    grads = [torch.empty_like(t) for t in f[:3]] + [torch.empty_like(f[4])]
    for j, sl in enumerate(slices):
        for gr, gv in zip(grads, _ssd_chunk_grads(*sl, starts[:, :, j], ends[:, :, j], rnd, tri)):
            gr[:, j * c:(j + 1) * c] = gv
    return (tuple(gr.to(t.dtype) for gr, t in zip(grads, (x, Bm, Cm, a))), starts, ends)


def ssd_bwd_chunks(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, a: torch.Tensor,
                   dy: torch.Tensor, dstate: Optional[torch.Tensor], chunk: int, model: bool
                   ) -> Tuple[torch.Tensor, ...]:
    """K8b's ``serial`` route in plain PyTorch (the CPU model of
    ``csrc/mamba2_ssd_bwd.cu``'s first design, used by the tests): the
    arguments and results of ``ssd_bwd_plain``, computed as the kernel
    computes them: a forward walk keeping each chunk's starting state, then
    the chunks backward with the closed-form gradients of the source's
    header, dh carried."""
    return _ssd_bwd(x, Bm, Cm, a, dy, dstate, chunk, model, False)[0]


def ssd_bwd_chunked(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, a: torch.Tensor,
                    dy: torch.Tensor, dstate: Optional[torch.Tensor], chunk: int, model: bool
                    ) -> Tuple[torch.Tensor, ...]:
    """K8b's ``chunked`` route in plain PyTorch: the arguments and results
    of ``ssd_bwd_plain``, computed as the route's three launches compute
    them: every chunk's two increments, the forward state pass (starting
    states) and the reverse one (end states' gradients), every chunk's
    gradients."""
    return _ssd_bwd(x, Bm, Cm, a, dy, dstate, chunk, model, True)[0]


def ssd_bwd_states(x: torch.Tensor, Bm: torch.Tensor, Cm: torch.Tensor, a: torch.Tensor,
                   dy: torch.Tensor, dstate: Optional[torch.Tensor], chunk: int, chunked: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each chunk's starting state and its end state's gradient (Bt, H, nc,
    P, N) as the ``chunked`` (passes over the increments) or ``serial``
    (walks) model of K8b computes them."""
    return _ssd_bwd(x, Bm, Cm, a, dy, dstate, chunk, False, chunked)[1:]


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
