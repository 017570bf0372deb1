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

The backward K12b has the same two routes. ``wkv_bwd_chunks`` models the
``serial`` one (a forward walk for the starting states, then the chunks
backward with dS carried), ``wkv_bwd_chunked`` the ``chunked`` one (every
chunk's two increments, the state pass forward and, with
``state_reverse_pass``, backward, every chunk's gradients). Both take each
chunk's increments and gradients from the same per-chunk functions, so
their states (``wkv_bwd_states``) are equal. The card's tensor-core form of
the chunked route (bf16 activations, the model's function) takes the state
products' float32 operands as hi + lo bf16 halves; these models take them
in float32, and the card is held to its plain version within two bf16
steps.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["state_reverse_pass", "wkv_bwd_chunked", "wkv_bwd_chunks", "wkv_bwd_plain",
           "wkv_bwd_states", "wkv_chunk_outputs", "wkv_chunk_states", "wkv_chunked", "wkv_plain",
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


def wkv_bwd_plain(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                  u: torch.Tensor, dy: torch.Tensor, dstate: Optional[torch.Tensor], chunk: int,
                  bf16_intra: bool) -> Tuple[torch.Tensor, ...]:
    """The plain version of K12's backward (K12b): autograd of ``wkv_plain``
    recomputed from the saved inputs, as the reference's backward is
    ``jax.vjp`` of its oracle. ``dy`` is y's gradient, ``dstate`` the final
    state's (or None) -> (dr, dk, dv, dw, du) of the inputs' shapes and
    dtypes. A bf16 rounding inside the forward (``bf16_intra``) rounds the
    gradient that crosses it to bf16, as JAX's transpose of a cast does."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (r, k, v, w, u)]
        y, state = wkv_plain(*leaves, chunk, bf16_intra)
        outs, grads = [y], [dy]
        if dstate is not None:
            outs.append(state)
            grads.append(dstate)
        return torch.autograd.grad(outs, leaves, grads)


def _wkv_increments(rk, kk, vk, wk, g):
    """One chunk's (B, c, H, K) float32 slices -> (the forward's increment
    (k e^(total - cs))^T v, the backward's (r e^d)^T dy, both (B, H, K, K),
    and e^total (B, H, K)), as both CPU models of K12b compute them."""
    cs = torch.cumsum(wk, dim=1)
    fwd = torch.einsum("bshk,bshv->bhkv", kk * torch.exp(cs[:, -1:] - cs), vk)
    bwd = torch.einsum("bqhk,bqhv->bhkv", rk * torch.exp(cs - wk), g)
    return fwd, bwd, torch.exp(cs[:, -1])


def _wkv_chunk_grads(rk, kk, vk, wk, g, uu, S0, dS, rnd, lower):
    """One chunk's gradients from its starting state S0 and its end state's
    gradient dS (B, H, K, K), with the closed forms of K12b's header ->
    (dr, dk, dv, dw (B, c, H, K), this chunk's share of du (B, H, K)),
    float32."""
    cs = torch.cumsum(wk, dim=1)
    tot = cs[:, -1]
    d = cs - wk
    m = 0.5 * (tot - wk[:, 0])[:, None]
    RD, RFu = rk * torch.exp(d), rk * torch.exp(d - m)
    KFu, KW = kk * torch.exp(m - cs), kk * torch.exp(tot[:, None] - cs)
    RF, KF = rnd(RFu), rnd(KFu)
    A = rnd(torch.where(lower, torch.einsum("bqhk,bshk->bqsh", RF, KF), 0.0))
    dA = torch.where(lower, rnd(torch.einsum("bqhv,bshv->bqsh", g, rnd(vk))), 0.0)
    dRF = rnd(torch.einsum("bqsh,bshk->bqhk", dA, KF))
    dKF = rnd(torch.einsum("bqsh,bqhk->bshk", dA, RF))
    dVi = rnd(torch.einsum("bqsh,bqhv->bshv", A, g))
    dRD = torch.einsum("bqhv,bhkv->bqhk", g, S0)
    dKW = torch.einsum("bshv,bhkv->bshk", vk, dS)
    dVs = torch.einsum("bshk,bhkv->bshv", KW, dS)
    cur = (rk * uu * kk).sum(-1, keepdim=True)
    dcur = (g * vk).sum(-1, keepdim=True)
    dr = dRD * torch.exp(d) + dRF * torch.exp(d - m) + dcur * uu * kk
    dk = dKW * torch.exp(tot[:, None] - cs) + dKF * torch.exp(m - cs) + dcur * uu * rk
    dv = dVs + dVi + cur * g
    e1, e2, e3, e4 = dRD * RD, dRF * RFu, dKF * KFu, dKW * KW
    gm = (e3 - e2).sum(1)
    gtot = e4.sum(1) + torch.exp(tot) * (dS * S0).sum(-1) + 0.5 * gm
    gcs = e1 + e2 - e3 - e4
    gcs[:, -1] += gtot
    gw = -(e1 + e2)
    gw[:, 0] -= 0.5 * gm
    return dr, dk, dv, gw + gcs.flip(1).cumsum(1).flip(1), (dcur * rk * kk).sum(1)


def _wkv_bwd(r, k, v, w, u, dy, dstate, chunk: int, bf16_intra: bool, chunked: bool):
    """Both CPU models of K12b -> (the gradients as ``wkv_bwd_plain``
    returns them, each chunk's starting state and its end state's gradient,
    (B, H, nc, K, K) each). ``chunked``: the chunked route's three launches
    (every chunk's two increments, the two state passes, every chunk's
    gradients; du's per-chunk shares summed in chunk order); else the serial
    route's walks (the starting states forward, then the chunks backward
    with dS carried, du summed from the last chunk)."""
    B, S, H, K = r.shape
    c = chunk
    nc = S // c if S else 0
    rnd = _bf16 if bf16_intra else (lambda t: t)
    lower = torch.ones((c, c), dtype=torch.bool, device=r.device).tril(-1)[None, :, :, None]
    f = [t.float() for t in (r, k, v, w, dy)]
    uu = u.float()[:, None]                                          # (Bu, 1, H, K)
    slices = [[t[:, j * c:(j + 1) * c] for t in f] for j in range(nc)]
    d0 = torch.zeros((B, H, K, K), dtype=torch.float32, device=r.device)
    dlast = d0 if dstate is None else dstate.float()
    if chunked:
        incs = [_wkv_increments(*sl) for sl in slices]
        if nc:
            decay = torch.stack([i[2] for i in incs], 2)
            starts = wkv_state_pass(torch.stack([i[0] for i in incs], 2), decay)[0]
            ends = state_reverse_pass(torch.stack([i[1] for i in incs], 2), decay[..., None],
                                      dlast)
        else:
            starts = ends = torch.zeros((B, H, 0, K, K), dtype=torch.float32, device=r.device)
    else:
        st, sts = d0, []
        for sl in slices:
            fwd, _, dec = _wkv_increments(*sl)
            sts.append(st)
            st = dec[..., None] * st + fwd
        dS, en = dlast, [None] * nc
        for j in reversed(range(nc)):
            en[j] = dS
            _, bwd, dec = _wkv_increments(*slices[j])
            dS = dec[..., None] * dS + bwd
        starts = torch.stack(sts, 2) if nc else torch.zeros((B, H, 0, K, K), device=r.device)
        ends = torch.stack(en, 2) if nc else starts
    grads = [torch.empty_like(t) for t in f[:4]]
    shares = []
    for j, sl in enumerate(slices):
        *gj, du_j = _wkv_chunk_grads(*sl[:4], sl[4], uu, starts[:, :, j], ends[:, :, j], rnd,
                                     lower)
        for gr, gv in zip(grads, gj):
            gr[:, j * c:(j + 1) * c] = gv
        shares.append(du_j)
    du = torch.zeros((B, H, K), dtype=torch.float32, device=r.device)
    for du_j in (shares if chunked else reversed(shares)):
        du = du + du_j
    du = du if u.shape[0] == B and B > 1 else du.sum(0, keepdim=True)
    return (*(gr.to(t.dtype) for gr, t in zip(grads, (r, k, v, w))), du), starts, ends


def wkv_bwd_chunks(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   u: torch.Tensor, dy: torch.Tensor, dstate: Optional[torch.Tensor],
                   chunk: int, bf16_intra: bool) -> Tuple[torch.Tensor, ...]:
    """K12b's ``serial`` route in plain PyTorch (the CPU model of
    ``csrc/rwkv6_wkv_bwd.cu``'s first design, used by the tests): the
    arguments and results of ``wkv_bwd_plain``, computed as the kernel
    computes them: a forward walk keeping each chunk's starting state, then
    the chunks backward with the closed-form gradients of the source's
    header, dS carried."""
    return _wkv_bwd(r, k, v, w, u, dy, dstate, chunk, bf16_intra, False)[0]


def wkv_bwd_chunked(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                    u: torch.Tensor, dy: torch.Tensor, dstate: Optional[torch.Tensor],
                    chunk: int, bf16_intra: bool) -> Tuple[torch.Tensor, ...]:
    """K12b's ``chunked`` route in plain PyTorch: the arguments and results
    of ``wkv_bwd_plain``, computed as the route's three launches compute
    them: every chunk's two increments, the forward state pass (starting
    states) and the reverse one (end states' gradients), every chunk's
    gradients, du's per-chunk shares summed in chunk order."""
    return _wkv_bwd(r, k, v, w, u, dy, dstate, chunk, bf16_intra, True)[0]


def wkv_bwd_states(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor, w: torch.Tensor,
                   dy: torch.Tensor, dstate: Optional[torch.Tensor], chunk: int, chunked: bool
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each chunk's starting state and its end state's gradient (B, H, nc,
    K, K) as the ``chunked`` (passes over the increments) or ``serial``
    (walks) model of K12b computes them."""
    u = torch.zeros((1,) + r.shape[2:], dtype=torch.float32, device=r.device)
    return _wkv_bwd(r, k, v, w, u, dy, dstate, chunk, False, chunked)[1:]


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


def state_reverse_pass(inc: torch.Tensor, decay: torch.Tensor, dlast: torch.Tensor
                       ) -> torch.Tensor:
    """Step 2's reverse direction: dS = decay_j * dS + inc_j over the chunks
    j from the last, from dS = ``dlast`` (the final state's gradient);
    inc (B, H, nc, ...), decay broadcasting against one chunk's slot ->
    each chunk's end state's gradient (B, H, nc, ...)."""
    ends = torch.empty_like(inc)
    dS = dlast
    for j in reversed(range(inc.shape[2])):
        ends[:, :, j] = dS
        dS = decay[:, :, j] * dS + inc[:, :, j]
    return ends


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
