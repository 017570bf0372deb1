"""AdamW with a dtype-configurable state, the reference's ``optim/adamw.py``.

The arithmetic is the reference's: global-norm clipping of the gradients in
float32, bias corrections ``c = 1 - b ** step`` in float32, the moment and
parameter updates in float32, the moments stored in the state's dtype and
the parameters cast back to their own. ``torch.optim.AdamW`` computes
another formula (decay applied before the step, no clipping), so the port
keeps this one.

The reference returns new arrays, and the caller donates the old ones to
XLA, which reuses their buffers. The port updates ``params`` and the state's
moments in place instead, leaf by leaf and in slices of ``_SLICE`` elements
along the flattened leaf, so that the float32 temporaries stay small at an
8-billion-parameter scale; ``adamw_update`` returns the same tensors. The
update is elementwise, so slicing changes no result.
"""

from __future__ import annotations

from typing import Any, NamedTuple, Optional, Tuple

import torch

from ..models.params import tree_leaves, tree_map

__all__ = ["AdamWState", "adamw_init", "adamw_init_abstract", "adamw_update"]

_SLICE = 1 << 24  # elements per slice of the in-place update


class AdamWState(NamedTuple):
    step: torch.Tensor     # () int32, on the parameters' device
    m: Any                 # tree like params
    v: Any


def adamw_init(params, dtype: torch.dtype = torch.float32) -> AdamWState:
    leaves = tree_leaves(params)
    dev = leaves[0].device if leaves else torch.device("cpu")
    z = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)  # noqa: E731
    return AdamWState(torch.zeros((), dtype=torch.int32, device=dev), tree_map(z, params),
                      tree_map(z, params))


def adamw_init_abstract(params, dtype: torch.dtype = torch.float32) -> AdamWState:
    """The state of ``adamw_init`` on the ``meta`` device: shapes, no storage."""
    z = lambda p: torch.empty(p.shape, dtype=dtype, device="meta")  # noqa: E731
    return AdamWState(torch.empty((), dtype=torch.int32, device="meta"), tree_map(z, params),
                      tree_map(z, params))


def _f32(x: float, device: torch.device) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def adamw_update(
    params,
    grads,
    state: AdamWState,
    lr: float = 1e-4,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    clip_norm: Optional[float] = 1.0,
) -> Tuple[Any, AdamWState]:
    """One AdamW step on the trees ``params`` and ``grads`` (same keys), in
    place; returns ``(params, state)`` with ``state.step`` advanced."""
    dev = state.step.device
    step = state.step + 1
    flat_g = tree_leaves(grads)
    if clip_norm is not None:
        sq = _f32(0.0, dev)
        for g in flat_g:
            sq = sq + torch.sum(torch.square(g.float()))
        gnorm = torch.sqrt(sq)
        # a tensor divisor: torch computes ``float / tensor`` as a reciprocal
        # times the float, which rounds twice
        scale = torch.minimum(_f32(1.0, dev),
                              torch.div(_f32(clip_norm, dev), torch.clamp(gnorm, min=1e-9)))
    else:
        scale = _f32(1.0, dev)
    c1 = 1.0 - torch.pow(_f32(b1, dev), step.float())
    c2 = 1.0 - torch.pow(_f32(b2, dev), step.float())

    def upd(p, g, m, v):
        g32 = g.float() * scale
        m32 = m.float() * b1 + g32 * (1 - b1)
        v32 = v.float() * b2 + g32 * g32 * (1 - b2)
        mhat = m32 / c1
        vhat = v32 / c2
        p32 = p.float()
        delta = mhat / (torch.sqrt(vhat) + eps) + weight_decay * p32
        p.copy_(p32 - lr * delta)
        m.copy_(m32)
        v.copy_(v32)

    for p, g, m, v in zip(tree_leaves(params), flat_g, tree_leaves(state.m),
                          tree_leaves(state.v)):
        if g.shape != p.shape:
            raise ValueError(f"gradient of shape {tuple(g.shape)} for a parameter of shape "
                             f"{tuple(p.shape)}")
        views = [t.view(-1) for t in (p, g.contiguous(), m, v)]
        for s0 in range(0, p.numel(), _SLICE):
            upd(*(t[s0:s0 + _SLICE] for t in views))
    return params, AdamWState(step, state.m, state.v)
