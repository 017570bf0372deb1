"""Step factories: train / prefill / decode, the reference's ``train/step.py``.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, {"loss": loss})``: the loss and its gradients through autograd,
then the AdamW update, which the port makes in place (see
``optim/adamw.py``); do not reuse the params or state passed in. The
reference's ``input_specs`` (JAX ``ShapeDtypeStruct`` stand-ins for the
multi-pod dry-run) comes with ROADMAP.md item 11, and so does gradient
compression.
"""

from __future__ import annotations

from typing import Dict

import torch

from ..configs.base import ArchConfig
from ..models import Runtime, decode_step, forward, loss_fn
from ..models.params import tree_leaves, tree_map
from ..optim import adamw_update

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step"]


def make_train_step(cfg: ArchConfig, rt: Runtime, lr: float = 1e-4):
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""
    if rt.grad_compression != "none":
        raise NotImplementedError(
            f"Runtime.grad_compression={rt.grad_compression!r} is not ported yet (ROADMAP.md "
            f"item 11, with the distribution work)")

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        leaves = tree_leaves(params)
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_(True)
            try:
                loss = loss_fn(params, cfg, rt, batch)
                grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                            materialize_grads=True)
            finally:
                for p in leaves:
                    p.requires_grad_(False)
        it = iter(grads)
        grad_tree = tree_map(lambda _: next(it), params)
        new_params, new_state = adamw_update(params, grad_tree, opt_state, lr=lr)
        return new_params, new_state, {"loss": loss.detach()}

    return train_step


def make_prefill_step(cfg: ArchConfig, rt: Runtime):
    """(params, batch) -> logits; the cache-building pass is the forward."""

    def prefill_step(params, batch):
        return forward(params, cfg, rt, tokens=batch.get("tokens"),
                       inputs_embeds=batch.get("inputs_embeds"),
                       positions=batch.get("positions"))

    return prefill_step


def make_decode_step(cfg: ArchConfig, rt: Runtime):
    def serve_step(params, cache, tokens):
        return decode_step(params, cfg, rt, cache, tokens)

    return serve_step
