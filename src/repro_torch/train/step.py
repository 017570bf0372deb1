"""Step factories: train / prefill / decode, the reference's ``train/step.py``.

``make_train_step`` returns ``(params, opt_state, batch) -> (params,
opt_state, {"loss": loss})``: the loss and its gradients through autograd,
the gradients compressed where ``Runtime.grad_compression`` asks for it
(``distributed/compression.py``), then the AdamW update, which the port
makes in place (see ``optim/adamw.py``); do not reuse the params or state
passed in.

``input_specs`` returns stand-ins for every model input of an (arch x
shape) cell on the ``meta`` device (shapes and dtypes, no allocation), the
inputs the dry-run traces the step on. Modality frontends (vision/audio)
are stubs: the specs carry precomputed embeddings next to the token stream.
"""

from __future__ import annotations

from typing import Any, Dict, Optional

import torch

from ..configs.base import ArchConfig, ShapeConfig
from ..distributed import compression
from ..models import Runtime, abstract_cache, decode_step, forward, loss_fn
from ..models.params import tree_leaves, tree_map
from ..optim import adamw_update

__all__ = ["make_train_step", "make_prefill_step", "make_decode_step", "input_specs",
           "loss_and_grads"]


def input_specs(cfg: ArchConfig, shape: ShapeConfig, rt: Optional[Runtime] = None
                ) -> Dict[str, Any]:
    """Meta-device stand-ins for one cell's step inputs."""
    rt = rt or Runtime()
    B, S = shape.global_batch, shape.seq_len

    def i32(*dims):
        return torch.empty(dims, dtype=torch.int32, device="meta")

    if shape.kind in ("train", "prefill"):
        batch: Dict[str, Any] = {"tokens": i32(B, S)}
        if shape.kind == "train":
            batch["labels"] = i32(B, S)
        if cfg.family == "encdec":
            batch["enc_embeds"] = torch.empty((B, S, cfg.d_model), dtype=rt.cdtype, device="meta")
        if cfg.frontend == "vision":
            # M-RoPE 3D position ids from the (stub) vision frontend
            batch["positions"] = i32(B, S, 3)
        return {"batch": batch}

    # decode: one new token against a seq_len cache
    cache = abstract_cache(cfg, rt, B, S, enc_len=(S if cfg.family == "encdec" else 0))
    return {"tokens": i32(B, 1), "cache": cache}


def make_train_step(cfg: ArchConfig, rt: Runtime, lr: float = 1e-4):
    """(params, opt_state, batch) -> (params, opt_state, metrics)."""

    def train_step(params, opt_state, batch: Dict[str, torch.Tensor]):
        loss, grad_tree = loss_and_grads(params, cfg, rt, batch)
        new_params, new_state = adamw_update(params, grad_tree, opt_state, lr=lr)
        return new_params, new_state, {"loss": loss.detach()}

    return train_step


def loss_and_grads(params, cfg: ArchConfig, rt: Runtime, batch: Dict[str, torch.Tensor]):
    """The train step before its update: the loss and the gradient tree,
    compressed where ``rt.grad_compression`` asks for it."""
    leaves = tree_leaves(params)
    with torch.enable_grad():
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss = loss_fn(params, cfg, rt, batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True, materialize_grads=True)
        finally:
            for p in leaves:
                p.requires_grad_(False)
    it = iter(grads)
    grad_tree = tree_map(lambda _: next(it), params)
    if rt.grad_compression != "none":
        grad_tree = compression.compress_grads(grad_tree, rt.grad_compression)
    return loss, grad_tree


def make_prefill_step(cfg: ArchConfig, rt: Runtime):
    """(params, batch) -> logits; the cache-building pass is the forward."""

    def prefill_step(params, batch):
        return forward(params, cfg, rt, tokens=batch.get("tokens"),
                       inputs_embeds=batch.get("inputs_embeds"),
                       positions=batch.get("positions"), enc_embeds=batch.get("enc_embeds"))

    return prefill_step


def make_decode_step(cfg: ArchConfig, rt: Runtime):
    def serve_step(params, cache, tokens):
        return decode_step(params, cfg, rt, cache, tokens)

    return serve_step
