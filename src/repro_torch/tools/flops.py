"""Analytic model FLOPs: the 6*N*D accounting for the roofline's
MODEL_FLOPS / step-FLOPs usefulness ratio (the reference's ``tools/flops.py``)."""

from __future__ import annotations

from ..configs.base import ArchConfig, ShapeConfig

__all__ = ["model_flops"]


def model_flops(cfg: ArchConfig, shape: ShapeConfig) -> float:
    """6 * N_active * tokens for training; 2 * N_active * tokens for
    forward-only (prefill); decode processes global_batch tokens."""
    n = cfg.active_param_count()
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n * tokens
    # decode: one token per sequence, but attention reads the whole cache —
    # param-FLOPs only here; cache reads are a *memory* term.
    tokens = shape.global_batch
    return 2.0 * n * tokens
