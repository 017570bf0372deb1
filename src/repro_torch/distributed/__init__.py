"""The reference's ``repro.distributed`` on ``torch.distributed``: sharding
rules on a ``DeviceMesh`` (``sharding.py``), GPipe pipelining
(``pipeline.py``), the ring collective-matmul (``overlap.py``) and gradient
compression (``compression.py``)."""

from .compression import ErrorFeedback, compress_grads, int8_roundtrip, topk_mask
from .sharding import (
    assign_pspec,
    cache_axes,
    make_param_rules,
    shardings_for_specs,
    shardings_for_tree,
)

__all__ = [
    "ErrorFeedback", "compress_grads", "int8_roundtrip", "topk_mask",
    "assign_pspec", "cache_axes", "make_param_rules", "shardings_for_specs",
    "shardings_for_tree",
]
