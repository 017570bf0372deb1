"""The reference's ``repro.distributed``, the part that needs no mesh:
gradient compression (``compression.py``)."""

from .compression import ErrorFeedback, compress_grads, int8_roundtrip, topk_mask

__all__ = ["ErrorFeedback", "compress_grads", "int8_roundtrip", "topk_mask"]
