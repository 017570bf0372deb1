"""The LM stack's model code, ported from the reference's ``models``
package: the dense family (``dense`` and the ``vlm`` backbone), the SSM
family (rwkv6-7b) and the hybrid family (zamba2-2.7b), for inference and
training (``loss_fn``), and the MoE family without MLA (mixtral-8x22b), for
inference. The enc-dec family, MLA and the training of the MoE family come
later (``ROADMAP.md`` item 10(c))."""

from .runtime import Runtime
from .params import ParamSpec, init_params, param_bytes
from .model import (
    build_param_specs,
    chunked_ce,
    forward,
    decode_step,
    init_cache,
    loss_fn,
)

__all__ = [
    "Runtime", "ParamSpec", "init_params", "param_bytes", "build_param_specs", "forward",
    "decode_step", "init_cache", "chunked_ce", "loss_fn",
]
