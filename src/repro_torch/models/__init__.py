"""The LM stack's model code, ported from the reference's ``models``
package: the dense family (``dense`` and the ``vlm`` backbone), the SSM
family (rwkv6-7b), the hybrid family (zamba2-2.7b) and the MoE family
(mixtral-8x22b with GQA, deepseek-v3 with MLA and its multi-token
prediction) and the enc-dec family (seamless-m4t-medium), for inference and
training (``loss_fn``, with the reference's ``Runtime.remat`` policies)."""

from .runtime import Runtime
from .params import ParamSpec, abstract_params, init_params, param_bytes, spec_shardings
from .model import (
    abstract_cache,
    build_param_specs,
    chunked_ce,
    forward,
    decode_step,
    init_cache,
    loss_fn,
)

__all__ = [
    "Runtime", "ParamSpec", "abstract_cache", "abstract_params", "init_params", "param_bytes",
    "spec_shardings", "build_param_specs", "forward", "decode_step", "init_cache",
    "chunked_ce", "loss_fn",
]
