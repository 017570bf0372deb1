"""The LM stack's model code, ported from the reference's ``models``
package: the dense family (``dense`` and the ``vlm`` backbone), for
inference and training (``loss_fn``). The other families come later
(``ROADMAP.md`` item 10(c))."""

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
