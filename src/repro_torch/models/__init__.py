"""The LM stack's model code, ported from the reference's ``models``
package: the dense family (``dense`` and the ``vlm`` backbone) for
inference. Training (``loss_fn``) and the other families come later
(``ROADMAP.md`` item 10)."""

from .runtime import Runtime
from .params import ParamSpec, init_params, param_bytes
from .model import (
    build_param_specs,
    forward,
    decode_step,
    init_cache,
)

__all__ = [
    "Runtime", "ParamSpec", "init_params", "param_bytes", "build_param_specs", "forward",
    "decode_step", "init_cache",
]
