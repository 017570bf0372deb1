"""Runtime (system) configuration — the knobs the framework itself exposes.

The same fields as the reference's ``Runtime``, so that one configuration
names the same run in both packages. Everything here changes *how* a model
runs, never *what* it computes.

In the port the numerics (``param_dtype``, ``compute_dtype``,
``softmax_dtype``, and ``opt_state_dtype``, the dtype of the AdamW moments
that ``Trainer`` allocates), the attention route (``attn_impl``,
``attn_chunk``, ``q_block``, ``kv_block``) and the MoE capacity
(``capacity_factor``) take effect, and so do ``remat`` (each layer
recomputed in the backward: ``"dots"`` keeps the products' results,
``"none"`` everything, any other value nothing) and ``grad_compression``
(``"int8"`` or ``"topk"`` between the backward and AdamW, as the
reference's ``make_train_step`` applies it).

The distribution fields act on a mesh (``distributed/sharding.py``), as in
the reference: ``fsdp`` through ``make_param_rules``' ``embed`` rule (the
parameters' data-axis sharding), ``act_shard`` and ``seq_shard`` through
``models.blocks.shard_batch`` (the residual stream's batch and sequence
placement), and ``dp_size`` is the mesh's data-parallel degree, inferred
when None and checked against the mesh otherwise (``sharding.dp_size``).
The dry-run (``launch/dryrun.py``) reads all four. On one card the mesh
is 1 x 1, every placement is ``Replicate`` and ``shard_batch`` is the
identity, so they change nothing there. ``zero1``,
``overlap_collective_matmul``, ``pp_stages`` and ``pp_microbatches`` are
read by neither package's step: the features they name are
``distributed/overlap.py`` and ``distributed/pipeline.py``, called
directly. ``matmul_precision``, ``scan_layers``, ``scan_unroll`` steer XLA
in the reference and have no effect here (PyTorch runs eagerly), and the
reference's MoE layer reads no ``moe_impl`` either.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["Runtime", "torch_dtype"]

_DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float64": torch.float64,
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a numpy-style dtype name (``"bfloat16"``...)."""
    try:
        return _DTYPES[name]
    except KeyError:
        raise ValueError(f"unsupported dtype name {name!r}; known: {sorted(_DTYPES)}") from None


@dataclass(frozen=True)
class Runtime:
    # numerics
    param_dtype: str = "bfloat16"
    compute_dtype: str = "bfloat16"
    softmax_dtype: str = "float32"
    opt_state_dtype: str = "float32"       # bf16 halves optimizer memory
    matmul_precision: str = "default"      # default | high | highest
    # memory/compute scheduling
    remat: str = "none"                    # none | full | dots | attn
    scan_layers: bool = True
    scan_unroll: int = 1
    # attention
    attn_impl: str = "xla"                 # xla (plain blocked) | flash (kernel K4) | chunked
    attn_chunk: int = 2048                 # kv-chunk for the plain blocked attention
    q_block: int = 512                     # flash block sizes
    kv_block: int = 1024
    # MoE
    moe_impl: str = "dense"                # dense (einsum capacity) | ragged
    capacity_factor: Optional[float] = None  # None => arch default
    # distribution
    dp_size: Optional[int] = None          # None => infer from mesh
    act_shard: bool = True                 # constrain activations to batch-DP
    fsdp: bool = True                      # shard params over data axis (ZeRO-3)
    zero1: bool = True                     # shard optimizer state over data axis
    seq_shard: bool = False                # sequence parallelism for long ctx
    grad_compression: str = "none"         # none | int8 | topk
    overlap_collective_matmul: bool = False
    # pipeline (optional; carved from the data axis)
    pp_stages: int = 1
    pp_microbatches: int = 1

    @property
    def cdtype(self) -> torch.dtype:
        return torch_dtype(self.compute_dtype)

    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)
