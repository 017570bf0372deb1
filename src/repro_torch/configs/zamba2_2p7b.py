"""zamba2-2.7b [hybrid] — Mamba2 backbone + shared attention blocks.

54L d_model=2560 32H (GQA kv=32) d_ff=10240 vocab=32000, ssm_state=64
[arXiv:2411.15242; hf]. The shared transformer block (full-attention GQA +
FFN, parameters shared across invocations) fires every 6 Mamba2 layers.
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-2.7b",
    family="hybrid",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm=SSMConfig(d_state=64, expand=2, head_dim=64, conv_dim=4, chunk=128),
    attn_every=6,
)
