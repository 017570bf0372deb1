"""rwkv6-7b [ssm] — Finch, data-dependent decay, attention-free.

32L d_model=4096 (attn-free) d_ff=14336 vocab=65536 [arXiv:2404.05892; hf].
"""

from .base import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=64,          # wkv heads, head_dim 64
    n_kv_heads=64,
    d_ff=14336,
    vocab=65536,
    rope="none",
    ssm=SSMConfig(d_state=64, expand=1, head_dim=64, conv_dim=0, chunk=64),
)
