"""seamless-m4t-medium [audio] — enc-dec backbone; speech frontend stub.

12L d_model=1024 16H (kv=16) d_ff=4096 vocab=256206 [arXiv:2308.11596; hf].
12 encoder layers (bidirectional) + 12 decoder layers (causal + cross-attn).
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="seamless-m4t-medium",
    family="encdec",
    n_layers=12,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=4096,
    vocab=256206,
    n_encoder_layers=12,
    frontend="audio",
)
