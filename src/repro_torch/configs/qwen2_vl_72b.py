"""qwen2-vl-72b [vlm] — backbone only; M-RoPE (t/h/w sections), dynamic
resolution via the vision-frontend stub [arXiv:2409.12191; hf].

80L d_model=8192 64H (GQA kv=8) d_ff=29568 vocab=152064.
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2-vl-72b",
    family="vlm",
    n_layers=80,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    d_ff=29568,
    vocab=152064,
    rope="mrope",
    frontend="vision",
)
