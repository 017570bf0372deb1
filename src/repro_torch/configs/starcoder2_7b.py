"""starcoder2-7b [dense] — GQA kv=4, RoPE [arXiv:2402.19173; hf]."""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-7b",
    family="dense",
    n_layers=32,
    d_model=4608,
    n_heads=36,
    n_kv_heads=4,
    d_ff=18432,
    vocab=49152,
    act="gelu",
)
