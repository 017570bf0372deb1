"""nemotron-4-340b [dense] — GQA, squared-ReLU FFN.

96L d_model=18432 96H (GQA kv=8) d_ff=73728 vocab=256000
[arXiv:2402.16819; unverified].
"""

from .base import ArchConfig

CONFIG = ArchConfig(
    name="nemotron-4-340b",
    family="dense",
    n_layers=96,
    d_model=18432,
    n_heads=96,
    n_kv_heads=8,
    d_ff=73728,
    vocab=256000,
    act="sq_relu",
)
