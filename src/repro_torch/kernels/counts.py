"""Launch counters of the port's CUDA kernels.

Each wrapper adds one to ``LAUNCHES[name]`` right after its kernel is
launched on the card, and one to ``PLAIN_CALLS[name]`` when a CPU tensor
sends it to the kernel's plain PyTorch version. A run sets both to zero
with :func:`reset`, drives the path, and reads them back to show which
route the path took.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["KERNELS", "LAUNCHES", "PLAIN_CALLS", "reset", "snapshot"]

KERNELS = (
    "forest_eval", "radix_rank", "chain_ordinals", "flash_attn_fwd", "flash_attn_dq",
    "flash_attn_dkv", "moe_gmm", "rmsnorm_fwd", "rmsnorm_bwd", "rwkv6_wkv", "mamba2_ssd",
    "flash_decode",
)

LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(KERNELS, 0)


def reset() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0


def snapshot() -> Dict[str, Dict[str, int]]:
    return {"launches": dict(LAUNCHES), "plain_calls": dict(PLAIN_CALLS)}
