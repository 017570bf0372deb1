"""Launch counters of the port's CUDA kernels.

Each wrapper adds one to ``LAUNCHES[name]`` right after its kernel is
launched on the card, and one to ``PLAIN_CALLS[name]`` when a CPU tensor
sends it to the kernel's plain PyTorch version. A kernel with several
routes on the card (K9 and K11 choose one by shape) also adds one to
``ROUTE_LAUNCHES["name/route"]``. A run sets all three to zero with
:func:`reset`, drives the path, and reads them back to show which route
the path took.
"""

from __future__ import annotations

from typing import Dict

__all__ = ["KERNELS", "LAUNCHES", "PLAIN_CALLS", "ROUTE_LAUNCHES", "reset", "snapshot"]

KERNELS = (
    "forest_eval", "radix_rank", "chain_ordinals", "flash_attn_fwd", "flash_attn_dq",
    "flash_attn_dkv", "moe_gmm", "rmsnorm_fwd", "rmsnorm_bwd", "rwkv6_wkv", "mamba2_ssd",
    "flash_decode", "qs_descent", "combine_ei", "rwkv6_wkv_bwd", "mamba2_ssd_bwd",
)

LAUNCHES: Dict[str, int] = dict.fromkeys(KERNELS, 0)
PLAIN_CALLS: Dict[str, int] = dict.fromkeys(KERNELS, 0)
ROUTE_LAUNCHES: Dict[str, int] = {}


def reset() -> None:
    for k in KERNELS:
        LAUNCHES[k] = 0
        PLAIN_CALLS[k] = 0
    ROUTE_LAUNCHES.clear()


def snapshot() -> Dict[str, Dict[str, int]]:
    return {"launches": dict(LAUNCHES), "plain_calls": dict(PLAIN_CALLS),
            "route_launches": dict(ROUTE_LAUNCHES)}
