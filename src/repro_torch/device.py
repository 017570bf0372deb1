"""Device policy of the port.

Every entry point takes ``device=None``, which means the CUDA card. A run
without a card raises unless the caller asked for the host with
``device="cpu"``; nothing in the package falls back to the CPU on its own.
``device="meta"`` gives tensors with a shape and no storage, which the
dry-run's abstract trees use.
"""

from __future__ import annotations

from typing import Optional, Union

import torch

DeviceLike = Optional[Union[str, torch.device]]

__all__ = ["DeviceLike", "resolve_device"]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """``None`` -> ``cuda``; raise if a CUDA device is asked for and absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions on the host"
            )
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type not in ("cpu", "meta"):
        raise ValueError(f"unsupported device {dev}")
    return dev
