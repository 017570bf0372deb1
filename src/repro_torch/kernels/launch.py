"""Argument checks and the ctypes call shared by the kernel wrappers."""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Sequence, Tuple

import torch

from . import build
from .counts import LAUNCHES

__all__ = ["check", "launch"]

_FNS: Dict[str, ctypes._CFuncPtr] = {}


def check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: Tuple[int, ...],
          device: torch.device) -> None:
    """Raise unless ``t`` is a contiguous ``dtype`` tensor of ``shape`` on
    ``device`` (-1 in ``shape`` matches any extent)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(s != e for s, e in zip(t.shape, shape) if e != -1):
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _fn(kernel: str, symbol: str, n_ptrs: int, n_ints: int):
    fn = _FNS.get(symbol)
    if fn is None:
        fn = getattr(build.load(kernel), symbol)
        fn.argtypes = [ctypes.c_void_p] * n_ptrs + [ctypes.c_int] * n_ints + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FNS[symbol] = fn
    return fn


def launch(kernel: str, symbol: str, device: torch.device,
           tensors: Sequence[torch.Tensor], ints: Sequence[int],
           source: Optional[str] = None) -> None:
    """Call ``symbol`` of the library built from ``source`` (by default
    ``kernel``) on the current stream of ``device``; raise on a nonzero CUDA
    error; count the launch under ``kernel``."""
    if device.type != "cuda":
        raise ValueError(f"{kernel}: the CUDA kernel needs tensors on the card, got {device}")
    for v in ints:
        if not 0 <= v < 2**31:
            raise ValueError(f"{kernel}: launch size {v} outside the int32 range")
    fn = _fn(source or kernel, symbol, len(tensors), len(ints))
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(*[t.data_ptr() for t in tensors], *[int(v) for v in ints], stream)
    if rc != 0:
        raise RuntimeError(f"{kernel} kernel launch failed with CUDA error {rc}")
    LAUNCHES[kernel] += 1
