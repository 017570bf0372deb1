"""Dispatch for the RWKV6 chunked WKV scan (kernel K12).

Two entry points, one kernel:

- ``wkv_scan(r, k, v, w, u, *, chunk)`` keeps the reference's
  ``rwkv6_wkv/ops.py`` signature: r, k, v, w (BH, S, K), u (BH, K) -> y
  (BH, S, K) in r's dtype; ``wkv_fwd`` returns (y, final state (BH, K, K)
  float32) as ``wkv_fwd_pallas`` does. Every product is float32.
- ``wkv_heads(r, k, v, w, u, *, chunk)`` takes the model's layout, r, k,
  v, w (B, S, H, K) with u (H, K), and computes the reference model's
  ``_wkv_chunked``, whose two intra-chunk products take bfloat16 operands
  (``ref.py``); it returns (y (B, S, H, K), final state (B, H, K, K)). It
  saves the four transposes into the kernel layout, each 67-134 MB at the
  rwkv6-7b prefill.

The chunk is cut as the reference cuts it, ``min(chunk, S)`` halved until
it divides S, before either route runs, so both cut the sequence alike.
The kernel takes K <= 64 and chunks <= 64 (every configuration in the
repo); larger ones are refused on both routes. Tensors on the card launch
``csrc/rwkv6_wkv.cu``; tensors on the CPU take ``ref.wkv_plain``. There is
no other route: a CUDA tensor never reaches the plain version, and a build
or launch failure raises. K12 has no backward yet (it comes with training
of the SSM family, ROADMAP.md item 10(c)), so inputs that need a gradient
are refused rather than given none.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch
from .ref import wkv_plain

__all__ = ["MAX_CHUNK", "MAX_K", "cut_chunk", "wkv_cuda", "wkv_fwd", "wkv_heads", "wkv_plain",
           "wkv_scan"]

MAX_K = 64       # head width the kernel holds: a (K, K) float32 state in 256 threads' registers
MAX_CHUNK = 64   # chunk rows the kernel holds in shared memory
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def cut_chunk(chunk: int, S: int) -> int:
    """The reference's chunk: ``min(chunk, S)``, halved until it divides S."""
    if chunk <= 0:
        raise ValueError(f"rwkv6_wkv: chunk {chunk} must be positive")
    chunk = min(chunk, S)
    while chunk > 1 and S % chunk:
        chunk //= 2
    return max(chunk, 1)


def _check(r, k, v, w, u, chunk: int) -> Tuple[int, int, int, int]:
    """Raise unless r, k, v (B, S, H, K) share a dtype (bfloat16 or
    float32), w (B, S, H, K) is bfloat16 or float32, u (B or 1, H, K) is
    float32, all contiguous on one device, K <= 64 and the cut ``chunk`` is
    <= 64; returns (B, S, H, K). Both routes take the same."""
    if r.dim() != 4:
        raise ValueError(f"rwkv6_wkv: r must be (B, S, H, K), got {tuple(r.shape)}")
    B, S, H, K = r.shape
    if r.dtype not in _DTYPES or w.dtype not in _DTYPES:
        raise TypeError(f"rwkv6_wkv: dtypes {r.dtype}, {w.dtype} not supported "
                        f"(bfloat16, float32)")
    if K > MAX_K:
        raise ValueError(f"rwkv6_wkv: head width K = {K} > {MAX_K}, the kernel's limit")
    if chunk > MAX_CHUNK:
        raise ValueError(f"rwkv6_wkv: chunk {chunk} > {MAX_CHUNK}, the kernel's limit")
    for name, t in (("r", r), ("k", k), ("v", v)):
        check(name, t, r.dtype, (B, S, H, K), r.device)
    check("w", w, w.dtype, (B, S, H, K), r.device)
    if u.dim() != 3 or u.shape[0] not in (1, B):
        raise ValueError(f"rwkv6_wkv: u must be (1 or B, H, K), got {tuple(u.shape)}")
    check("u", u, torch.float32, (-1, H, K), r.device)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u)):
        raise NotImplementedError(
            "rwkv6_wkv: K12 has no backward yet (ROADMAP.md item 10(c), training the SSM "
            "family); call it under torch.no_grad()")
    return B, S, H, K


def wkv_cuda(r, k, v, w, u, chunk: int, bf16_intra: bool
             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K12 on the card; the arguments of ``ref.wkv_plain``, with
    ``chunk`` already cut to divide S."""
    B, S, H, K = _check(r, k, v, w, u, chunk)
    y = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    symbol = f"rwkv6_wkv_{_DTYPES[r.dtype]}_{_DTYPES[w.dtype]}_{'bf16' if bf16_intra else 'f32'}"
    launch("rwkv6_wkv", symbol, r.device, (r, k, v, w, u, y, state),
           (B, S, H, K, chunk, int(u.shape[0] == B and B > 1)))
    return y, state


def _wkv(r, k, v, w, u, chunk: int, bf16_intra: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout, u (1 or B, H, K); the chunk is cut here for both routes."""
    chunk = cut_chunk(chunk, r.shape[1])
    u = u.float().contiguous()
    if r.device.type == "cuda":
        return wkv_cuda(r, k, v, w, u, chunk, bf16_intra)
    if r.device.type != "cpu":
        raise ValueError(f"rwkv6_wkv: unsupported device {r.device}")
    _check(r, k, v, w, u, chunk)
    PLAIN_CALLS["rwkv6_wkv"] += 1
    return wkv_plain(r, k, v, w, u, chunk, bf16_intra)


def wkv_fwd(r, k, v, w, u, *, chunk: int = 32) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (BH, S, K), u (BH, K) -> (y (BH, S, K) in r's dtype, final
    state (BH, K, K) float32), every product in float32: the function of
    ``wkv_fwd_pallas``."""
    if r.dim() != 3 or u.dim() != 2:
        raise ValueError(f"rwkv6_wkv: r must be (BH, S, K) and u (BH, K), got "
                         f"{tuple(r.shape)} and {tuple(u.shape)}")
    y, state = _wkv(*(t[:, :, None] for t in (r, k, v, w)), u[:, None], chunk, False)
    return y[:, :, 0], state[:, 0]


def wkv_scan(r, k, v, w, u, *, chunk: int = 32) -> torch.Tensor:
    """r, k, v, w (BH, S, K), u (BH, K) -> y (BH, S, K): the reference's
    ``wkv_scan`` (forward only)."""
    return wkv_fwd(r, k, v, w, u, chunk=chunk)[0]


def wkv_heads(r, k, v, w, u, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, K), u (H, K) -> (y (B, S, H, K) in r's dtype,
    final state (B, H, K, K) float32): the reference model's
    ``_wkv_chunked``, bfloat16 operands in the intra-chunk products."""
    if u.dim() != 2:
        raise ValueError(f"rwkv6_wkv: u must be (H, K), got {tuple(u.shape)}")
    return _wkv(r, k, v, w, u[None], chunk, True)
