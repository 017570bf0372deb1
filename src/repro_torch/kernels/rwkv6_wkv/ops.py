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
it divides S, before either device runs, so both cut the sequence alike.
The kernel takes K <= 64 and chunks <= 64 (every configuration in the
repo); larger ones are refused on both devices. Tensors on the CPU take
``ref.wkv_plain``. Tensors on the card launch ``csrc/rwkv6_wkv.cu`` by one
of two routes, which :func:`wkv_route` picks by shape:

- ``chunked`` (the cut chunk a multiple of 16 rows, the tensor cores'
  tile, and K a multiple of 4): three launches over (b, h, chunk): every chunk's state increment,
  a sequential pass over the chunks that leaves each chunk's starting state
  in a float32 workspace (B, H, S / chunk, K, K), and every chunk's y from
  its starting state, the model's bf16 intra-chunk products on the tensor
  cores (``ref.wkv_chunked`` emulates the three). Its final state is the
  serial route's bit for bit;
- ``serial`` (other chunks: 8 at S = 40, 1 at odd S; and S = 0): the first
  design, one block per (b, h) walking its chunks.

There is no other route: a CUDA tensor never reaches the plain version, and
a build or launch failure raises.

Gradients: where an input needs one, both entry points go through
``_WKVFunction``, K12 forward and its backward K12b
(``csrc/rwkv6_wkv_bwd.cu``, :func:`wkv_bwd_cuda`) on the card, the plain
backward ``ref.wkv_bwd_plain`` (autograd of ``wkv_plain``, as the
reference's backward is ``jax.vjp`` of its oracle) on the CPU. It returns
dr, dk, dv, dw and du; du is summed over the batch where u is shared (the
model's (H, K)) and stays per row where u is (BH, K). The backward
recomputes each chunk's starting state rather than keep the forward's
workspace as a residual (see the source). K12b has the forward's two
routes, picked by the same :func:`wkv_route`:

- ``chunked``: three launches over (b, h, chunk): both state increments
  (the forward's and the backward's), both state passes in one launch
  (each chunk's starting state forward, its end state's gradient
  backward, in two float32 workspaces (B, H, S / chunk, K, K)), and every
  chunk's gradients, the model's bf16 intra-chunk products on the tensor
  cores; du per chunk, summed over the chunks here (``ref.wkv_bwd_chunked``
  emulates the three);
- ``serial``: the first design, one block per (b, h), a forward walk and
  then the chunks backward (``ref.wkv_bwd_chunks``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch, n_sms
from .ref import wkv_bwd_plain, wkv_plain

__all__ = ["CHUNK_ROWS", "MAX_CHUNK", "MAX_K", "ROUTES", "cut_chunk", "wkv_bwd", "wkv_bwd_cuda",
           "wkv_bwd_plain", "wkv_cuda", "wkv_fwd", "wkv_heads", "wkv_plain", "wkv_route",
           "wkv_scan", "wkv_split"]

MAX_K = 64       # head width the kernel holds: a (K, K) float32 state in 256 threads' registers
MAX_CHUNK = 64   # chunk rows the kernel holds in shared memory
CHUNK_ROWS = 16  # the chunked route's row tile (mma.sync's 16 rows)
ROUTES = ("chunked", "serial")
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def wkv_route(S: int, chunk: int, K: int) -> str:
    """The route of a cut ``chunk`` of an S-row sequence of head width K:
    ``chunked`` where S > 0, the chunk is a multiple of ``CHUNK_ROWS`` and K
    a multiple of 4 (the state moves as float4), else ``serial``."""
    return "chunked" if S > 0 and chunk % CHUNK_ROWS == 0 and K % 4 == 0 else "serial"


def wkv_split(blocks: int, K: int, n_sms: int) -> int:
    """The chunked route's split of the value columns in its output step
    (tensor-core form): 1, 2 or 4, doubled while the (b, h, chunk) grid of
    ``blocks`` gives fewer than four blocks an SM and K has an 8-column
    tile for each share."""
    split = 1
    while split < 4 and blocks * split < 4 * n_sms and 2 * split <= (K + 7) // 8:
        split *= 2
    return split


def _vec(t: torch.Tensor, H: int, K: int) -> bool:
    """Whether rows of K elements H * K apart from t's base can be read in
    16-byte loads."""
    n = t.element_size()
    return K * n % 16 == 0 and H * K * n % 16 == 0 and t.data_ptr() % 16 == 0


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
    return B, S, H, K


def wkv_cuda(r, k, v, w, u, chunk: int, bf16_intra: bool,
             route: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K12 on the card; the arguments of ``ref.wkv_plain``, with
    ``chunk`` already cut to divide S, by the route :func:`wkv_route` picks
    or the one named (the tests and the smoke's timings)."""
    B, S, H, K = _check(r, k, v, w, u, chunk)
    if route is None:
        route = wkv_route(S, chunk, K)
    elif route not in ROUTES:
        raise ValueError(f"rwkv6_wkv: unknown route {route!r} (one of {ROUTES})")
    y = torch.empty_like(r)
    state = torch.empty((B, H, K, K), dtype=torch.float32, device=r.device)
    fn = f"{_DTYPES[r.dtype]}_{_DTYPES[w.dtype]}_{'bf16' if bf16_intra else 'f32'}"
    u_per_row = int(u.shape[0] == B and B > 1)
    if route == "serial":
        launch("rwkv6_wkv", f"rwkv6_wkv_{fn}", r.device, (r, k, v, w, u, y, state),
               (B, S, H, K, chunk, u_per_row), route=route)
        return y, state
    if wkv_route(S, chunk, K) != "chunked":
        raise ValueError(f"rwkv6_wkv: the chunked route takes S > 0, chunks of a multiple of "
                         f"{CHUNK_ROWS} rows and K a multiple of 4, got S = {S}, chunk {chunk}, "
                         f"K = {K}")
    nc = S // chunk
    # the workspace lives on the launching stream: the allocator hands it out
    # again only to work queued after these launches
    ws = torch.empty((B, H, nc, K, K), dtype=torch.float32, device=r.device)
    decay = torch.empty((B, H, nc, K), dtype=torch.float32, device=r.device)
    split = wkv_split(B * H * nc, K, n_sms(r.device)) if bf16_intra else 1
    vec = int(all(_vec(t, H, K) for t in (r, k, v))) | 2 * int(_vec(w, H, K))
    launch("rwkv6_wkv", f"rwkv6_wkv_chunked_{fn}", r.device,
           (r, k, v, w, u, y, state, ws, decay),
           (B, S, H, K, chunk, u_per_row, split, vec), route=route)
    return y, state


def wkv_bwd_cuda(r, k, v, w, u, dy, dstate: Optional[torch.Tensor], chunk: int,
                 bf16_intra: bool, route: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """Launch K12b on the card: the arguments of ``ref.wkv_bwd_plain``,
    with ``chunk`` already cut to divide S, ``dy`` (B, S, H, K) in r's dtype
    and ``dstate`` (B, H, K, K) float32 or None -> (dr, dk, dv, dw, du), by
    the route :func:`wkv_route` picks or the one named (the tests and the
    smoke's timings)."""
    B, S, H, K = _check(r, k, v, w, u, chunk)
    check("dy", dy, r.dtype, (B, S, H, K), r.device)
    if dstate is not None:
        check("dstate", dstate, torch.float32, (B, H, K, K), r.device)
    if route is None:
        route = wkv_route(S, chunk, K)
    elif route not in ROUTES:
        raise ValueError(f"rwkv6_wkv: unknown route {route!r} (one of {ROUTES})")
    if route == "chunked" and wkv_route(S, chunk, K) != "chunked":
        raise ValueError(f"rwkv6_wkv: the chunked route takes S > 0, chunks of a multiple of "
                         f"{CHUNK_ROWS} rows and K a multiple of 4, got S = {S}, chunk {chunk}, "
                         f"K = {K}")
    grads = [torch.empty_like(t) for t in (r, k, v, w)]
    nc = S // chunk if S else 0
    fn = f"{_DTYPES[r.dtype]}_{_DTYPES[w.dtype]}_{'bf16' if bf16_intra else 'f32'}"
    u_per_row = int(u.shape[0] == B and B > 1)
    # the workspaces live on the launching stream: the allocator hands them
    # out again only to work queued after these launches
    if route == "serial":
        du_rows = torch.empty((B, H, K), dtype=torch.float32, device=r.device)
        # every chunk's starting state, recomputed by the kernel's forward walk
        ws = torch.empty((B, H, nc, K, K), dtype=torch.float32, device=r.device)
        launch("rwkv6_wkv_bwd", f"rwkv6_wkv_bwd_{fn}", r.device,
               (r, k, v, w, u, dy, dstate, *grads, du_rows, ws), (B, S, H, K, chunk, u_per_row),
               route=route)
    else:
        # each chunk's starting state and its end state's gradient, from
        # their increments; du per chunk, summed over the chunks here
        wsf, wsb = (torch.empty((B, H, nc, K, K), dtype=torch.float32, device=r.device)
                    for _ in range(2))
        decay = torch.empty((B, H, nc, K), dtype=torch.float32, device=r.device)
        du_parts = torch.empty((B, H, nc, K), dtype=torch.float32, device=r.device)
        vec = int(all(_vec(t, H, K) for t in (r, k, v, dy))) | 2 * int(_vec(w, H, K))
        launch("rwkv6_wkv_bwd", f"rwkv6_wkv_bwd_chunked_{fn}", r.device,
               (r, k, v, w, u, dy, dstate, *grads, du_parts, wsf, wsb, decay),
               (B, S, H, K, chunk, u_per_row, vec), route=route)
        du_rows = du_parts.sum(2)
    du = du_rows if u.shape[0] == B and B > 1 else du_rows.sum(0, keepdim=True)
    return (*grads, du)


def wkv_bwd(r, k, v, w, u, dy, dstate: Optional[torch.Tensor], chunk: int,
            bf16_intra: bool) -> Tuple[torch.Tensor, ...]:
    """K12b on the card, its plain version on the CPU; ``chunk`` already
    cut."""
    dy = dy.contiguous()
    if dstate is not None:
        dstate = dstate.float().contiguous()
    if r.device.type == "cuda":
        return wkv_bwd_cuda(r, k, v, w, u, dy, dstate, chunk, bf16_intra)
    if r.device.type != "cpu":
        raise ValueError(f"rwkv6_wkv: unsupported device {r.device}")
    PLAIN_CALLS["rwkv6_wkv_bwd"] += 1
    return wkv_bwd_plain(r, k, v, w, u, dy, dstate, chunk, bf16_intra)


def _wkv_forward(r, k, v, w, u, chunk: int, bf16_intra: bool
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    if r.device.type == "cuda":
        return wkv_cuda(r, k, v, w, u, chunk, bf16_intra)
    if r.device.type != "cpu":
        raise ValueError(f"rwkv6_wkv: unsupported device {r.device}")
    _check(r, k, v, w, u, chunk)
    PLAIN_CALLS["rwkv6_wkv"] += 1
    return wkv_plain(r, k, v, w, u, chunk, bf16_intra)


class _WKVFunction(torch.autograd.Function):
    """K12 forward, K12b backward (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, chunk: int, bf16_intra: bool):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(r, k, v, w, u)
        ctx.chunk, ctx.bf16_intra = chunk, bf16_intra
        return _wkv_forward(r, k, v, w, u, chunk, bf16_intra)

    @staticmethod
    def backward(ctx, dy, dstate):
        r, k, v, w, u = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        return (*wkv_bwd(r, k, v, w, u, dy, dstate, ctx.chunk, ctx.bf16_intra), None, None)


def _wkv(r, k, v, w, u, chunk: int, bf16_intra: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout, u (1 or B, H, K); the chunk is cut here for both routes."""
    chunk = cut_chunk(chunk, r.shape[1])
    u = u.float().contiguous()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (r, k, v, w, u)):
        return _WKVFunction.apply(r, k, v, w, u, chunk, bf16_intra)
    return _wkv_forward(r, k, v, w, u, chunk, bf16_intra)


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
    ``wkv_scan``, differentiable through K12b."""
    return wkv_fwd(r, k, v, w, u, chunk=chunk)[0]


def wkv_heads(r, k, v, w, u, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, w (B, S, H, K), u (H, K) -> (y (B, S, H, K) in r's dtype,
    final state (B, H, K, K) float32): the reference model's
    ``_wkv_chunked``, bfloat16 operands in the intra-chunk products."""
    if u.dim() != 2:
        raise ValueError(f"rwkv6_wkv: u must be (H, K), got {tuple(u.shape)}")
    return _wkv(r, k, v, w, u[None], chunk, True)
