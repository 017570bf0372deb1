"""Dispatch for the grouped expert matmul (kernel K9).

``grouped_matmul(x, w, group_sizes=None)`` is the reference's
``moe_gmm/ops.py`` entry point: x (E, C, D) dispatched tokens, w (E, D, F)
stacked expert weights -> (E, C, F) in x's dtype, summed in float32, rows
``c >= group_sizes[e]`` set to 0 (``None``: every row is valid). Tensors on
the card launch a CUDA kernel of ``csrc/moe_gmm.cu``; tensors on the CPU
take the plain version in ``ref.py``. There is no other route: a CUDA
tensor never reaches the plain version, and a build or launch failure
raises. Where x or w needs a gradient, ``grouped_matmul`` goes through
``_GmmFunction``, whose backward is kernel K9b (``csrc/moe_gmm_bwd.cu``:
dx = dy . w^T and dw = x^T . dy per expert, each launched only where its
input needs it) on the card and ``ref.gmm_bwd_plain`` on the CPU.

On the card :func:`gmm_route` picks one of four hand-written kernels by
dtype, shape and alignment, and :func:`gmm_plan` its grid:

- ``wgmma`` (bfloat16, C > 64, D and F multiples of 8, x and w 16-byte
  aligned): TMA and wgmma, 128 x 256 output tiles, one persistent block an
  SM walking them in the order of :func:`persistent_tiles`; the prefill;
- ``wgmma_decode`` (the same, C <= 64): out^T = w^T . x^T on wgmma, a block
  per 128 columns of one expert's w, C padded to an N of 16, 32 or 64;
  decode steps;
- ``mma_sync`` (bfloat16 otherwise: D or F not a multiple of 8, or an
  unaligned base, which a TMA map cannot describe): the first port's
  mma.sync kernel, 128 x 128 tiles, any shape;
- ``cuda_core_f32`` (float32): fmaf on the CUDA cores, 64 x 64 tiles (tf32
  would miss the float32 gate).

The reference halves its Pallas blocks (128 rows, 128 columns, 512-deep
slabs) until they divide C, F and D; the CUDA kernels mask or zero-fill
their ragged edges instead, so any C, D and F are taken.

K9b's routes, picked by :func:`gmm_bwd_route` and planned by
:func:`gmm_bwd_plan` (both products take the same route):

- ``wgmma_overlap`` (bfloat16, D and F multiples of 8, x, w and dy 16-byte
  aligned): K9's persistent 128 x 256 design, every operand read as it
  lies (dx: dy and w both K-major; dw: x and dy both MN-major), with an
  overlapped epilogue: each tile's sums go through a swizzled shared
  buffer, in two halves of 128 columns, and TMA stores while the consumers
  start the next tile (``ref.epilogue_byte``/``ref.box_element`` model
  it); tiles are walked in the raster groups that :func:`raster_group`
  plans and the entry point takes (:func:`gmm_bwd_tiles`);
- ``wgmma`` (forced only, the same gates): the same pipeline with the
  epilogue from registers, the first design;
- ``cuda_core_bf16`` (bfloat16 otherwise) and ``cuda_core_f32`` (float32):
  one strided fmaf kernel, 64 x 64 tiles, float32 sums.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional, Tuple

import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch
from .ref import gmm_bwd_plain, gmm_plain

__all__ = [
    "BWD_ROUTES", "EPI_FILLS", "PIPE_STAGES", "RASTER_MIB", "ROUTES", "SMEM_LIMIT", "GmmPlan",
    "gmm_bwd_cuda", "gmm_bwd_plain", "gmm_bwd_plan", "gmm_bwd_route", "gmm_bwd_tiles", "gmm_cuda",
    "gmm_plain", "gmm_plan", "gmm_route", "grouped_matmul", "persistent_tiles", "pipe_smem",
    "raster_group", "route_of",
]

_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}
_MAX_GRID = 65535  # gridDim.y (column tiles of 64 at the least) and gridDim.z (experts)

# route -> (C entry point, output tile (rows, columns)); the tiles are the
# kernels' compile-time constants in csrc/moe_gmm.cu
ROUTES = {
    "wgmma": ("moe_gmm_bf16_wgmma", (128, 256)),
    "wgmma_decode": ("moe_gmm_bf16_wgmma_decode", (64, 128)),   # rows: C <= 64, padded
    "mma_sync": ("moe_gmm_bf16_mma", (128, 128)),
    "cuda_core_f32": ("moe_gmm_f32", (64, 64)),
}
DECODE_MAX_C = 64  # wgmma's N: the decode route's token rows


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def gmm_route(dtype: torch.dtype, C: int, D: int, F: int, aligned: bool) -> str:
    """The kernel that takes (E, C, D) x (E, D, F) in ``dtype`` on the card;
    ``aligned``: x and w start on 16-byte boundaries."""
    if dtype == torch.float32:
        return "cuda_core_f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"moe_gmm: dtype {dtype} not supported (bfloat16, float32)")
    # a TMA map needs 16-byte strides (D, F multiples of 8) and base
    if aligned and D > 0 and D % 8 == 0 and F % 8 == 0:
        return "wgmma_decode" if C <= DECODE_MAX_C else "wgmma"
    return "mma_sync"


@dataclass(frozen=True)
class GmmPlan:
    route: str
    symbol: str
    tiles: int                   # output tiles the kernel computes
    grid: Tuple[int, int, int]   # the launch's (x, y, z)
    group: int = 0               # K9b's wgmma_overlap: row tiles a raster group


def gmm_plan(route: str, E: int, C: int, F: int, n_sms: int) -> GmmPlan:
    """Tiles and grid of ``route`` for an (E, C, F) output on a card of
    ``n_sms`` SMs; the C entry point refuses any other grid."""
    symbol, (bm, bn) = ROUTES[route]
    if route == "wgmma_decode":
        if C > DECODE_MAX_C:
            raise ValueError(f"moe_gmm: the decode route takes C <= {DECODE_MAX_C}, got {C}")
        tiles = _cdiv(F, bn) * E
        return GmmPlan(route, symbol, tiles, (_cdiv(F, bn), E, 1))
    mt, nt = _cdiv(C, bm), _cdiv(F, bn)
    tiles = mt * nt * E
    if route == "wgmma":   # persistent: at most one block an SM
        return GmmPlan(route, symbol, tiles, (max(1, min(tiles, n_sms)), 1, 1))
    return GmmPlan(route, symbol, tiles, (mt, nt, E))


def persistent_tiles(block: int, n_blocks: int, E: int, C: int,
                     F: int) -> List[Tuple[int, int, int]]:
    """The (row tile, column tile, expert) of each output tile that block
    ``block`` of the ``wgmma`` route's persistent grid computes, in order:
    tile t = block, block + n_blocks, ..., row tiles fastest, then column
    tiles, then experts (the kernel's own loop)."""
    bm, bn = ROUTES["wgmma"][1]
    mt, nt = _cdiv(C, bm), _cdiv(F, bn)
    return [(t % mt, (t // mt) % nt, t // (mt * nt))
            for t in range(block, mt * nt * E, n_blocks)]


def _check(x: torch.Tensor, w: torch.Tensor, group_sizes: Optional[torch.Tensor]) -> tuple:
    """Raise unless x (E, C, D) and w (E, D, F) are of one dtype (bfloat16
    or float32), contiguous, on one device, with group_sizes an int32 (E,)
    tensor there or None; returns (E, C, D, F). Both routes take the same."""
    if x.dim() != 3 or w.dim() != 3:
        raise ValueError(f"moe_gmm: x and w must be 3-d, got {tuple(x.shape)} and "
                         f"{tuple(w.shape)}")
    E, C, D = x.shape
    F = w.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"moe_gmm: dtype {x.dtype} not supported (bfloat16, float32)")
    if E > _MAX_GRID or (F + 63) // 64 > _MAX_GRID:
        raise ValueError(f"moe_gmm: {E} experts or {F} columns past the grid's limits")
    check("x", x, x.dtype, (E, C, D), x.device)
    check("w", w, x.dtype, (E, D, F), x.device)
    if group_sizes is not None:
        check("group_sizes", group_sizes, torch.int32, (E,), x.device)
    return E, C, D, F


def route_of(x: torch.Tensor, w: torch.Tensor) -> str:
    """The route :func:`gmm_route` picks for these tensors on the card."""
    E, C, D = x.shape
    aligned = x.data_ptr() % 16 == 0 and w.data_ptr() % 16 == 0
    return gmm_route(x.dtype, C, D, w.shape[-1], aligned)


def gmm_cuda(x: torch.Tensor, w: torch.Tensor, group_sizes: Optional[torch.Tensor] = None,
             route: Optional[str] = None) -> torch.Tensor:
    """Launch K9 on the card (arguments as :func:`_check` takes them), by the
    route :func:`gmm_route` picks, or by ``route`` where the caller names one
    (the tests and the smoke's timings; a wgmma route raises on what TMA
    cannot describe)."""
    E, C, D, F = _check(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm: the CUDA kernel needs tensors on the card, got {x.device}")
    if route is None:
        route = route_of(x, w)
    elif route not in ROUTES:
        raise ValueError(f"moe_gmm: unknown route {route!r} (one of {sorted(ROUTES)})")
    want = "f32" if route == "cuda_core_f32" else "bf16"
    if _DTYPES[x.dtype] != want:
        raise TypeError(f"moe_gmm: route {route} takes {want}, got {x.dtype}")
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    plan = gmm_plan(route, E, C, F, n_sms)
    out = torch.empty((E, C, F), dtype=x.dtype, device=x.device)
    launch("moe_gmm", plan.symbol, x.device, (x, w, group_sizes, out), (E, C, D, F, *plan.grid),
           route=route)
    return out


# K9b: route -> (C entry point suffix, output tile (rows, columns)); the
# tiles are the kernels' compile-time constants in csrc/moe_gmm_bwd.cu
BWD_ROUTES = {
    "wgmma_overlap": ("bf16_wgmma_overlap", (128, 256)),
    "wgmma": ("bf16_wgmma", (128, 256)),
    "cuda_core_bf16": ("bf16_simt", (64, 64)),
    "cuda_core_f32": ("f32", (64, 64)),
}
_PERSISTENT = ("wgmma", "wgmma_overlap")

# The persistent pipeline (csrc/gmm_tiles.cuh): its stages, and the fills of
# the ``wgmma_overlap`` route's epilogue buffer a tile (two halves of 128
# columns; the ``wgmma`` route stores from registers, with no buffer)
PIPE_STAGES, EPI_FILLS = 4, 2
# the L2 that one raster group's A operand may fill on ``wgmma_overlap``: at
# mixtral's w_down shape dw's A (x of an expert, 84 MB) is past the 50 MB
# L2, and walking every row tile of a column tile read it again from device
# memory for every wave of blocks
RASTER_MIB = 24
SMEM_LIMIT = 232448   # dynamic shared memory a block may have on the H100


def raster_group(which: str, C: int, F: int) -> int:
    """Row tiles a raster group of the ``wgmma_overlap`` route's ``which``
    product (the plan's ``group``, which the kernel takes): as many as keep
    one group's A operand, 128 rows times the product's depth (dx: F; dw:
    C) in bf16, within :data:`RASTER_MIB` MiB."""
    tile_bytes = BWD_ROUTES["wgmma_overlap"][1][0] * (F if which == "dx" else C) * 2
    return max(1, (RASTER_MIB << 20) // tile_bytes)


def pipe_smem(route: str) -> int:
    """Dynamic shared memory of the persistent pipeline on ``route``
    (``wgmma`` or ``wgmma_overlap``): a 1024-byte alignment pad, the stages
    (a 128 x 64 and a 256 x 64 bf16 tile each), the overlap route's
    epilogue buffer (128 rows x 256 / EPI_FILLS columns of bf16), a full
    and an empty barrier a stage."""
    bm, bn = BWD_ROUTES[route][1]
    buf = bm * (bn // EPI_FILLS) * 2 if route == "wgmma_overlap" else 0
    return 1024 + PIPE_STAGES * (bm + bn) * 128 + buf + 16 * PIPE_STAGES


def gmm_bwd_route(dtype: torch.dtype, D: int, F: int, aligned: bool) -> str:
    """The K9b route of both backward products of an (E, C, D) x (E, D, F)
    product in ``dtype``; ``aligned``: x, w and dy start on 16-byte
    boundaries."""
    if dtype == torch.float32:
        return "cuda_core_f32"
    if dtype != torch.bfloat16:
        raise TypeError(f"moe_gmm_bwd: dtype {dtype} not supported (bfloat16, float32)")
    if aligned and D > 0 and F > 0 and D % 8 == 0 and F % 8 == 0:
        return "wgmma_overlap"
    return "cuda_core_bf16"


def gmm_bwd_plan(which: str, route: str, E: int, C: int, D: int, F: int,
                 n_sms: int) -> GmmPlan:
    """Tiles and grid of K9b's ``which`` product (``"dx"``: (E, C, D),
    ``"dw"``: (E, D, F)) on ``route``; the C entry point refuses any other
    grid; ``wgmma_overlap``'s plan carries its raster group."""
    suffix, (bm, bn) = BWD_ROUTES[route]
    M, N = (C, D) if which == "dx" else (D, F)
    mt, nt = _cdiv(M, bm), _cdiv(N, bn)
    tiles = mt * nt * E
    symbol = f"moe_gmm_bwd_{which}_{suffix}"
    if route in _PERSISTENT:   # at most one block an SM
        group = raster_group(which, C, F) if route == "wgmma_overlap" else 0
        return GmmPlan(route, symbol, tiles, (max(1, min(tiles, n_sms)), 1, 1), group)
    return GmmPlan(route, symbol, tiles, (mt, nt, E))


def gmm_bwd_tiles(which: str, block: int, n_blocks: int, E: int, C: int, D: int, F: int,
                  group: int = 0) -> List[Tuple[int, int, int]]:
    """The (row tile, column tile, expert) of each output tile of K9b's
    ``which`` product over dx's (C, D) or dw's (D, F) that block ``block``
    of a persistent route's grid of ``n_blocks`` computes, in order (the
    kernel's loop): tile t = block, block + n_blocks, ...; tiles run in
    raster groups of ``group`` row tiles (row tiles fastest, then column
    tiles), group after group, then experts. ``group`` 0 is the prefill's
    order (:func:`persistent_tiles`, the ``wgmma`` route's);
    ``wgmma_overlap`` takes its plan's ``group``."""
    M, N = (C, D) if which == "dx" else (D, F)
    bm, bn = BWD_ROUTES["wgmma_overlap"][1]
    mt, nt = _cdiv(M, bm), _cdiv(N, bn)
    g = group if 0 < group < mt else mt
    whole = mt // g
    out = []
    for t in range(block, mt * nt * E, n_blocks):
        e, r = divmod(t, mt * nt)
        if r < whole * g * nt:
            n, m = (r % (g * nt)) // g, r // (g * nt) * g + r % g
        else:   # the last group, of mt % g row tiles
            rem, rr = mt - whole * g, r - whole * g * nt
            n, m = rr // rem, whole * g + rr % rem
        out.append((m, n, e))
    return out


def gmm_bwd_cuda(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                 group_sizes: Optional[torch.Tensor] = None, need: Tuple[bool, bool] = (True, True),
                 route: Optional[str] = None) -> tuple:
    """Launch K9b on the card: (dx, dw) of ``grouped_matmul(x, w,
    group_sizes)`` for the cotangent dy (E, C, F), each None unless ``need``
    asks for it; by the route :func:`gmm_bwd_route` picks, or ``route``
    (``wgmma_overlap`` and ``wgmma`` raise on what TMA cannot describe)."""
    E, C, D, F = _check(x, w, group_sizes)
    if x.device.type != "cuda":
        raise ValueError(f"moe_gmm_bwd: the CUDA kernel needs tensors on the card, got {x.device}")
    check("dy", dy, x.dtype, (E, C, F), x.device)
    if (D + 63) // 64 > _MAX_GRID:
        raise ValueError(f"moe_gmm_bwd: {D} columns past the grid's limits")
    if route is None:
        aligned = all(t.data_ptr() % 16 == 0 for t in (x, w, dy))
        route = gmm_bwd_route(x.dtype, D, F, aligned)
    elif route not in BWD_ROUTES:
        raise ValueError(f"moe_gmm_bwd: unknown route {route!r} (one of {sorted(BWD_ROUTES)})")
    want = "f32" if route == "cuda_core_f32" else "bf16"
    if _DTYPES[x.dtype] != want:
        raise TypeError(f"moe_gmm_bwd: route {route} takes {want}, got {x.dtype}")
    n_sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    outs = []
    for which, shape, args in (("dx", (E, C, D), (dy, w)), ("dw", (E, D, F), (x, dy))):
        if not need[len(outs)]:
            outs.append(None)
            continue
        out = torch.empty(shape, dtype=x.dtype, device=x.device)
        if 0 in (E, C, D, F):   # an empty sum or an empty output: nothing to launch
            outs.append(out.zero_())
            continue
        plan = gmm_bwd_plan(which, route, E, C, D, F, n_sms)
        group = (plan.group,) if route == "wgmma_overlap" else ()
        launch("moe_gmm_bwd", plan.symbol, x.device, (*args, group_sizes, out),
               (E, C, D, F, *plan.grid, *group), route=f"{which}/{route}")
        outs.append(out)
    return tuple(outs)


def _forward(x: torch.Tensor, w: torch.Tensor, group_sizes: Optional[torch.Tensor]) -> torch.Tensor:
    if x.device.type == "cuda":
        return gmm_cuda(x, w, group_sizes)
    if x.device.type != "cpu":
        raise ValueError(f"moe_gmm: unsupported device {x.device}")
    _check(x, w, group_sizes)
    PLAIN_CALLS["moe_gmm"] += 1
    return gmm_plain(x, w, group_sizes)


class _GmmFunction(torch.autograd.Function):
    """K9 forward, K9b backward (their plain versions, counted, on the CPU);
    the backward computes only the gradients ``needs_input_grad`` asks for."""

    @staticmethod
    def forward(ctx, x, w, group_sizes):
        ctx.save_for_backward(x, w, group_sizes)
        return _forward(x, w, group_sizes)

    @staticmethod
    def backward(ctx, dy):
        x, w, group_sizes = ctx.saved_tensors
        need = tuple(ctx.needs_input_grad[:2])
        dy = dy.to(x.dtype).contiguous()
        if x.device.type == "cuda":
            dx, dw = gmm_bwd_cuda(x, w, dy, group_sizes, need)
        else:
            check("dy", dy, x.dtype, (x.shape[0], x.shape[1], w.shape[-1]), x.device)
            PLAIN_CALLS["moe_gmm_bwd"] += 1
            dx, dw = gmm_bwd_plain(x, w, dy, group_sizes, need)
        return dx, dw, None


def grouped_matmul(x: torch.Tensor, w: torch.Tensor,
                   group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, D), w (E, D, F) -> (E, C, F): K9 on the card, the plain
    version (counted) on the CPU. group_sizes may be any integer tensor; it
    is moved to x's device as int32. Where x or w needs a gradient the call
    goes through ``_GmmFunction`` (backward K9b, or its plain version on the
    CPU)."""
    if group_sizes is not None:
        group_sizes = group_sizes.to(device=x.device, dtype=torch.int32).contiguous()
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return _GmmFunction.apply(x, w, group_sizes)
    return _forward(x, w, group_sizes)
