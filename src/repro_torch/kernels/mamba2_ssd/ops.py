"""Dispatch for the Mamba2 SSD chunk scan (kernel K8).

Two entry points, one kernel:

- ``ssd_scan(x, B, C, a, *, chunk)`` keeps the reference's
  ``mamba2_ssd/ops.py`` signature: x (BH, S, P), B and C (BH, S, N), a
  (BH, S) -> y (BH, S, P) in x's dtype; ``ssd_fwd`` returns (y, final state
  (BH, P, N) float32) as ``ssd_fwd_pallas`` does. Every product is float32.
- ``ssd_heads(x, B, C, a, *, chunk)`` takes the model's layout, x (Bt, S,
  H, P), B and C (Bt, S, H, N), a (Bt, S, H), and computes the reference
  model's ``_ssd_chunked`` with its roundings to x's dtype (``ref.py``); it
  returns (y (Bt, S, H, P), final state (Bt, H, P, N)). B and C may be
  views into a wider row (the model splits them from one projection): the
  kernel reads every tensor through its row stride, so nothing is copied or
  transposed (x, B and C are 84 MB each at the zamba2-2.7b prefill).

The chunk is cut as the reference cuts it, ``min(chunk, S)`` halved until
it divides S, before either device runs. The kernel takes P, N <= 64 and
chunks <= 128 (every configuration in the repo); larger ones are refused
on both devices. Tensors on the CPU take ``ref.ssd_plain``. Tensors on the
card launch ``csrc/mamba2_ssd.cu`` by one of two routes, which
:func:`ssd_route` picks by shape:

- ``chunked`` (the cut chunk a multiple of 16 rows, the tensor cores'
  tile, and P N a multiple of 4): three launches over (b, h, chunk): every chunk's state increment,
  a sequential pass over the chunks that leaves each chunk's starting state
  in a float32 workspace (Bt, H, S / chunk, P, N), and every chunk's y from
  its starting state, the model's bf16 intra-chunk products on the tensor
  cores (``ref.ssd_chunked`` emulates the three). Its final state is the
  serial route's bit for bit;
- ``serial`` (other chunks: c = 100 at S = 100, c = 1 at odd S; and S =
  0): the first design, one block per (b, h) walking its chunks.

There is no other route: a CUDA tensor never reaches the plain version, and
a build or launch failure raises.

Gradients: where an input needs one, both entry points go through
``_SSDFunction``, K8 forward and its backward K8b
(``csrc/mamba2_ssd_bwd.cu``, :func:`ssd_bwd_cuda`) on the card, the plain
backward ``ref.ssd_bwd_plain`` (autograd of ``ssd_plain``, as the
reference's backward is ``jax.vjp`` of its oracle) on the CPU. It returns
dx, dB, dC and da, contiguous; where B and C are views of one projection,
autograd adds dB and dC into that projection's gradient at their columns.
K8b has the forward's two routes, picked by the same :func:`ssd_route`:

- ``chunked``: three launches over (b, h, chunk): both state increments
  (the forward's and the backward's), both state passes in one launch
  (each chunk's starting state forward, its end state's gradient
  backward, in two float32 workspaces (Bt, H, S / chunk, P, N)), and every
  chunk's gradients, the model's bf16 intra-chunk products on the tensor
  cores (``ref.ssd_bwd_chunked`` emulates the three);
- ``serial``: the first design, one block per (b, h), a forward walk and
  then the chunks backward (``ref.ssd_bwd_chunks``).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from ..counts import PLAIN_CALLS
from ..launch import check, launch, n_sms
from .ref import ssd_bwd_plain, ssd_plain

__all__ = ["CHUNK_ROWS", "MAX_CHUNK", "MAX_PN", "ROUTES", "cut_chunk", "ssd_bwd", "ssd_bwd_cuda",
           "ssd_bwd_plain", "ssd_cuda", "ssd_fwd", "ssd_heads", "ssd_plain", "ssd_route",
           "ssd_scan", "ssd_split"]

MAX_PN = 64      # head width P and state width N the kernel holds
MAX_CHUNK = 128  # chunk rows the kernel holds in shared memory
CHUNK_ROWS = 16  # the chunked route's row tile (mma.sync's 16 rows)
ROUTES = ("chunked", "serial")
_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16"}


def ssd_route(S: int, chunk: int, P: int, N: int) -> str:
    """The route of a cut ``chunk`` of an S-row sequence of (P, N) states:
    ``chunked`` where S > 0, the chunk is a multiple of ``CHUNK_ROWS`` and
    P N a multiple of 4 (the state pass moves four floats a thread), else
    ``serial``."""
    return "chunked" if S > 0 and chunk % CHUNK_ROWS == 0 and P * N % 4 == 0 else "serial"


def ssd_split(blocks: int, P: int, n_sms: int) -> int:
    """The chunked route's split of P's columns in its output step (tensor
    core form): 1, 2 or 4, doubled while the (b, h, chunk) grid of
    ``blocks`` gives fewer than two blocks an SM and P has an 8-column tile
    for each share."""
    split = 1
    while split < 4 and blocks * split < 2 * n_sms and 2 * split <= (P + 7) // 8:
        split *= 2
    return split


def _vec(*rows) -> int:
    """1 where every (tensor, row stride, width) in ``rows`` can be read in
    16-byte loads: width, row stride and base multiples of 16 bytes."""
    return int(all(w * t.element_size() % 16 == 0 and ld * t.element_size() % 16 == 0
                   and t.data_ptr() % 16 == 0 for t, ld, w in rows))


def cut_chunk(chunk: int, S: int) -> int:
    """The reference's chunk: ``min(chunk, S)``, halved until it divides S."""
    if chunk <= 0:
        raise ValueError(f"mamba2_ssd: chunk {chunk} must be positive")
    chunk = min(chunk, S)
    while chunk > 1 and S % chunk:
        chunk //= 2
    return max(chunk, 1)


def _row_stride(name: str, t: torch.Tensor, shape: Tuple[int, ...], dtype: torch.dtype,
                device: torch.device) -> int:
    """Raise unless ``t`` is a ``dtype`` tensor of ``shape`` (Bt, S, H, W) on
    ``device`` whose (H, W) rows are contiguous and whose batches are S rows
    apart; returns the row stride in elements."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name} must be a tensor, got {type(t).__name__}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
    Bt, S, H, W = shape
    st = t.stride()
    rows_ok = (W == 1 or st[3] == 1) and (H == 1 or st[2] == W)
    if not rows_ok or st[1] < H * W or (Bt > 1 and st[0] != S * st[1]):
        raise ValueError(f"{name} must have contiguous (H, W) rows, S rows a batch apart "
                         f"(strides {st})")
    return st[1]


def _check(x, Bm, Cm, a, chunk: int) -> Tuple[int, int, int, int, int, Tuple[int, int, int]]:
    """Raise unless x (Bt, S, H, P) and B, C (Bt, S, H, N) share a dtype
    (bfloat16 or float32), a (Bt, S, H) is contiguous float32, all on one
    device, P, N <= 64 and ``chunk`` <= 128; returns (Bt, S, H,
    P, N, row strides of x, B, C). Both routes take the same."""
    if x.dim() != 4 or Bm.dim() != 4:
        raise ValueError(f"mamba2_ssd: x must be (Bt, S, H, P) and B (Bt, S, H, N), got "
                         f"{tuple(x.shape)} and {tuple(Bm.shape)}")
    Bt, S, H, P = x.shape
    N = Bm.shape[-1]
    if x.dtype not in _DTYPES:
        raise TypeError(f"mamba2_ssd: dtype {x.dtype} not supported (bfloat16, float32)")
    if P > MAX_PN or N > MAX_PN:
        raise ValueError(f"mamba2_ssd: P = {P}, N = {N}; the kernel's limit is {MAX_PN}")
    if chunk > MAX_CHUNK:
        raise ValueError(f"mamba2_ssd: chunk {chunk} > {MAX_CHUNK}, the kernel's limit")
    dev = x.device
    strides = (_row_stride("x", x, (Bt, S, H, P), x.dtype, dev),
               _row_stride("B", Bm, (Bt, S, H, N), x.dtype, dev),
               _row_stride("C", Cm, (Bt, S, H, N), x.dtype, dev))
    check("a", a, torch.float32, (Bt, S, H), dev)
    return Bt, S, H, P, N, strides


def ssd_cuda(x, Bm, Cm, a, chunk: int, model: bool,
             route: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """Launch K8 on the card; the arguments of ``ref.ssd_plain``, with
    ``chunk`` already cut to divide S and ``a`` float32, by the route
    :func:`ssd_route` picks or the one named (the tests and the smoke's
    timings)."""
    Bt, S, H, P, N, (ldx, ldb, ldc) = _check(x, Bm, Cm, a, chunk)
    if route is None:
        route = ssd_route(S, chunk, P, N)
    elif route not in ROUTES:
        raise ValueError(f"mamba2_ssd: unknown route {route!r} (one of {ROUTES})")
    y = torch.empty((Bt, S, H, P), dtype=x.dtype, device=x.device)
    state = torch.empty((Bt, H, P, N), dtype=torch.float32, device=x.device)
    fn = f"{_DTYPES[x.dtype]}_{'model' if model else 'f32'}"
    if route == "serial":
        launch("mamba2_ssd", f"mamba2_ssd_{fn}", x.device, (x, Bm, Cm, a, y, state),
               (Bt, S, H, P, N, chunk, ldx, ldb, ldc), route=route)
        return y, state
    if ssd_route(S, chunk, P, N) != "chunked":
        raise ValueError(f"mamba2_ssd: the chunked route takes S > 0, chunks of a multiple of "
                         f"{CHUNK_ROWS} rows and P N a multiple of 4, got S = {S}, chunk "
                         f"{chunk}, P = {P}, N = {N}")
    nc = S // chunk
    # the workspace lives on the launching stream: the allocator hands it out
    # again only to work queued after these launches
    ws = torch.empty((Bt, H, nc, P, N), dtype=torch.float32, device=x.device)
    decay = torch.empty((Bt, H, nc), dtype=torch.float32, device=x.device)
    mma = model and x.dtype == torch.bfloat16
    split = ssd_split(Bt * H * nc, P, n_sms(x.device)) if mma else 1
    vec = _vec((x, ldx, P), (Bm, ldb, N), (Cm, ldc, N))
    launch("mamba2_ssd", f"mamba2_ssd_chunked_{fn}", x.device,
           (x, Bm, Cm, a, y, state, ws, decay),
           (Bt, S, H, P, N, chunk, ldx, ldb, ldc, split, vec), route=route)
    return y, state


def ssd_bwd_cuda(x, Bm, Cm, a, dy, dstate: Optional[torch.Tensor], chunk: int,
                 model: bool, route: Optional[str] = None) -> Tuple[torch.Tensor, ...]:
    """Launch K8b on the card: the arguments of ``ref.ssd_bwd_plain``, with
    ``chunk`` already cut to divide S, ``dy`` (Bt, S, H, P) contiguous in
    x's dtype and ``dstate`` (Bt, H, P, N) float32 or None -> (dx, dB, dC,
    da), contiguous, by the route :func:`ssd_route` picks or the one named
    (the tests and the smoke's timings)."""
    Bt, S, H, P, N, (ldx, ldb, ldc) = _check(x, Bm, Cm, a, chunk)
    check("dy", dy, x.dtype, (Bt, S, H, P), x.device)
    if dstate is not None:
        check("dstate", dstate, torch.float32, (Bt, H, P, N), x.device)
    if route is None:
        route = ssd_route(S, chunk, P, N)
    elif route not in ROUTES:
        raise ValueError(f"mamba2_ssd: unknown route {route!r} (one of {ROUTES})")
    if route == "chunked" and ssd_route(S, chunk, P, N) != "chunked":
        raise ValueError(f"mamba2_ssd: the chunked route takes S > 0, chunks of a multiple of "
                         f"{CHUNK_ROWS} rows and P N a multiple of 4, got S = {S}, chunk "
                         f"{chunk}, P = {P}, N = {N}")
    dx = torch.empty((Bt, S, H, P), dtype=x.dtype, device=x.device)
    dB = torch.empty((Bt, S, H, N), dtype=x.dtype, device=x.device)
    dC = torch.empty_like(dB)
    da = torch.empty_like(a)
    nc = S // chunk if S else 0
    fn = f"{_DTYPES[x.dtype]}_{'model' if model else 'f32'}"
    # the workspaces live on the launching stream: the allocator hands them
    # out again only to work queued after these launches
    if route == "serial":
        # every chunk's starting state, recomputed by the kernel's forward walk
        ws = torch.empty((Bt, H, nc, P, N), dtype=torch.float32, device=x.device)
        launch("mamba2_ssd_bwd", f"mamba2_ssd_bwd_{fn}", x.device,
               (x, Bm, Cm, a, dy, dstate, dx, dB, dC, da, ws),
               (Bt, S, H, P, N, chunk, ldx, ldb, ldc), route=route)
        return dx, dB, dC, da
    # each chunk's starting state and its end state's gradient, from their
    # increments
    wsf, wsb = (torch.empty((Bt, H, nc, P, N), dtype=torch.float32, device=x.device)
                for _ in range(2))
    decay = torch.empty((Bt, H, nc), dtype=torch.float32, device=x.device)
    vec = _vec((x, ldx, P), (Bm, ldb, N), (Cm, ldc, N), (dy, H * P, P))
    launch("mamba2_ssd_bwd", f"mamba2_ssd_bwd_chunked_{fn}", x.device,
           (x, Bm, Cm, a, dy, dstate, dx, dB, dC, da, wsf, wsb, decay),
           (Bt, S, H, P, N, chunk, ldx, ldb, ldc, vec), route=route)
    return dx, dB, dC, da


def ssd_bwd(x, Bm, Cm, a, dy, dstate: Optional[torch.Tensor], chunk: int,
            model: bool) -> Tuple[torch.Tensor, ...]:
    """K8b on the card, its plain version on the CPU; ``chunk`` already
    cut."""
    dy = dy.contiguous()
    if dstate is not None:
        dstate = dstate.float().contiguous()
    if x.device.type == "cuda":
        return ssd_bwd_cuda(x, Bm, Cm, a, dy, dstate, chunk, model)
    if x.device.type != "cpu":
        raise ValueError(f"mamba2_ssd: unsupported device {x.device}")
    PLAIN_CALLS["mamba2_ssd_bwd"] += 1
    return ssd_bwd_plain(x, Bm, Cm, a, dy, dstate, chunk, model)


def _ssd_forward(x, Bm, Cm, a, chunk: int, model: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    if x.device.type == "cuda":
        return ssd_cuda(x, Bm, Cm, a, chunk, model)
    if x.device.type != "cpu":
        raise ValueError(f"mamba2_ssd: unsupported device {x.device}")
    _check(x, Bm, Cm, a, chunk)
    PLAIN_CALLS["mamba2_ssd"] += 1
    return ssd_plain(x, Bm, Cm, a, chunk, model)


class _SSDFunction(torch.autograd.Function):
    """K8 forward, K8b backward (their plain versions on the CPU)."""

    @staticmethod
    def forward(ctx, x, Bm, Cm, a, chunk: int, model: bool):
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(x, Bm, Cm, a)
        ctx.chunk, ctx.model = chunk, model
        return _ssd_forward(x, Bm, Cm, a, chunk, model)

    @staticmethod
    def backward(ctx, dy, dstate):
        x, Bm, Cm, a = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros(x.shape, dtype=x.dtype, device=x.device)
        return (*ssd_bwd(x, Bm, Cm, a, dy, dstate, ctx.chunk, ctx.model), None, None)


def _ssd(x, Bm, Cm, a, chunk: int, model: bool) -> Tuple[torch.Tensor, torch.Tensor]:
    """Model layout; the chunk is cut, and a bfloat16 ``a`` cast to float32
    as ``ssd_fwd_pallas`` casts it, here for both routes."""
    chunk = cut_chunk(chunk, x.shape[1])
    if a.dtype == torch.bfloat16:
        a = a.float()
    if torch.is_grad_enabled() and any(t.requires_grad for t in (x, Bm, Cm, a)):
        return _SSDFunction.apply(x, Bm, Cm, a, chunk, model)
    return _ssd_forward(x, Bm, Cm, a, chunk, model)


def ssd_fwd(x, Bm, Cm, a, *, chunk: int = 64) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (BH, S, P), B/C (BH, S, N), a (BH, S) -> (y (BH, S, P) in x's
    dtype, final state (BH, P, N) float32), every product in float32: the
    function of ``ssd_fwd_pallas``."""
    if x.dim() != 3 or a.dim() != 2:
        raise ValueError(f"mamba2_ssd: x must be (BH, S, P) and a (BH, S), got "
                         f"{tuple(x.shape)} and {tuple(a.shape)}")
    y, state = _ssd(x[:, :, None], Bm[:, :, None], Cm[:, :, None], a[:, :, None], chunk, False)
    return y[:, :, 0], state[:, 0]


def ssd_scan(x, Bm, Cm, a, *, chunk: int = 64) -> torch.Tensor:
    """x (BH, S, P), B/C (BH, S, N), a (BH, S) -> y (BH, S, P): the
    reference's ``ssd_scan``, differentiable through K8b."""
    return ssd_fwd(x, Bm, Cm, a, chunk=chunk)[0]


def ssd_heads(x, Bm, Cm, a, *, chunk: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (Bt, S, H, P), B/C (Bt, S, H, N), a (Bt, S, H) -> (y (Bt, S, H, P)
    in x's dtype, final state (Bt, H, P, N) float32): the reference model's
    ``_ssd_chunked``, with its roundings to x's dtype."""
    return _ssd(x, Bm, Cm, a, chunk, True)
