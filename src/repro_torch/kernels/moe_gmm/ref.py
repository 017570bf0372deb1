"""Plain PyTorch version of the grouped expert matmul (kernel K9).

``gmm_plain`` is the oracle of the reference's ``moe_gmm/ref.py``
(``gmm_ref``): the einsum ``ecd,edf->ecf`` of x and w upcast to float32,
rows ``c >= group_sizes[e]`` set to 0, the result cast to x's dtype.
``gmm_bwd_plain`` is the plain version of its backward (kernel K9b), which
the reference takes from JAX's autodiff of ``gmm_ref``.

``acc_element``, ``epilogue_byte`` and ``box_element`` model, on the host,
where K9b's ``wgmma_overlap`` epilogue (``csrc/gmm_tiles.cuh``,
``store_tile_tma``) puts each float32 sum of a 128 x 256 tile: the wgmma
accumulator's register layout, the stmatrix store into the 128-byte
swizzled shared buffer, and the TMA store boxes that carry the buffer to
out. Their formulas are the kernel's.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

__all__ = ["acc_element", "box_element", "epilogue_byte", "gmm_bwd_plain", "gmm_plain"]


def gmm_plain(x: torch.Tensor, w: torch.Tensor,
              group_sizes: Optional[torch.Tensor] = None) -> torch.Tensor:
    """x (E, C, D), w (E, D, F), group_sizes (E,) valid rows per expert or
    None (all C) -> (E, C, F) in x's dtype."""
    out = torch.bmm(x.float(), w.float())
    if group_sizes is not None:
        C = x.shape[1]
        rows = torch.arange(C, device=x.device)
        valid = rows[None, :] < group_sizes.to(x.device)[:, None]
        out = torch.where(valid[..., None], out, 0.0)
    return out.to(x.dtype)


def gmm_bwd_plain(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor,
                  group_sizes: Optional[torch.Tensor] = None,
                  need: Tuple[bool, bool] = (True, True)) -> tuple:
    """The backward of :func:`gmm_plain` for the cotangent dy (E, C, F):
    (dx (E, C, D) = dy . w^T in x's dtype, dw (E, D, F) = x^T . dy in w's
    dtype), float32 products, each None unless ``need`` asks for it. Rows
    ``c >= group_sizes[e]`` of x and dy are never read (the forward wrote 0
    there whatever they held), and those rows of dx are 0."""
    xf, dyf = x.float(), dy.float()
    valid = None
    if group_sizes is not None:
        rows = torch.arange(x.shape[1], device=x.device)
        valid = (rows[None, :] < group_sizes.to(x.device)[:, None])[..., None]
        xf, dyf = torch.where(valid, xf, 0.0), torch.where(valid, dyf, 0.0)
    dx = dw = None
    if need[0]:
        dx = torch.bmm(dyf, w.float().transpose(1, 2))
        if valid is not None:
            dx = torch.where(valid, dx, 0.0)
        dx = dx.to(x.dtype)
    if need[1]:
        dw = torch.bmm(xf.transpose(1, 2), dyf).to(w.dtype)
    return dx, dw


# the persistent pipeline's tile, a swizzle atom (64 rows of 128 bytes, the
# TMA store's 64 x 64 bf16 box), a consumer warpgroup's rows and the columns
# of one fill of the epilogue buffer (half the tile)
_TILE_N, _ATOM, _BOX, _WG_ROWS = 256, 64 * 128, 64, 64
_HN = _TILE_N // 2


def acc_element(cw: int, tq: int, k: int) -> Tuple[int, int]:
    """(row, column) of the tile that ``acc[k]`` of thread ``tq`` (0..127)
    of consumer warpgroup ``cw`` holds after wgmma m64n256k16: acc[4i +
    {0,1}] is row 16 (tq / 32) + (tq % 32) / 4 of the warpgroup's 64,
    columns 8i + 2 (tq % 4) + {0,1}; acc[4i + {2,3}] the row 8 below."""
    warp, lane = divmod(tq, 32)
    i, r = divmod(k, 4)
    return (_WG_ROWS * cw + 16 * warp + lane // 4 + 8 * (r // 2),
            8 * i + 2 * (lane % 4) + r % 2)


def _stmatrix_addr(cw: int, warp: int, lane: int, p: int) -> int:
    """The byte of the epilogue buffer whose address ``lane`` of ``warp``
    gives to the p-th stmatrix.x4 of a fill (the kernel's expression)."""
    j = lane // 8
    sr = 16 * warp + 8 * (j % 2) + lane % 8
    cb = 16 * p + 8 * (j // 2)
    wbuf = cw * (_WG_ROWS * _HN * 2)
    return wbuf + (cb // _BOX) * _ATOM + sr * 128 + ((((cb % 64) // 8) ^ (sr % 8)) << 4)


def epilogue_byte(cw: int, tq: int, k: int) -> Tuple[int, int]:
    """(fill, byte of the shared buffer) where the epilogue puts ``acc[k]``
    of thread ``tq`` of warpgroup ``cw``; the buffer is filled twice a tile,
    with 128 columns each time. stmatrix.x4 number p of fill h stores acc
    blocks i = h * 16 + 2p
    and i + 1 as four 8 x 8 matrices (register/matrix j = 2 (i % 2) +
    (k % 4) / 2); a lane's value (row lane / 4, element 2 (lane % 4) + k %
    2 of its matrix) goes to that matrix row's address, given by lane 8j +
    lane / 4."""
    warp, lane = divmod(tq, 32)
    i, r = divmod(k, 4)
    h, i_in = divmod(i, _HN // 8)
    p, jb = divmod(i_in, 2)
    j = 2 * jb + r // 2
    row_base = _stmatrix_addr(cw, warp, 8 * j + lane // 4, p)
    return h, row_base + 2 * (2 * (lane % 4) + r % 2)


def box_element(h: int, byte: int) -> Tuple[int, int]:
    """(row, column) of the tile that fill ``h``'s TMA stores carry from
    ``byte`` of the buffer: warpgroup cw's part holds its boxes a (64 x 64,
    columns 128 h + 64a on) one after another, each row 128 bytes with its
    16-byte chunk c at c ^ (row % 8) (the map's 128-byte swizzle)."""
    cw, off = divmod(byte, _WG_ROWS * _HN * 2)
    a, off = divmod(off, _ATOM)
    row, off = divmod(off, 128)
    chunk, off = divmod(off, 16)
    return _WG_ROWS * cw + row, h * _HN + _BOX * a + 8 * (chunk ^ (row % 8)) + off // 2
