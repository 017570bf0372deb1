"""Host-side pieces of K9's and K11's routes on the card, as plain functions.

The grouped expert matmul K9 has four hand-written kernels on the card;
``moe_gmm.ops.gmm_route`` picks one by dtype, shape and alignment and
``gmm_plan`` its grid, which the C entry points take and check. Its
prefill kernel is persistent: ``persistent_tiles`` mirrors the kernel's
loop, and each output tile must be computed exactly once. K11 (the RMSNorm
backward) picks its layout by width. ``chip_smoke.py``'s build check reads
``nvcc -Xptxas -v`` output: it is held here to canned logs of K9's
instantiations, one clean and one with a spill. None of this needs a card.
"""
from __future__ import annotations

import re
import sys
from pathlib import Path

import pytest
import torch

from repro_torch.kernels.moe_gmm import ops, ref
from repro_torch.kernels.rmsnorm import ops as rms_ops

ROOT = Path(__file__).resolve().parent.parent
CSRC = ROOT / "src" / "repro_torch" / "csrc"
BF16, F32 = torch.bfloat16, torch.float32


# ----------------------------------------------------------------- routes

@pytest.mark.parametrize("dtype,C,D,F,aligned,want", [
    (BF16, 2560, 6144, 16384, True, "wgmma"),          # mixtral-8x22b prefill, w_gate
    (BF16, 2560, 16384, 6144, True, "wgmma"),          # its w_down
    (BF16, 16, 6144, 16384, True, "wgmma_decode"),     # a decode step of 4 slots
    (BF16, 16, 16384, 6144, True, "wgmma_decode"),
    (BF16, 64, 48, 24, True, "wgmma_decode"),          # the decode route's widest N
    (BF16, 65, 48, 24, True, "wgmma"),
    (BF16, 77, 50, 30, True, "mma_sync"),              # D, F not multiples of 8
    (BF16, 77, 48, 30, True, "mma_sync"),              # F alone
    (BF16, 77, 50, 32, True, "mma_sync"),              # D alone
    (BF16, 2560, 6144, 16384, False, "mma_sync"),      # an unaligned base
    (BF16, 16, 0, 16, True, "mma_sync"),               # no K: nothing for TMA to load
    (F32, 2560, 6144, 16384, True, "cuda_core_f32"),
    (F32, 16, 50, 30, False, "cuda_core_f32"),
])
def test_gmm_route_by_dtype_shape_and_alignment(dtype, C, D, F, aligned, want):
    assert ops.gmm_route(dtype, C, D, F, aligned) == want


def test_route_of_reads_shape_dtype_and_alignment_from_the_tensors():
    x, w = torch.zeros((2, 16, 64), dtype=BF16), torch.zeros((2, 64, 72), dtype=BF16)
    assert ops.route_of(x, w) == "wgmma_decode"
    assert ops.route_of(torch.zeros((2, 80, 64), dtype=BF16), w) == "wgmma"
    assert ops.route_of(x.float(), w.float()) == "cuda_core_f32"
    # the same shape two bytes past a 16-byte boundary: no TMA map
    shifted = torch.zeros(x.numel() + 8, dtype=BF16)[1:1 + x.numel()].view(2, 16, 64)
    assert shifted.data_ptr() % 16 == 2
    assert ops.route_of(shifted, w) == "mma_sync"


def test_gmm_route_refuses_other_dtypes():
    with pytest.raises(TypeError, match="not supported"):
        ops.gmm_route(torch.float16, 16, 64, 64, True)


@pytest.mark.parametrize("route,E,C,F,sms,tiles,grid", [
    # prefill: 20 row tiles x 64 (w_gate) or 24 (w_down) column tiles x 8
    # experts, one persistent block an SM
    ("wgmma", 8, 2560, 16384, 132, 10240, (132, 1, 1)),
    ("wgmma", 8, 2560, 6144, 132, 3840, (132, 1, 1)),
    ("wgmma", 3, 130, 200, 132, 6, (6, 1, 1)),          # fewer tiles than SMs
    # decode: 128 columns of w a block, every expert
    ("wgmma_decode", 8, 16, 16384, 132, 1024, (128, 8, 1)),
    ("wgmma_decode", 8, 16, 6144, 132, 384, (48, 8, 1)),
    ("wgmma_decode", 2, 40, 72, 132, 2, (1, 2, 1)),
    # ragged shapes on PR 14's design and the float32 route
    ("mma_sync", 2, 77, 30, 132, 2, (1, 1, 2)),
    ("mma_sync", 8, 2560, 16384, 132, 20480, (20, 128, 8)),
    ("cuda_core_f32", 8, 16, 16384, 132, 2048, (1, 256, 8)),
])
def test_gmm_plan_tiles_and_grid(route, E, C, F, sms, tiles, grid):
    plan = ops.gmm_plan(route, E, C, F, sms)
    assert (plan.route, plan.tiles, plan.grid) == (route, tiles, grid)
    assert plan.symbol == ops.ROUTES[route][0]


def test_gmm_plan_decode_takes_at_most_64_rows():
    with pytest.raises(ValueError, match="C <= 64"):
        ops.gmm_plan("wgmma_decode", 8, 65, 16384, 132)


@pytest.mark.parametrize("E,C,F,n_blocks", [
    (8, 2560, 16384, 132), (8, 2560, 6144, 132), (3, 130, 200, 6), (2, 300, 264, 7),
    (1, 1, 1, 1), (5, 1000, 1000, 131),
])
def test_persistent_schedule_covers_each_tile_once(E, C, F, n_blocks):
    bm, bn = ops.ROUTES["wgmma"][1]
    mt, nt = -(-C // bm), -(-F // bn)
    seen = [t for b in range(n_blocks) for t in ops.persistent_tiles(b, n_blocks, E, C, F)]
    assert len(seen) == mt * nt * E
    assert sorted(seen) == [(m, n, e) for m in range(mt) for n in range(nt) for e in range(E)]
    # row tiles fastest: a block's first tiles, across blocks, walk the rows
    # of one column tile before the next
    firsts = [ops.persistent_tiles(b, n_blocks, E, C, F)[0] for b in range(min(n_blocks, mt))]
    assert firsts == [(m, 0, 0) for m in range(len(firsts))]


def _constexpr(source: str, name: str) -> int:
    m = re.search(rf"\b{name} = (\d+)", (CSRC / source).read_text())
    assert m, f"{name} not found in {source}"
    return int(m.group(1))


def test_gmm_host_tiles_are_the_kernels():
    """The tiles the host plans with are the kernels' constants."""
    src = "moe_gmm.cu"
    assert ops.ROUTES["wgmma"][1] == (_constexpr("gmm_tiles.cuh", "PM"),
                                      _constexpr("gmm_tiles.cuh", "PN"))
    assert ops.ROUTES["wgmma_decode"][1][1] == _constexpr(src, "SF")
    assert ops.ROUTES["mma_sync"][1] == (_constexpr(src, "HM"), _constexpr(src, "HN"))
    assert ops.ROUTES["cuda_core_f32"][1] == (_constexpr(src, "FM"), _constexpr(src, "FN"))
    text = (CSRC / src).read_text()
    for symbol, _ in ops.ROUTES.values():
        assert f'extern "C" int {symbol}(' in text


def test_gmm_bwd_host_tiles_are_the_kernels():
    """K9b's wgmma route plans with the pipeline it shares with K9's prefill,
    its CUDA-core routes with its own tiles; every entry point exists."""
    src = "moe_gmm_bwd.cu"
    assert ops.BWD_ROUTES["wgmma"][1] == ops.ROUTES["wgmma"][1]
    for route in ("cuda_core_bf16", "cuda_core_f32"):
        assert ops.BWD_ROUTES[route][1] == (_constexpr(src, "FM"), _constexpr(src, "FN"))
    text = (CSRC / src).read_text()
    assert '#include "gmm_tiles.cuh"' in text and "gmm_tiles<" in text
    assert "gmm_tiles<FWD>" in (CSRC / "moe_gmm.cu").read_text()
    for which in ("dx", "dw"):
        for suffix, _ in ops.BWD_ROUTES.values():
            assert f'extern "C" int moe_gmm_bwd_{which}_{suffix}(' in text


# ------------------------------------------------ K9b's overlapped epilogue

@pytest.mark.parametrize("dtype,D,F,aligned,want", [
    (BF16, 6144, 16384, True, "wgmma_overlap"),        # mixtral-8x22b training, w_gate
    (BF16, 16384, 6144, True, "wgmma_overlap"),        # its w_down
    (BF16, 48, 24, True, "wgmma_overlap"),
    (BF16, 50, 30, True, "cuda_core_bf16"),             # D, F not multiples of 8
    (BF16, 48, 30, True, "cuda_core_bf16"),
    (BF16, 6144, 16384, False, "cuda_core_bf16"),      # an unaligned base
    (BF16, 0, 16, True, "cuda_core_bf16"),
    (F32, 6144, 16384, True, "cuda_core_f32"),
])
def test_gmm_bwd_route_picks_the_overlapped_epilogue_for_aligned_bf16(dtype, D, F, aligned, want):
    assert ops.gmm_bwd_route(dtype, D, F, aligned) == want


@pytest.mark.parametrize("route", ["wgmma_overlap", "wgmma"])
@pytest.mark.parametrize("which,E,C,D,F,tiles", [
    ("dx", 8, 2560, 6144, 16384, 20 * 24 * 8), ("dw", 8, 2560, 6144, 16384, 48 * 64 * 8),
    ("dx", 8, 2560, 16384, 6144, 20 * 64 * 8), ("dw", 8, 2560, 16384, 6144, 128 * 24 * 8),
    ("dx", 3, 130, 96, 200, 2 * 1 * 3),
])
def test_gmm_bwd_plan_of_both_persistent_routes(route, which, E, C, D, F, tiles):
    """Both wgmma routes (the overlapped one ``gmm_bwd_route`` picks, and the
    first design's, which ``route=`` still takes) plan a persistent grid of at most
    one block an SM, each with its own entry point."""
    plan = ops.gmm_bwd_plan(which, route, E, C, D, F, 132)
    assert (plan.route, plan.tiles, plan.grid) == (route, tiles, (min(tiles, 132), 1, 1))
    assert plan.symbol == f"moe_gmm_bwd_{which}_{ops.BWD_ROUTES[route][0]}"
    assert f'extern "C" int {plan.symbol}(' in (CSRC / "moe_gmm_bwd.cu").read_text()


@pytest.mark.parametrize("group", [0, 1, 3, 38])
@pytest.mark.parametrize("which", ["dx", "dw"])
@pytest.mark.parametrize("E,C,F,n_blocks", [
    (8, 2560, 16384, 132), (8, 2560, 6144, 132), (3, 130, 200, 6), (2, 300, 264, 7),
    (1, 1, 1, 1), (5, 1000, 1000, 131), (2, 320, 72, 5),   # C = 320: three row tiles
])
def test_gmm_bwd_schedule_covers_each_tile_once(which, E, C, F, n_blocks, group):
    """The overlap route's grid (at most the SMs) and its tile order cover
    each tile once, in raster groups of 1, 3 or 38 row tiles (the last
    group shorter, or one group where there are fewer) or in the plain
    order, with odd row-tile counts (C = 1, 130, 300, 1000 or 320 in dx)."""
    D = 520
    bm, bn = ops.BWD_ROUTES["wgmma_overlap"][1]
    M, N = (C, D) if which == "dx" else (D, F)
    mt, nt = -(-M // bm), -(-N // bn)
    grid = ops.gmm_bwd_plan(which, "wgmma_overlap", E, C, D, F, n_blocks).grid[0]
    assert 1 <= grid <= n_blocks
    seen = [t for b in range(grid) for t in ops.gmm_bwd_tiles(which, b, grid, E, C, D, F, group)]
    assert len(seen) == mt * nt * E
    assert sorted(seen) == [(m, n, e) for m in range(mt) for n in range(nt) for e in range(E)]


def test_gmm_bwd_schedule_without_groups_is_the_prefills():
    for b in range(7):
        assert (ops.gmm_bwd_tiles("dw", b, 7, 2, 300, 520, 264)
                == ops.persistent_tiles(b, 7, 2, 520, 264))


def test_gmm_bwd_raster_group_walks_a_group_before_the_next():
    """In raster groups of 3 row tiles, the first tiles walk row tiles 0-2
    of every column tile of the expert before row tile 3; the group size
    keeps a group's A operand within the budget."""
    order = [t for b in range(12) for t in ops.gmm_bwd_tiles("dw", b, 1000, 1, 2560, 1000, 1000,
                                                              3)]
    assert order == [(m, n, 0) for n in range(4) for m in range(3)]
    # dw's A tile is 128 rows x C = 2560 of x (655360 bytes): 38 in 24 MiB;
    # dx's 128 x F = 16384 of dy: 6
    assert ops.RASTER_MIB == 24
    assert ops.raster_group("dw", 2560, 6144) == 38
    assert ops.raster_group("dx", 2560, 16384) == 6
    assert ops.raster_group("dx", 8, 1 << 20) == 1   # A past the budget: a row tile a group


@pytest.mark.parametrize("which,E,C,D,F", [
    ("dx", 8, 2560, 6144, 16384), ("dw", 8, 2560, 6144, 16384), ("dw", 8, 2560, 16384, 6144),
    ("dx", 3, 130, 96, 200),
])
def test_gmm_bwd_overlap_entry_takes_the_plans_raster_group(which, E, C, D, F):
    """The host plans the raster group once and the overlap route's C entry
    takes it after the grid (the ``wgmma`` route walks the plain order and
    takes none), so the schedule the CPU tests check is the one launched."""
    plan = ops.gmm_bwd_plan(which, "wgmma_overlap", E, C, D, F, 132)
    assert plan.group == ops.raster_group(which, C, F) >= 1
    assert ops.gmm_bwd_plan(which, "wgmma", E, C, D, F, 132).group == 0
    text = (CSRC / "moe_gmm_bwd.cu").read_text()
    for route, tail in (("wgmma_overlap", "int gz, int group, void* stream"),
                        ("wgmma", "int gy, int gz, void* stream")):
        symbol = ops.gmm_bwd_plan(which, route, E, C, D, F, 132).symbol
        sig = re.search(rf'extern "C" int {symbol}\(([^)]*)\)', text)
        assert sig and " ".join(sig.group(1).split()).endswith(tail), symbol
    assert "int raster_group(" not in text   # one formula, the host's


def test_epilogue_layout_is_a_bijection_equal_to_the_register_layout():
    """Each sum of a 128 x 256 tile goes, through stmatrix and the 128-byte
    swizzle, to one byte of one fill of the shared buffer, and the TMA
    store boxes carry that byte to the row and column the wgmma register
    layout gives it: every byte pair of the buffer once a fill."""
    fills = ops.EPI_FILLS
    bm, bn = ops.BWD_ROUTES["wgmma_overlap"][1]
    buf = bm * (bn // fills) * 2
    where = {}
    for cw in range(2):
        for tq in range(128):
            for k in range(bn // 2):
                h, byte = ref.epilogue_byte(cw, tq, k)
                assert 0 <= h < fills and 0 <= byte < buf and byte % 2 == 0
                assert ref.box_element(h, byte) == ref.acc_element(cw, tq, k)
                where[(h, byte)] = ref.acc_element(cw, tq, k)
    assert len(where) == fills * buf // 2 == bm * bn
    assert sorted(where.values()) == [(r, c) for r in range(bm) for c in range(bn)]


def test_epilogue_model_sees_an_unswizzled_store():
    """The model is not trivially true: a store that left out the XOR of the
    row into the 16-byte chunk would put every sum of a row not a multiple
    of 8 where the TMA store reads another element."""
    wrong = 0
    for tq in range(128):
        for k in range(128):
            h, byte = ref.epilogue_byte(0, tq, k)
            row, chunk = (byte % (64 * 128)) // 128, (byte % 128) // 16
            plain = byte + 16 * ((chunk ^ (row % 8)) - chunk)
            wrong += ref.box_element(h, plain) != ref.acc_element(0, tq, k)
    assert wrong == 128 * 128 * 7 // 8


def test_gmm_bwd_pipeline_sizes_are_the_sources():
    """Tile, stages, store box and epilogue buffer the host plans with are
    the constants of csrc/gmm_tiles.cuh; both persistent routes' dynamic
    shared memory fits a block; the overlap route's kernel takes the
    halves' epilogue."""
    src = "gmm_tiles.cuh"
    assert ops.BWD_ROUTES["wgmma_overlap"][1] == (_constexpr(src, "PM"), _constexpr(src, "PN"))
    assert ops.PIPE_STAGES == _constexpr(src, "PSTAGES")
    text = (CSRC / src).read_text()
    assert re.search(r"constexpr int EPI_HN = PN / (\d+);", text).group(1) == str(ops.EPI_FILLS)
    assert ops.SMEM_LIMIT == _constexpr(src, "SMEM_LIMIT") == 232448
    assert _constexpr(src, "EPI_BOX") == 64
    # the register epilogue's pipeline, and the overlapped one
    assert [ops.pipe_smem(r) for r in ("wgmma", "wgmma_overlap")] == [197696, 230464]
    assert all(ops.pipe_smem(r) <= ops.SMEM_LIMIT for r in ("wgmma", "wgmma_overlap"))
    assert "gmm_tiles<MODE == 0 ? DX : DW, EPI_HALVES>" in (CSRC / "moe_gmm_bwd.cu").read_text()


def test_gmm_cuda_refuses_cpu_tensors():
    x, w = torch.ones((2, 4, 8), dtype=BF16), torch.ones((2, 8, 8), dtype=BF16)
    with pytest.raises(ValueError, match="needs tensors on the card"):
        ops.gmm_cuda(x, w, route="wgmma")


@pytest.mark.parametrize("D,want", [(64, "cluster"), (4096, "cluster"), (8192, "cluster"),
                                    (8193, "tile"), (16384, "tile")])
def test_rmsnorm_bwd_route_by_width(D, want):
    assert rms_ops.rmsnorm_bwd_route(D) == want
    assert rms_ops.BWD_ROUTES[want] in (CSRC / "rmsnorm.cu").read_text()



# K10: rows held in registers up to 8192 columns in bf16 and 4096 in
# float32, D a multiple of 8, x 16-byte aligned; the two-pass design beyond
@pytest.mark.parametrize("dtype,D,aligned,want", [
    (BF16, 4096, True, "resident"), (BF16, 2560, True, "resident"), (BF16, 8192, True, "resident"),
    (BF16, 6144, True, "resident"), (torch.float32, 4096, True, "resident"),
    (torch.float32, 5120, True, "two_pass"), (BF16, 8200, True, "two_pass"),
    (BF16, 4099, True, "two_pass"), (BF16, 4096, False, "two_pass"), (BF16, 64, True, "resident")])
def test_rmsnorm_fwd_route_by_dtype_width_and_alignment(dtype, D, aligned, want):
    assert rms_ops.rmsnorm_fwd_route(dtype, D, aligned) == want
    text = (CSRC / "rmsnorm.cu").read_text()
    assert f"int {rms_ops.FWD_ROUTES[want]}_##SUFFIX(" in text


def test_rmsnorm_fwd_resident_width_is_the_kernels():
    text = (CSRC / "rmsnorm.cu").read_text()
    m = re.search(r"return (\d+) \* (\d+) \* (\d+) / \(int\)\(sizeof\(T\) / 2\)", text)
    assert m, "resident_max_d not found"
    widest = int(m.group(1)) * int(m.group(2)) * int(m.group(3))
    assert rms_ops.RESIDENT_MAX_D == {BF16: widest, torch.float32: widest // 2}


def test_rmsnorm_fwd_cuda_refuses_cpu_tensors_and_routes_it_cannot_take():
    x, w = torch.ones((4, 4096), dtype=BF16), torch.ones(4096, dtype=BF16)
    with pytest.raises(ValueError, match="needs tensors on the card"):
        rms_ops.rmsnorm_fwd_cuda(x, w)
    with pytest.raises(ValueError, match="does not take"):
        rms_ops.rmsnorm_fwd_cuda(torch.ones((4, 4099), dtype=BF16), torch.ones(4099),
                                 route="resident")

def test_rmsnorm_cluster_width_is_the_kernels():
    src = "rmsnorm.cu"
    assert rms_ops.CLUSTER_MAX_D == _constexpr(src, "MAX_CLUSTER") * _constexpr(src, "SLICE")


# ---------------------------------------------------- the smoke's build check

_HEAD = "_ZN43_GLOBAL__N__e4abf0a9_10_moe_gmm_cu_60ecba263hop"
_K9 = {
    ("gmm_decode_hopper", "64"): f"{_HEAD}17gmm_decode_hopperILi64EEEv14CUtensorMap_stS2_PKiP13"
                                 "__nv_bfloat16iii",
    ("gmm_decode_hopper", "32"): f"{_HEAD}17gmm_decode_hopperILi32EEEv14CUtensorMap_stS2_PKiP13"
                                 "__nv_bfloat16iii",
    ("gmm_decode_hopper", "16"): f"{_HEAD}17gmm_decode_hopperILi16EEEv14CUtensorMap_stS2_PKiP13"
                                 "__nv_bfloat16iii",
    ("gmm_prefill_hopper", ""): f"{_HEAD}18gmm_prefill_hopperE14CUtensorMap_stS1_PKiP13"
                                "__nv_bfloat16iiii",
}


def _ptxas_log(regs: dict, spills: dict) -> str:
    """``-Xptxas -v`` output for K9's source, in nvcc's form: each wgmma
    instantiation, then the CUDA-core kernels the check ignores."""
    lines = ["ptxas info    : 0 bytes gmem"]
    entries = [(k, v) for k, v in _K9.items()] + [
        (("gmm_f32_kernel", None), "_ZN43_GLOBAL__N__e4abf0a9_10_moe_gmm_cu_60ecba2614gmm_f32_"
                                   "kernelEPKfS1_PKiPfiii")]
    for key, mangled in entries:
        st = spills.get(key, 0)
        lines += [f"ptxas info    : Compiling entry function '{mangled}' for 'sm_90a'",
                  f"ptxas info    : Function properties for {mangled}",
                  f"    {st} bytes stack frame, {st} bytes spill stores, {st} bytes spill loads",
                  f"ptxas info    : Used {regs.get(key, 48)} registers, used 1 barriers",
                  "ptxas info    : Compile time = 60.000 ms"]
    return "\n".join(lines)


@pytest.fixture
def smoke():
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
        yield chip_smoke
    finally:
        sys.path.remove(str(ROOT))


def test_hopper_ptxas_reads_k9_instantiations(smoke):
    regs = {("gmm_prefill_hopper", ""): 168, ("gmm_decode_hopper", "16"): 34}
    got = smoke.hopper_ptxas(_ptxas_log(regs, {}))
    assert sorted(got) == sorted((name, args, regs.get((name, args), 48), 0, 0, 0)
                                 for name, args in _K9)


def test_check_hopper_build_passes_a_clean_k9_build(smoke, capsys):
    smoke.check_hopper_build({"moe_gmm": _ptxas_log({}, {})})
    out = capsys.readouterr().out
    assert "gmm_prefill_hopper<>: 48 registers" in out
    assert out.count("[build] gmm_decode_hopper<") == 3


@pytest.mark.parametrize("fault", ["spill", "missing", "serialized"])
def test_check_hopper_build_fails_a_faulty_k9_build(smoke, fault):
    spills = {("gmm_prefill_hopper", ""): 16} if fault == "spill" else {}
    log = _ptxas_log({}, spills)
    if fault == "missing":
        log = log.replace("ILi32E", "ILi48E")
    if fault == "serialized":
        log += ("\nptxas info    : (C7515) Potential Performance Loss: wgmma.mma_async "
                "instructions are serialized due to insufficient register resources")
    with pytest.raises(SystemExit):
        smoke.check_hopper_build({"moe_gmm": log})
