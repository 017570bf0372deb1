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

from repro_torch.kernels.moe_gmm import ops
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
