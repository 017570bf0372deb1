"""The yardstick's arithmetic on hand-worked cases: least times and roofline
shares, the (query, key) pairs a mask keeps, model FLOPs, the p95, the
union of device intervals and the idle gaps, the frozen kernel classes."""

from collections import Counter

import pytest

from portbench.families import moe
from portbench.harness import drive, manifest, trace, work
from portbench.harness.cell import Window


def test_least_time_is_the_larger_bound():
    # 3.35e9 bytes take 1 ms; 989e9 bf16 operations take 1 ms
    assert work.least_s(3.35e9) == pytest.approx(1e-3)
    assert work.least_s(3.35e9, bf16_ops=2 * 989e9) == pytest.approx(2e-3)
    assert work.least_s(0.0, bf16_ops=989e9, f32_ops=67e9) == pytest.approx(2e-3)


@pytest.mark.parametrize("S,window,want", [
    (4, None, 10),                  # 1 + 2 + 3 + 4
    (4, 2, 7),                      # 1 + 2 + 2 + 2
    (4, 4, 10),
    (10, 4, 1 + 2 + 3 + 4 * 7),
])
def test_kept_pairs(S, window, want):
    assert work.kept_pairs(S, window) == want


@pytest.mark.parametrize("S,window", [(8192, 4096), (8192, None), (512, 4096), (777, 100)])
def test_kept_pairs_closed_form_counts_the_mask(S, window):
    w = window or S
    assert work.kept_pairs(S, window) == sum(min(q + 1, w) for q in range(S))


MOE = {"family": "moe", "n_layers": 2, "d_model": 8, "n_heads": 2, "n_kv_heads": 1, "vocab": 16,
       "window": None, "moe": {"n_experts": 4, "top_k": 2, "d_ff_expert": 32}}


def test_moe_model_flops_by_hand():
    # per token and layer: attention params 8*8*2 + 2*8*4 = 192, router 32;
    # head 16*8; kept assignments 3*8*32 each; pairs of 3 tokens: 6
    B, S, kept = 1, 3, 10
    want = (2 * 3 * 16 * 8 + 2 * 3 * 2 * (192 + 32) + 2 * kept * 3 * 8 * 32
            + 4 * 2 * 4 * 6 * 2)
    assert moe.model_flops(MOE, B, S, kept_total=kept) == want


def test_weight_bytes_counts_hit_experts_once():
    full = moe.weight_bytes(MOE)
    one_expert_less = moe.weight_bytes(MOE, experts_hit=2 * 4 - 1)
    assert full - one_expert_less == 2 * 3 * 8 * 32


def test_k9_layer_counts_kept_rows_and_hit_experts():
    wk = work.Work()
    a = {"d_model": 8, "moe": {"d_ff_expert": 32}}
    work.k9_layer(wk, "k9", a, [2, 0, 1, 0])
    # three products; bytes of two experts' weights each, rows in and out
    b = 3 * 2 * 2 * 8 * 32 + 2 * 3 * (8 + 32) * 3
    ops = 3 * 2 * 3 * 8 * 32
    assert wk.least["k9"] == pytest.approx(3 * work.least_s(b / 3, bf16_ops=ops / 3))


class _Reduced:
    def __init__(self, window_s, busy_s, class_s):
        self.window_s, self.busy_s, self.class_s = window_s, busy_s, class_s


def test_window_shares():
    wk = work.Work()
    wk.least["model"] = 0.5
    wk.least["k9"] = 0.3
    wk.steps = 10
    w = Window(2.0, _Reduced(2.0, 1.5, {"expert products K9": 0.6, "float32 GEMM": 0.05}), wk)
    assert w.mfu() == pytest.approx(25.0)
    assert w.roofline("k9", "expert products K9") == pytest.approx(50.0)
    assert w.roofline("k4", "attention K4-K6") is None
    assert w.idle() == pytest.approx(25.0)
    assert w.ms_per_step("float32 GEMM") == pytest.approx(5.0)


def test_p95_interpolates_between_order_statistics():
    assert drive.p95([float(i) for i in range(1, 101)]) == pytest.approx(95.05)
    assert drive.p95([1.0, 2.0]) == pytest.approx(1.95)


def test_union_counts_overlaps_once():
    assert trace.union_s([(0, 10), (5, 20), (30, 40)]) == pytest.approx(30e-9)
    assert trace.union_s([]) == 0


def test_gaps_of_a_window():
    assert trace.gaps([(10, 20), (15, 30), (40, 50)], 0, 60) == [(0, 10), (30, 40), (50, 60)]
    assert trace.gaps([(0, 60)], 0, 60) == []


@pytest.mark.parametrize("name,cls", [
    ("(anonymous namespace)::hop::gmm_prefill_hopper(CUtensorMap_st)", "expert products K9"),
    ("gmm_bwd_wgmma_overlap", "expert backward K9b"),
    ("void (anonymous namespace)::hop::flash_fwd_hopper<128>", "attention K4-K6"),
    ("decode_ring_kernel", "decode attention K7"),
    ("ssd_states_kernel", "SSD scan K8"),
    ("ssd_bwd_chunk", "SSD backward K8b"),
    ("chunk_scan::state_pass_kernel", "state passes of K8, K12, K8b and K12b"),
    ("nvjet_tst_256x128_64x4_1x2_h_bz_coopA_NNT", "bf16 GEMM"),
    ("sm90_xmma_gemm_f32f32_tf32f32", "float32 GEMM"),
    ("void at::native::vectorized_elementwise_kernel<8>", "elementwise, copies and reductions"),
    ("Memcpy DtoH (Device -> Pageable)", "other"),
])
def test_kernel_classes_are_frozen(name, cls):
    assert trace.kernel_class(name) == cls


def test_prefill_work_sums_each_requests_least_time():
    a = dict(MOE, family="moe")

    class Ctx:
        cfg = {"arch": a}
        records = [(1, 3), (2, 4)]

    kept = [[2, 1, 0, 3], [1, 1, 1, 3], [4, 0, 0, 12], [2, 2, 2, 10]]   # 2 layers a request
    wk = manifest.family_work("moe", "prefill")(Ctx, kept)
    assert (wk.steps, wk.tokens) == (2, 3 + 8)
    want = work.Work()
    for (B, S), layers in zip(Ctx.records, (kept[:2], kept[2:4])):
        want.add("model", moe.weight_bytes(a, work.experts_hit(layers)) + 2.0 * B * S * 8,
                 bf16_ops=moe.model_flops(a, B, S, sum(map(sum, layers))))
        for layer in layers:
            work.k9_layer(want, "k9", a, layer)
            work.k4_call(want, "k4", a, B, S, None)
    assert dict(wk.least) == pytest.approx(dict(want.least))


def test_breakdown_keeps_ten_of_each():
    by = Counter({f"k{i}": float(i) for i in range(20)})
    r = trace.Reduced(1.0, 0.5, {}, by, [("sync", 0.1)] * 12)
    b = r.breakdown()
    assert len(b["device_ops"]) == 10 and len(b["idle_gaps"]) == 10
    assert b["device_ops"][0][1] == 19.0
