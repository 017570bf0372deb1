"""Each CUDA kernel of the port against its plain version on the card.

Needs an NVIDIA GPU with nvcc; skipped elsewhere. On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Small shapes and the tuner's real shapes; every comparison of K1-K3 is
exact. K4 (flash-attention forward) is held to the float32 and bfloat16
tolerances of the reference's ``tests/test_kernels.py`` (2e-5, 2e-2), at
small shapes with every mask variant and at the llama3-8b prefill's shape;
its bfloat16 route (wgmma and TMA, 128-row and 128-key tiles) is also held
to the smoke's K4 gate (o within 1e-3 + 8e-3 relative, lse within 1e-3) at
every head dim over ragged rows and keys, split query groups, windows with
offsets and rows that see no key; the model's flash route is held to its
plain blocked route on the card.
K5 and K6 (the backward) are held to the same tolerances over the same
grid, head dim 80 included, relative to the largest magnitude of each
gradient where that exceeds 1 (a gradient sums over up to Sk keys or Sq * G
rows); their bfloat16 route (wgmma and TMA, p and ds as hi + lo bf16
halves) is also held to the smoke's K5/K6 gate (every output within 1e-3
of its largest magnitude plus 8e-3 relative) at every head dim over K4's
tiling cases, every mask on ragged rows and keys, rows that see no key, and
at the llama3-8b training shape beside the CUDA-core design
(``flash_attn_dq_bf16_simt``, ``flash_attn_dkv_bf16_simt``), which must
meet the same gate; the flash autograd function and a reduced ``Trainer``
step on the card are held to the same on the CPU. K9 (the grouped expert matmul) is held to its plain
version within one bf16 step of the largest magnitude in bfloat16 and
2e-5 in float32, at small and ragged shapes, at mixtral-8x22b's decode and
prefill shapes and with group sizes; the reduced mixtral on the card is
held to the CPU. K10 and K11 (RMSNorm) are held to their plain versions
within one bf16 step of the largest magnitude in bfloat16 and 1e-6/1e-5 in
float32, over ragged shapes and mixed gain types, through autograd on the
card against the CPU, and in a reduced dense training step whose every
gradient leaf must match the CPU's. K12 (the WKV scan) is held to its
plain version in both its functions: the state within 2e-5 of its largest
magnitude, y within one bf16 step (2e-5 in float32), and, with the
model's bf16 intra-chunk operands, where ulp-level differences flip a
rounding, 95 % of y within that and all within one more step; the reduced
rwkv6 on the card is held to the CPU.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _arena(seed, n_sources, n_obs, d, device):
    from repro_torch.core.surrogate import ForestPlane, make_forest

    rng = np.random.default_rng(seed)
    forests = []
    for s in range(n_sources):
        X = rng.random((n_obs, d))
        y = np.sin(4 * X[:, s % d]) + X[:, (s + 1) % d] + 0.1 * rng.standard_normal(n_obs)
        forests.append(make_forest(seed=s, device=device).fit(X, y))
    return forests, ForestPlane([f.pack() for f in forests])


@pytest.mark.parametrize("n_sources,n_obs,d,n", [(1, 20, 5, 7), (3, 40, 9, 1000),
                                                  (12, 50, 60, 131072)])
def test_forest_eval_matches_plain(cuda, n_sources, n_obs, d, n):
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import ops

    _, plane = _arena(n_sources, n_sources, n_obs, d, cuda)
    X = torch.rand((n, d), dtype=torch.float64, device=cuda)
    args = (plane.feat, plane.thr, plane.child, plane.mean, plane.var, plane.roots, X,
            plane.depth)
    before = counts.LAUNCHES["forest_eval"]
    got = ops.forest_eval(*args)
    assert counts.LAUNCHES["forest_eval"] == before + 1
    want = ops.forest_eval_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("S,N", [(1, 1), (3, 1023), (2, 1025), (12, 131072)])
def test_radix_rank_matches_plain(cuda, S, N):
    from repro_torch.kernels.forest_eval import rank

    g = torch.Generator(device="cpu").manual_seed(S * N)
    scores = torch.randn((S, N), generator=g, dtype=torch.float64)
    scores[:, ::3] = 0.0
    scores[:, 1::7] = -0.0
    scores[:, 2::11] = float("inf")
    keys = rank.monotone_keys(scores.to(cuda))
    got = rank.radix_rank(keys)
    torch.cuda.synchronize()
    assert torch.equal(got, rank.radix_rank_plain(keys))
    assert torch.equal(got.cpu(), rank.rank_rows(scores))


@pytest.mark.parametrize("n_obs,d,n_chains,nb", [(40, 6, 5, 3), (220, 5, 64, 16),
                                                 (50, 60, 268, 16)])
def test_chain_ordinals_matches_plain(cuda, n_obs, d, n_chains, nb):
    from repro_torch.kernels.forest_eval import chain

    forests, _ = _arena(7, 1, n_obs, d, cuda)
    plan, reason = chain.build_chain_plan_ex(forests[0], d)
    assert plan is not None, reason
    rng = np.random.default_rng(3)
    X, bg = rng.random((4, d)), rng.random((nb, d))
    perms = np.stack([rng.permutation(d) for _ in range(n_chains)]).astype(np.int32)
    xoc = rng.integers(0, 4, n_chains)
    wx = chain.words_tensor(plan.row_words(X)[xoc], cuda)
    wb = chain.words_tensor(plan.row_words(bg), cuda)
    pt = torch.from_numpy(perms).to(cuda)
    got = chain.chain_ordinals(wx, wb, pt)
    torch.cuda.synchronize()
    assert torch.equal(got, chain.chain_ordinals_plain(wx, wb, pt))
    assert torch.equal(got.cpu(), chain.chain_ordinals_plain(wx.cpu(), wb.cpu(), pt.cpu()))


def test_ei_and_scores_match_host(cuda):
    from repro_torch.core.acquisition import aggregate_ranks, score_sources

    forests, _ = _arena(5, 4, 50, 60, cuda)
    host = [f for f in _arena(5, 4, 50, 60, "cpu")[0]]
    X = np.random.default_rng(1).random((4096, 60))
    incs = [0.1, 0.2, -0.3, 0.0]
    got = score_sources(forests, torch.from_numpy(X).to(cuda), incs)
    want = score_sources(host, torch.from_numpy(X), incs)
    assert torch.equal(got.cpu(), want)
    w = [0.4, 0.3, 0.2, 0.1]
    assert torch.equal(aggregate_ranks(got, w).cpu(), aggregate_ranks(want, w))


# --------------------------------------------------------------------- K4

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (causal, window, q offset): the offset case drops the first half of the
# queries, so Sq < Sk and the rows sit at positions Sk - Sq ...
FLASH_MASKS = [(True, None, False), (False, None, False), (True, 32, False),
               (False, 32, False), (True, None, True)]


def _flash_inputs(BH, Sq, Sk, G, D, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((BH, Sq, G, D), generator=g).to(device=device, dtype=dtype)
    k = torch.randn((BH, Sk, D), generator=g).to(device=device, dtype=dtype)
    v = torch.randn((BH, Sk, D), generator=g).to(device=device, dtype=dtype)
    return q, k, v


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("BH,Sq,Sk,G,D", [(2, 64, 64, 1, 16), (4, 128, 128, 2, 32),
                                          (3, 48, 80, 3, 64), (2, 64, 192, 4, 128),
                                          (1, 32, 96, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,offset", FLASH_MASKS)
def test_flash_fwd_matches_plain(cuda, BH, Sq, Sk, G, D, dtype, causal, window, offset):
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops

    q, k, v = _flash_inputs(BH, Sq, Sk, G, D, dtype, cuda)
    q_offset = 0
    if offset:
        q = q[:, Sq // 2:].contiguous()
        q_offset = Sk - q.shape[1]
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=8, kv_block=16)
    before = counts.LAUNCHES["flash_attn_fwd"]
    o, lse = ops.flash_fwd(q, k, v, **kw)
    assert counts.LAUNCHES["flash_attn_fwd"] == before + 1
    o_ref, lse_ref = ops.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    _close(o, o_ref, FLASH_TOL[dtype])
    _close(lse, lse_ref, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_rows_with_no_visible_key_match_plain(cuda, dtype, causal):
    from repro_torch.kernels.flash_attn import ops

    # positions 96..223 over 64 keys with a window of 32: the rows from
    # position 95 + 32 = 127 on see no key, and the reference gives them
    # the mean of every V row with lse -1e30
    q, k, v = _flash_inputs(2, 128, 64, 2, 64, dtype, cuda, seed=3)
    kw = dict(causal=causal, window=32, q_offset=96, q_block=8, kv_block=16)
    o, lse = ops.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = ops.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert bool((lse_ref[:, 32:] == -1e30).all())
    _close(o, o_ref, FLASH_TOL[dtype])
    _close(lse, lse_ref, FLASH_TOL[dtype])


def test_flash_attention_matches_oracle(cuda):
    from repro_torch.kernels.flash_attn import ops, ref

    B, S, Hkv, G, D = 2, 96, 2, 3, 64
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn((B, S, Hkv, G, D), generator=g).to(cuda)
    k = torch.randn((B, S, Hkv, D), generator=g).to(cuda)
    v = torch.randn((B, S, Hkv, D), generator=g).to(cuda)
    for causal, window in [(True, None), (False, None), (True, 32)]:
        o = ops.flash_attention(q, k, v, causal=causal, window=window, q_block=32, kv_block=32)
        _close(o, ref.attention_ref(q, k, v, causal=causal, window=window), 2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fwd_at_llama3_prefill_shape(cuda, dtype):
    from repro_torch.kernels.flash_attn import ops

    # llama3-8b prefill of 2 x 4096 tokens: B*Hkv = 16, G = 4, head dim 128
    q, k, v = _flash_inputs(16, 4096, 4096, 4, 128, dtype, cuda, seed=2)
    kw = dict(causal=True, q_block=512, kv_block=1024)
    o, lse = ops.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = ops.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(o, o_ref, FLASH_TOL[dtype])
    _close(lse, lse_ref, FLASH_TOL[dtype])


# the bf16 route's gate, that of chip_smoke.py's K4_O_TOL and K4_LSE_ATOL:
# P enters P . V as two bf16 halves, so o keeps about 16 bits of p
K4_BF16_O_TOL = (1e-3, 8e-3)
K4_LSE_ATOL = 1e-3
# (BH, Sq, Sk, G, causal, window, q_offset, input scale): 128-row q tiles
# that end inside the rows (Sq * G = 150, 240, 64, 192, 256, 600) and split
# a position's group (G = 3, 6); keys that end inside a 128-key tile, and
# fewer keys than one tile; windows with offsets; rows past the keys' end
# that see no key (the fifth case, from position 127 on); inputs x 3,
# where more rows cancel to near 0
K4_TILING_CASES = [
    (2, 50, 200, 3, True, None, 150, 3.0),
    (3, 40, 40, 6, True, None, 0, 1.0),
    (2, 64, 300, 1, False, None, 0, 1.0),
    (2, 96, 384, 2, True, 128, 288, 1.0),
    (2, 128, 64, 2, False, 32, 96, 1.0),
    (1, 100, 260, 6, True, 64, 160, 1.0),
]


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("case", K4_TILING_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_fwd_bf16_tiling_meets_the_smoke_gate(cuda, D, case):
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops

    BH, Sq, Sk, G, causal, window, q_offset, scale = case
    q, k, v = (t * scale for t in _flash_inputs(BH, Sq, Sk, G, D, torch.float32, "cpu", seed=D))
    q, k, v = (t.to(device=cuda, dtype=torch.bfloat16) for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=Sq, kv_block=Sk)
    before = counts.LAUNCHES["flash_attn_fwd"]
    o, lse = ops.flash_fwd(q, k, v, **kw)
    assert counts.LAUNCHES["flash_attn_fwd"] == before + 1
    o_ref, lse_ref = ops.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o.float()).all())
    atol, rtol = K4_BF16_O_TOL
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    assert float((lse - lse_ref).abs().max()) <= K4_LSE_ATOL
    if window is not None and q_offset + Sq > Sk + window:
        assert bool((lse_ref == -1e30).any())   # the case has rows that see no key


def test_flash_fwd_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attn import ops

    for D in (48, 192):
        q, k, v = _flash_inputs(1, 64, 64, 1, D, torch.float32, cuda)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_fwd(q, k, v)
    q, k, v = _flash_inputs(1, 64, 64, 1, 64, torch.float16, cuda)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_fwd(q, k, v)
    q, k, v = _flash_inputs(1, 64, 64, 1, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="divide"):
        ops.flash_fwd(q, k, v, q_block=48)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_flash_route_matches_plain_route(cuda, dtype):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, forward, init_params

    cfg = reduced(get_arch("llama3-8b"))
    rt = Runtime(param_dtype=dtype, compute_dtype=dtype, attn_chunk=16, q_block=32,
                 kv_block=32)
    params = init_params(build_param_specs(cfg, rt),
                         torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab, (2, 64))).to(cuda)
    counts.reset()
    flash = forward(params, cfg, dataclasses.replace(rt, attn_impl="flash"), tokens=tokens)
    assert counts.LAUNCHES["flash_attn_fwd"] == cfg.n_layers
    assert counts.PLAIN_CALLS["flash_attn_fwd"] == 0
    plain = forward(params, cfg, rt, tokens=tokens)
    err = (torch.softmax(flash.float(), -1) - torch.softmax(plain.float(), -1)).abs().max()
    assert float(err) < (1e-5 if dtype == "float32" else 5e-2), float(err)


# ------------------------------------------------------------------ K5, K6


def _close_scaled(got, want, tol):
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=tol)


def _bwd_case(q, k, v, kw, seed=5):
    from repro_torch.kernels.flash_attn import ops

    g = torch.Generator(device="cpu").manual_seed(seed)
    do = torch.randn(q.shape, generator=g).to(device=q.device, dtype=q.dtype)
    o, lse = ops.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    return do, lse, delta


def _check_bwd(q, k, v, kw):
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops

    do, lse, delta = _bwd_case(q, k, v, kw)
    before = dict(counts.LAUNCHES)
    dq = ops.flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = ops.flash_dkv(q, k, v, do, lse, delta, **kw)
    assert counts.LAUNCHES["flash_attn_dq"] == before["flash_attn_dq"] + 1
    assert counts.LAUNCHES["flash_attn_dkv"] == before["flash_attn_dkv"] + 1
    want = (ops.flash_dq_plain(q, k, v, do, lse, delta, **kw),
            *ops.flash_dkv_plain(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == q.dtype
        _close_scaled(got, ref, FLASH_TOL[q.dtype])


@pytest.mark.parametrize("BH,Sq,Sk,G,D", [(2, 64, 64, 1, 16), (4, 128, 128, 2, 32),
                                          (3, 48, 80, 3, 64), (2, 64, 192, 4, 128),
                                          (1, 32, 96, 2, 64), (2, 64, 96, 1, 80),
                                          (3, 48, 160, 2, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,offset", FLASH_MASKS)
def test_flash_bwd_matches_plain(cuda, BH, Sq, Sk, G, D, dtype, causal, window, offset):
    q, k, v = _flash_inputs(BH, Sq, Sk, G, D, dtype, cuda)
    q_offset = 0
    if offset:
        q = q[:, Sq // 2:].contiguous()
        q_offset = Sk - q.shape[1]
    _check_bwd(q, k, v, dict(causal=causal, window=window, q_offset=q_offset, q_block=8,
                             kv_block=16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_rows_with_no_visible_key_match_plain(cuda, dtype, causal):
    # as in the forward's test: rows from position 127 on see no key, have
    # lse = -1e30, and give every key p = 1
    q, k, v = _flash_inputs(2, 128, 64, 2, 64, dtype, cuda, seed=3)
    _check_bwd(q, k, v, dict(causal=causal, window=32, q_offset=96, q_block=8, kv_block=16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_at_llama3_training_shape(cuda, dtype):
    # the llama3-8b training step of 2 x 4096 tokens: B*Hkv = 16, G = 4
    q, k, v = _flash_inputs(16, 4096, 4096, 4, 128, dtype, cuda, seed=4)
    _check_bwd(q, k, v, dict(causal=True, q_block=512, kv_block=1024))


def test_flash_bwd_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attn import ops

    lse = torch.zeros((1, 64, 1), device=cuda)
    for D in (48, 192):
        q, k, v = _flash_inputs(1, 64, 64, 1, D, torch.float32, cuda)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_dq(q, k, v, q, lse, lse)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_dkv(q, k, v, q, lse, lse)
    q, k, v = _flash_inputs(1, 64, 64, 1, 64, torch.float32, cuda)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_dkv(q, k, v, q, lse.double(), lse)
    with pytest.raises(ValueError, match="divide"):
        ops.flash_dq(q, k, v, q, lse, lse, kv_block=48)


# K5's and K6's bf16 route (wgmma and TMA, p and ds as hi + lo bf16 halves)
# against chip_smoke.py's BWD_TOL["bfloat16"]: every output within 1e-3 of
# its largest magnitude plus 8e-3 relative
BWD_BF16_TOL = (1e-3, 8e-3)


def _smoke_gate(got, want):
    atol, rtol = BWD_BF16_TOL
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=atol * scale, rtol=rtol)


def _bwd_simt(q, k, v, do, lse, delta, causal, window, q_offset):
    """(dq, dk, dv) of the CUDA-core design in bf16, exported as
    ``flash_attn_dq_bf16_simt`` and ``flash_attn_dkv_bf16_simt`` for
    comparisons only (the wrappers never reach it)."""
    from repro_torch.kernels.launch import _fn

    BH, Sq, G, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ints = (BH, Sq, k.shape[1], G, D, int(causal), int(window is not None), window or 0,
            q_offset, torch.cuda.current_stream().cuda_stream)
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    assert _fn("flash_attn_bwd", "flash_attn_dq_bf16_simt", 7, 9, 0)(
        *ptrs, dq.data_ptr(), *ints) == 0
    assert _fn("flash_attn_bwd", "flash_attn_dkv_bf16_simt", 8, 9, 0)(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *ints) == 0
    return dq, dk, dv


def _check_bwd_bf16(q, k, v, kw, simt=False):
    """K5 and K6 in bf16 (one launch each) against their plain versions
    under the smoke's gate; with ``simt``, the CUDA-core design too."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops

    do, lse, delta = _bwd_case(q, k, v, kw)
    mask = {n: kw[n] for n in ("causal", "window", "q_offset")}
    before = dict(counts.LAUNCHES)
    got = (ops.flash_dq(q, k, v, do, lse, delta, **kw), *ops.flash_dkv(q, k, v, do, lse, delta, **kw))
    assert counts.LAUNCHES["flash_attn_dq"] == before["flash_attn_dq"] + 1
    assert counts.LAUNCHES["flash_attn_dkv"] == before["flash_attn_dkv"] + 1
    want = (ops.flash_dq_plain(q, k, v, do, lse, delta, **kw),
            *ops.flash_dkv_plain(q, k, v, do, lse, delta, **kw))
    old = _bwd_simt(q, k, v, do, lse, delta, **mask) if simt else want
    torch.cuda.synchronize()
    for g, w, o in zip(got, want, old):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all())
        _smoke_gate(g, w)
        _smoke_gate(o, w)
    return lse


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("case", K4_TILING_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_bf16_tiling_meets_the_smoke_gate(cuda, D, case):
    # K4's tiling cases: 128-row q tiles and 64-key tiles (K5), 128-key
    # blocks and 64-row q tiles (K6) that end inside the rows and keys,
    # split query groups, windows with offsets, rows that see no key
    BH, Sq, Sk, G, causal, window, q_offset, scale = case
    q, k, v = (t * scale for t in _flash_inputs(BH, Sq, Sk, G, D, torch.float32, "cpu", seed=D))
    q, k, v = (t.to(device=cuda, dtype=torch.bfloat16) for t in (q, k, v))
    lse = _check_bwd_bf16(q, k, v, dict(causal=causal, window=window, q_offset=q_offset,
                                        q_block=Sq, kv_block=Sk))
    if window is not None and q_offset + Sq > Sk + window:
        assert bool((lse == -1e30).any())   # the case has rows that see no key


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("causal,window,offset", FLASH_MASKS)
def test_flash_bwd_bf16_masks_meet_the_smoke_gate(cuda, D, causal, window, offset):
    # ragged: 300 flattened rows (G = 3) and 300 keys fill no tile exactly
    q, k, v = _flash_inputs(2, 100, 300, 3, D, torch.bfloat16, cuda, seed=9)
    q_offset = 0
    if offset:
        q = q[:, 50:].contiguous()
        q_offset = 250
    _check_bwd_bf16(q, k, v, dict(causal=causal, window=window, q_offset=q_offset,
                                  q_block=q.shape[1], kv_block=100))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_bf16_rows_with_no_visible_key_meet_the_smoke_gate(cuda, causal):
    # positions 96..223 over 64 keys with a window of 32: the rows from
    # position 127 on see no key and give every key p = 1
    q, k, v = _flash_inputs(2, 128, 64, 2, 64, torch.bfloat16, cuda, seed=3)
    lse = _check_bwd_bf16(q, k, v, dict(causal=causal, window=32, q_offset=96, q_block=8,
                                        kv_block=16), simt=True)
    assert bool((lse[:, 32:] == -1e30).all())


def test_flash_bwd_bf16_at_llama3_training_shape_against_the_cuda_core_design(cuda):
    # the llama3-8b training step of 2 x 4096 tokens: B*Hkv = 16, G = 4;
    # the wgmma route and the CUDA-core design both meet the smoke's gate
    q, k, v = _flash_inputs(16, 4096, 4096, 4, 128, torch.bfloat16, cuda, seed=4)
    _check_bwd_bf16(q, k, v, dict(causal=True, window=None, q_offset=0, q_block=512,
                                  kv_block=1024), simt=True)


def test_flash_autograd_on_the_card_matches_the_cpu(cuda):
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops

    B, S, Hkv, G, D = 2, 96, 2, 3, 64
    g = torch.Generator(device="cpu").manual_seed(6)
    host = [torch.randn(s, generator=g) for s in
            ((B, S, Hkv, G, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hkv, G, D))]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (t.to(dev).requires_grad_(True) for t in host[:3])
        counts.reset()
        o = ops.flash_attention(q, k, v, causal=True, window=48, q_block=32, kv_block=32)
        o.backward(host[3].to(dev))
        on_card = dev.type == "cuda"
        for name in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
            assert counts.LAUNCHES[name] == int(on_card)
            assert counts.PLAIN_CALLS[name] == int(not on_card)
        grads[dev.type] = [o.detach().cpu()] + [t.grad.cpu() for t in (q, k, v)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _close_scaled(got, want, 2e-5)


def test_reduced_trainer_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import AdamWState
    from repro_torch.train.trainer import Trainer

    cfg = reduced(get_arch("llama3-8b"))
    rt = Runtime(param_dtype="float32", compute_dtype="float32", attn_impl="flash",
                 q_block=32, kv_block=32)
    kw = dict(seq_len=64, global_batch=2, lr=1e-3, seed=0)
    host = Trainer(cfg, rt, device="cpu", **kw)
    card = Trainer(cfg, rt, device=cuda, **kw)
    card.params = tree_map(lambda t: t.to(cuda), host.params)
    card.opt = AdamWState(host.opt.step.to(cuda), tree_map(lambda t: t.to(cuda), host.opt.m),
                          tree_map(lambda t: t.to(cuda), host.opt.v))
    counts.reset()
    card_losses = card.run(2, log_every=100)
    for name in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
        assert counts.LAUNCHES[name] == 2 * cfg.n_layers and counts.PLAIN_CALLS[name] == 0
    host_losses = host.run(2, log_every=100)
    np.testing.assert_allclose(card_losses, host_losses, rtol=1e-5)
    # Adam divides by sqrt(v): float32 noise in a gradient near eps moves its
    # parameter's update by up to a few hundredths of lr
    for a, b in zip(tree_leaves(card.params), tree_leaves(host.params)):
        torch.testing.assert_close(a.cpu(), b, atol=0.1 * 1e-3 * 2, rtol=0)


# --------------------------------------------------------------------- K9

def _gmm_inputs(E, C, D, F, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((E, C, D), generator=g).to(device=device, dtype=dtype)
    w = (torch.randn((E, D, F), generator=g) / D ** 0.5).to(device=device, dtype=dtype)
    return x, w


def _gmm_close(got, want):
    """bfloat16: within one bf16 step (2**-7 relative) of the largest
    magnitude (both sum in float32 from the same inputs, then round);
    float32: within 2e-5 of the largest magnitude and 2e-5 relative (the
    summation order differs)."""
    scale = float(want.float().abs().max())
    frac, rtol = (2.0 ** -7, 0.0) if want.dtype == torch.bfloat16 else (2e-5, 2e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=frac * scale, rtol=rtol)


# (E, C, D, F): small; C, D and F off every tile edge (the scalar load path:
# D and F not multiples of 8); mixtral-8x22b's decode (C = 16 for 4 slots)
GMM_SHAPES = [(2, 32, 48, 24), (3, 130, 96, 200), (2, 77, 50, 30), (8, 16, 6144, 16384)]


@pytest.mark.parametrize("E,C,D,F", GMM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_gmm_matches_plain(cuda, E, C, D, F, dtype, masked):
    from repro_torch.kernels import counts
    from repro_torch.kernels.moe_gmm import ops

    x, w = _gmm_inputs(E, C, D, F, dtype, cuda)
    gs = (torch.tensor([C] + [C // 2] * (E - 1), dtype=torch.int32, device=cuda)
          if masked else None)
    before, plain = counts.LAUNCHES["moe_gmm"], counts.PLAIN_CALLS["moe_gmm"]
    got = ops.grouped_matmul(x, w, gs)
    assert counts.LAUNCHES["moe_gmm"] == before + 1 and counts.PLAIN_CALLS["moe_gmm"] == plain
    want = ops.gmm_plain(x, w, gs)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (E, C, F)
    _gmm_close(got, want)
    if masked:
        assert not bool(got[1:, C // 2:].any())


def test_gmm_at_mixtral_prefill_shape(cuda):
    from repro_torch.kernels.moe_gmm import ops

    # the first layer's w_gate product of a 1 x 8192 prefill: Cr = 2560
    x, w = _gmm_inputs(8, 2560, 6144, 16384, torch.bfloat16, cuda, seed=1)
    got = ops.grouped_matmul(x, w)
    want = ops.gmm_plain(x, w)
    torch.cuda.synchronize()
    _gmm_close(got, want)


def test_gmm_group_sizes_past_the_ends(cuda):
    from repro_torch.kernels.moe_gmm import ops

    for dtype in (torch.float32, torch.bfloat16):
        x, w = _gmm_inputs(3, 140, 64, 72, dtype, cuda, seed=2)
        x[2, 100:] = float("nan")   # rows past the group size are never read
        gs = torch.tensor([0, 150, 100], dtype=torch.int32)
        got = ops.grouped_matmul(x, w, gs)   # a host tensor is moved to the card
        want = ops.gmm_plain(x, w, gs.to(cuda))
        torch.cuda.synchronize()
        assert not bool(got[0].any()) and not bool(got[2, 100:].any())
        _gmm_close(got, want)


def test_gmm_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.moe_gmm import ops

    x, w = _gmm_inputs(2, 8, 16, 8, torch.float32, cuda)
    with pytest.raises(TypeError, match="dtype"):
        ops.gmm_cuda(x, w.to(torch.bfloat16))
    with pytest.raises(TypeError, match="not supported"):
        ops.gmm_cuda(x.half(), w.half())
    with pytest.raises(ValueError, match="shape"):
        ops.gmm_cuda(x, w[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.gmm_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(TypeError, match="int32"):
        ops.gmm_cuda(x, w, torch.ones(2, dtype=torch.int64, device=cuda))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_mixtral_on_the_card_matches_the_cpu(cuda, dtype):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, decode_step, forward
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.params import tree_map

    cfg = reduced(get_arch("mixtral-8x22b"))
    rt = Runtime(param_dtype=dtype, compute_dtype=dtype, attn_impl="flash", q_block=32,
                 kv_block=32)
    host = init_params(build_param_specs(cfg, rt), torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    tokens = np.random.default_rng(0).integers(2, cfg.vocab, (2, 64))
    counts.reset()
    got = forward(card, cfg, rt, tokens=torch.from_numpy(tokens).to(cuda))
    assert counts.LAUNCHES["moe_gmm"] == 3 * cfg.n_layers
    cache = init_cache(cfg, rt, 2, 8, device=cuda)
    lg, _ = decode_step(card, cfg, rt, cache, torch.from_numpy(tokens[:, :1]).to(cuda))
    assert counts.LAUNCHES["moe_gmm"] == 6 * cfg.n_layers
    assert counts.PLAIN_CALLS["moe_gmm"] == 0
    want = forward(host, cfg, rt, tokens=torch.from_numpy(tokens))
    err = (torch.softmax(got.float().cpu(), -1) - torch.softmax(want.float(), -1)).abs().max()
    assert float(err) < (1e-5 if dtype == "float32" else 5e-2), float(err)
    host_lg, _ = decode_step(host, cfg, rt, init_cache(cfg, rt, 2, 8, device="cpu"),
                             torch.from_numpy(tokens[:, :1]))
    err = (torch.softmax(lg.float().cpu(), -1) - torch.softmax(host_lg.float(), -1)).abs().max()
    assert float(err) < (1e-5 if dtype == "float32" else 5e-2), float(err)


# ---------------------------------------------------------------- K10, K11

def _bf16_or_f32_close(got, want, f32_tol):
    """bfloat16: within one bf16 step (2**-7) of the largest magnitude (both
    compute in float32 from the same inputs, then round); float32: within
    ``f32_tol`` of it (the summation order differs)."""
    scale = float(want.float().abs().max())
    tol = 2.0 ** -7 if want.dtype == torch.bfloat16 else f32_tol
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=0)


# (N, D): one row; ragged N and a D that is not a multiple of 8 (the scalar
# path); rwkv6-7b's and llama3-8b's width at the prefill; mixtral's width
RMS_SHAPES = [(1, 64), (37, 50), (200, 96), (8192, 4096), (130, 6144)]


@pytest.mark.parametrize("N,D", RMS_SHAPES)
@pytest.mark.parametrize("dtype,wdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32)])
def test_rmsnorm_fwd_and_bwd_match_plain(cuda, N, D, dtype, wdtype):
    from repro_torch.kernels import counts
    from repro_torch.kernels.rmsnorm import ops

    g = torch.Generator(device="cpu").manual_seed(N + D)
    x = (torch.randn((N, D), generator=g) * 3).to(cuda, dtype)
    w = torch.randn((D,), generator=g).to(cuda, wdtype)
    do = torch.randn((N, D), generator=g).to(cuda, dtype)
    before = dict(counts.LAUNCHES)
    out, rstd = ops.rmsnorm_fwd(x, w, 1e-5)
    dx, parts = ops.rmsnorm_bwd(x, w, rstd, do)
    assert counts.LAUNCHES["rmsnorm_fwd"] == before["rmsnorm_fwd"] + 1
    assert counts.LAUNCHES["rmsnorm_bwd"] == before["rmsnorm_bwd"] + 1
    pout, prstd = ops.rmsnorm_fwd_plain(x, w, 1e-5)
    pdx, pparts = ops.rmsnorm_bwd_plain(x, w, rstd, do)
    torch.cuda.synchronize()
    assert out.dtype == dtype and dx.dtype == dtype and parts.shape == pparts.shape
    torch.testing.assert_close(rstd, prstd, atol=0, rtol=2e-6)
    _bf16_or_f32_close(out, pout, 1e-6)
    _bf16_or_f32_close(dx, pdx, 1e-5)
    torch.testing.assert_close(parts, pparts, atol=1e-5 * float(pparts.abs().max()), rtol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_autograd_on_the_card_matches_the_cpu(cuda, dtype):
    from repro_torch.kernels import counts
    from repro_torch.models.blocks import rmsnorm

    g = torch.Generator(device="cpu").manual_seed(3)
    host = [torch.randn(s, generator=g).to(dtype) for s in ((2, 300, 256), (256,), (2, 300, 256))]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        x, w = (t.to(dev).requires_grad_(True) for t in host[:2])
        counts.reset()
        out = rmsnorm(x, w, 1e-5)
        out.backward(host[2].to(dev))
        on_card = dev.type == "cuda"
        for name in ("rmsnorm_fwd", "rmsnorm_bwd"):
            assert counts.LAUNCHES[name] == int(on_card)
            assert counts.PLAIN_CALLS[name] == int(not on_card)
        grads[dev.type] = [out.detach().cpu(), x.grad.cpu(), w.grad.cpu()]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _bf16_or_f32_close(got, want, 1e-5)


def test_rmsnorm_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.rmsnorm import ops

    x, w = torch.ones((4, 8), device=cuda), torch.ones(8, device=cuda)
    with pytest.raises(TypeError, match="not supported"):
        ops.rmsnorm_fwd_cuda(x.half(), w)
    with pytest.raises(ValueError, match="shape"):
        ops.rmsnorm_fwd_cuda(x, torch.ones(9, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm_fwd_cuda(torch.ones((8, 4), device=cuda).t(), w)
    with pytest.raises(TypeError, match="dtype"):
        ops.rmsnorm_bwd_cuda(x, w, torch.ones(4, device=cuda), x.to(torch.bfloat16))


def test_dense_training_step_differentiates_through_k11(cuda):
    """Every gradient leaf of a reduced llama3-8b step exists with K10 and
    K11 on the path, and matches the CPU's."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, init_params, loss_fn
    from repro_torch.models.params import tree_leaves, tree_map

    cfg = reduced(get_arch("llama3-8b"))
    rt = Runtime(param_dtype="float32", compute_dtype="float32", attn_impl="flash",
                 q_block=32, kv_block=32)
    host = init_params(build_param_specs(cfg, rt), torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab, (2, 65)))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        params = tree_map(lambda t: t.to(dev).requires_grad_(True), host)
        batch = {"tokens": tokens[:, :-1].to(dev), "labels": tokens[:, 1:].to(dev)}
        counts.reset()
        loss = loss_fn(params, cfg, rt, batch)
        leaves = tree_leaves(params)
        grads[dev.type] = [gr.cpu() for gr in torch.autograd.grad(loss, leaves)]
        if dev.type == "cuda":
            assert counts.LAUNCHES["rmsnorm_fwd"] == counts.LAUNCHES["rmsnorm_bwd"] \
                == 2 * cfg.n_layers + 1
            assert counts.PLAIN_CALLS["rmsnorm_fwd"] == counts.PLAIN_CALLS["rmsnorm_bwd"] == 0
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert bool(want.abs().max() > 0)
        err = float((got - want).norm() / want.norm())
        assert err < 1e-4, err


# --------------------------------------------------------------------- K12

def _wkv_inputs(B, S, H, K, dtype, wdtype, device, seed=0):
    """r, k, v at scale 0.5, the model's floored log decay, u at scale 0.3."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r, k, v = ((torch.randn((B, S, H, K), generator=g) * 0.5).to(device, dtype)
               for _ in range(3))
    w = (-torch.nn.functional.softplus(torch.randn((B, S, H, K), generator=g)) - 0.1)
    w = w.clamp_min(-2.0).to(device, wdtype)
    u = (torch.randn((H, K), generator=g) * 0.3).to(device)
    return r, k, v, w, u


def _wkv_close(y, py, st, pst, bf16_intra):
    """The state within 2e-5 of its largest magnitude. y in float32 products:
    within one bf16 step of its largest magnitude in bfloat16, 2e-5 in
    float32. With bf16 intra-chunk operands the function jumps by one bf16
    step where the kernel's and the plain version's float32 intermediates
    (sequential vs scanned cumsum, expf vs torch's exp) straddle a rounding
    boundary: there at least 95 % of y within that bound and all within one
    bf16 step (float32 y) or two (bfloat16 y)."""
    sscale = float(pst.abs().max())
    torch.testing.assert_close(st, pst, atol=2e-5 * sscale, rtol=2e-5)
    scale = float(py.float().abs().max())
    tol = 2.0 ** -7 if py.dtype == torch.bfloat16 else 2e-5
    err = (y.float() - py.float()).abs() / scale
    if not bf16_intra:
        assert float(err.max()) <= tol, float(err.max())
        return
    assert float((err <= tol).float().mean()) >= 0.95
    assert float(err.max()) <= (2 if py.dtype == torch.bfloat16 else 1) * 2.0 ** -7


# (B, S, H, K, chunk): the rwkv6-7b layout at full head width with a few
# chunks; the reduced model's; S not a multiple of the chunk (48 -> 16,
# 33 -> 1); K below 64 and not a power of two
WKV_SHAPES = [(2, 256, 4, 64, 64), (2, 64, 4, 32, 32), (1, 48, 3, 32, 32), (2, 33, 2, 16, 16),
              (1, 96, 5, 24, 64)]


@pytest.mark.parametrize("B,S,H,K,chunk", WKV_SHAPES)
@pytest.mark.parametrize("dtype,wdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("bf16_intra", [False, True])
def test_wkv_matches_plain(cuda, B, S, H, K, chunk, dtype, wdtype, bf16_intra):
    from repro_torch.kernels import counts
    from repro_torch.kernels.rwkv6_wkv import ops

    r, k, v, w, u = _wkv_inputs(B, S, H, K, dtype, wdtype, cuda, seed=S + K)
    c = ops.cut_chunk(chunk, S)
    before = counts.LAUNCHES["rwkv6_wkv"]
    with torch.no_grad():
        y, st = ops._wkv(r, k, v, w, u[None], chunk, bf16_intra)
        py, pst = ops.wkv_plain(r, k, v, w, u[None], c, bf16_intra)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["rwkv6_wkv"] == before + 1
    assert y.dtype == dtype and st.shape == (B, H, K, K)
    _wkv_close(y, py, st, pst, bf16_intra)


def test_wkv_pallas_layout_on_the_card(cuda):
    """``wkv_fwd`` ((BH, S, K), a bonus row per (b, h)) against its plain
    version in float32, and the model layout against the same rows."""
    from repro_torch.kernels.rwkv6_wkv import ops

    r, k, v, w, _ = _wkv_inputs(1, 128, 6, 32, torch.float32, torch.float32, cuda, seed=9)
    rows = [t[0].permute(1, 0, 2).contiguous() for t in (r, k, v, w)]   # (6, 128, 32)
    u = torch.randn((6, 32), generator=torch.Generator().manual_seed(1)).to(cuda) * 0.3
    y, st = ops.wkv_fwd(*rows, u, chunk=32)
    py, pst = ops.wkv_plain(*(t[:, :, None] for t in rows), u[:, None], 32, False)
    torch.cuda.synchronize()
    _wkv_close(y, py[:, :, 0], st, pst[:, 0], False)


def test_wkv_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.rwkv6_wkv import ops

    r, k, v, w, u = _wkv_inputs(1, 8, 2, 16, torch.float32, torch.float32, cuda)
    with pytest.raises(ValueError, match="K = 65 > 64"):
        big = [torch.zeros((1, 8, 1, 65), device=cuda) for _ in range(4)]
        ops.wkv_heads(*big, torch.zeros((1, 65), device=cuda), chunk=8)
    with pytest.raises(ValueError, match="chunk 128 > 64"):
        long = [torch.zeros((1, 128, 2, 16), device=cuda) for _ in range(4)]
        ops.wkv_heads(*long, u, chunk=128)
    with pytest.raises(TypeError, match="not supported"):
        ops.wkv_cuda(r.half(), k.half(), v.half(), w, u[None], 8, True)
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv_cuda(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u[None], 8, True)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_rwkv6_on_the_card_matches_the_cpu(cuda, dtype):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, decode_step, forward
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.params import tree_map

    cfg = reduced(get_arch("rwkv6-7b"))
    rt = Runtime(param_dtype=dtype, compute_dtype=dtype)
    host = init_params(build_param_specs(cfg, rt), torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)   # the bonus and the mixes, zero by the init rules
    for blk in ("tmix", "cmix"):
        host["blocks"][blk]["mix"] = (torch.randn(host["blocks"][blk]["mix"].shape, generator=g)
                                      * 0.5).to(host["blocks"][blk]["mix"].dtype)
    host["blocks"]["tmix"]["u_bonus"] = torch.randn(host["blocks"]["tmix"]["u_bonus"].shape,
                                                    generator=g) * 0.5
    card = tree_map(lambda t: t.to(cuda), host)
    tokens = np.random.default_rng(0).integers(2, cfg.vocab, (2, 64))
    counts.reset()
    with torch.no_grad():
        got = forward(card, cfg, rt, tokens=torch.from_numpy(tokens).to(cuda))
        assert counts.LAUNCHES["rwkv6_wkv"] == cfg.n_layers
        assert counts.LAUNCHES["rmsnorm_fwd"] == 3 * cfg.n_layers + 1
        cache = init_cache(cfg, rt, 2, 8, device=cuda)
        lg, cache = decode_step(card, cfg, rt, cache, torch.from_numpy(tokens[:, :1]).to(cuda))
        lg, cache = decode_step(card, cfg, rt, cache, torch.from_numpy(tokens[:, 1:2]).to(cuda))
        assert counts.LAUNCHES["rmsnorm_fwd"] == 3 * (3 * cfg.n_layers + 1)
        assert counts.LAUNCHES["rwkv6_wkv"] == cfg.n_layers
        assert counts.PLAIN_CALLS["rwkv6_wkv"] == counts.PLAIN_CALLS["rmsnorm_fwd"] == 0
        want = forward(host, cfg, rt, tokens=torch.from_numpy(tokens))
        hc = init_cache(cfg, rt, 2, 8, device="cpu")
        hl, hc = decode_step(host, cfg, rt, hc, torch.from_numpy(tokens[:, :1]))
        hl, hc = decode_step(host, cfg, rt, hc, torch.from_numpy(tokens[:, 1:2]))
    # the forward carries bf16 rounding flips through four layers of state
    # (tests/test_torch_ssm.py); decode has none
    fwd_tol, dec_tol = (5e-3, 1e-5) if dtype == "float32" else (5e-2, 5e-2)
    for a, b, tol in ((got, want, fwd_tol), (lg, hl, dec_tol)):
        err = (torch.softmax(a.float().cpu(), -1) - torch.softmax(b.float(), -1)).abs().max()
        assert float(err) < tol, float(err)
    torch.testing.assert_close(cache["wkv"].cpu(), hc["wkv"],
                               atol=(1e-5 if dtype == "float32" else 5e-2)
                               * float(hc["wkv"].abs().max()), rtol=0)


# ---------------------------------------------------------------- K4 at 80

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,offset", FLASH_MASKS)
def test_flash_fwd_at_head_dim_80_matches_plain(cuda, dtype, causal, window, offset):
    """zamba2-2.7b's shared attention has head dim 80; the backward kernels
    take it too."""
    from repro_torch.kernels.flash_attn import ops

    q, k, v = _flash_inputs(3, 128, 128, 1, 80, dtype, cuda, seed=8)
    q_offset = 0
    if offset:
        q = q[:, 64:].contiguous()
        q_offset = 64
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=16, kv_block=32)
    o, lse = ops.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = ops.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(o, o_ref, FLASH_TOL[dtype])
    _close(lse, lse_ref, FLASH_TOL[dtype])
    _check_bwd(q, k, v, kw)


# --------------------------------------------------------------------- K7

def _decode_inputs(B, S, Hkv, G, D, dtype, device, seed=0):
    """q, the cache at scale 1 and lengths 0, S // 3, S and S - 5 cycled over
    the rows."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, Hkv, G, D), generator=g).to(device, dtype)
    k, v = (torch.randn((B, S, Hkv, D), generator=g).to(device, dtype) for _ in range(2))
    lens = torch.tensor([(0, S // 3, S, S - 5)[i % 4] for i in range(B)], dtype=torch.int32,
                        device=device)
    return q, k, v, lens


def _decode_close(got, want):
    """float32: 2e-5 of o's largest magnitude; bfloat16: one bf16 step of it
    (both compute in float32 from the same inputs, then round o once)."""
    scale = float(want.float().abs().max())
    tol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=0)


@pytest.mark.parametrize("S,kv_splits", [(96, 3), (128, 1), (256, 4), (4096, 4), (100, 2)])
@pytest.mark.parametrize("G,D", [(1, 64), (4, 80), (8, 128), (1, 80), (4, 128), (9, 128),
                                 (16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_matches_plain(cuda, S, kv_splits, G, D, dtype):
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_decode import ops, ref

    q, k, v, lens = _decode_inputs(4, S, 2, G, D, dtype, cuda, seed=S + G + D)
    splits, block = ops.split_plan(S, kv_splits, 32)
    before = counts.LAUNCHES["flash_decode"]
    o = ops.decode_attention(q, k, v, lens, kv_splits=kv_splits, kv_block=32)
    assert counts.LAUNCHES["flash_decode"] == before + 1
    want = ops.decode_plain(q, k, v, lens, splits, block)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    _decode_close(o, want)
    _decode_close(o, ref.decode_ref(q, k, v, lens))


def test_flash_decode_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_decode import ops

    with pytest.raises(ValueError, match="D = 192"):
        ops.decode_attention(*_decode_inputs(2, 64, 1, 1, 192, torch.float32, cuda))
    with pytest.raises(TypeError, match="not supported"):
        ops.decode_attention(*_decode_inputs(2, 64, 1, 1, 64, torch.float16, cuda))
    q, k, v, lens = _decode_inputs(3, 128, 2, 4, 64, torch.float32, cuda, seed=2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_cuda(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, lens, 1)


def test_model_decode_flash_route_matches_plain_route(cuda):
    """A reduced llama3-8b decode step on the card: K7 (``flash``) against
    the reference's inline softmax (``xla``), in float32."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, decode_step, init_cache
    from repro_torch.models import init_params

    cfg = reduced(get_arch("llama3-8b"))
    rt = Runtime(param_dtype="float32", compute_dtype="float32")
    params = init_params(build_param_specs(cfg, rt), torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(2, cfg.vocab, (3, 12))).to(cuda)
    out = {}
    for impl in ("xla", "flash"):
        r = dataclasses.replace(rt, attn_impl=impl)
        cache = init_cache(cfg, r, 3, 16, device=cuda)
        counts.reset()
        for t in range(tokens.shape[1]):
            lg, cache = decode_step(params, cfg, r, cache, tokens[:, t:t + 1])
        out[impl] = lg
        assert counts.LAUNCHES["flash_decode"] == (12 * cfg.n_layers if impl == "flash" else 0)
    _decode_close(out["flash"], out["xla"])


# --------------------------------------------------------------------- K8

def _ssd_inputs(B, S, H, P, N, dtype, adtype, device, seed=0):
    """x, B, C at scale 0.5, the log decay -softplus(normal) with a spread of
    rates, as the reference's sweep draws them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x, Bm, Cm = ((torch.randn(s, generator=g) * 0.5).to(device, dtype)
                 for s in ((B, S, H, P), (B, S, H, N), (B, S, H, N)))
    a = -torch.nn.functional.softplus(torch.randn((B, S, H), generator=g))
    return x, Bm, Cm, a.to(device, adtype)


def _ssd_close(y, py, st, pst, model):
    """The state within 2e-5 of its largest magnitude. y with float32
    products: within one bf16 step of its largest magnitude in bfloat16,
    2e-5 in float32. The model's function in bfloat16 rounds the scores and
    both parts of y, so ulp-level differences between the kernel's and the
    plain version's float32 cumsum and exp flip single roundings: at least
    95 % of y within one bf16 step and all within two."""
    sscale = float(pst.abs().max())
    torch.testing.assert_close(st, pst, atol=2e-5 * sscale, rtol=2e-5)
    scale = float(py.float().abs().max())
    bf16 = py.dtype == torch.bfloat16
    tol = 2.0 ** -7 if bf16 else 2e-5
    err = (y.float() - py.float()).abs() / scale
    if not (model and bf16):
        assert float(err.max()) <= tol, float(err.max())
        return
    assert float((err <= tol).float().mean()) >= 0.95
    assert float(err.max()) <= 2 * tol, float(err.max())


# (B, S, H, P, N, chunk): zamba2-2.7b's P = N = 64 at chunk 128 and 64; the
# reduced model's; chunks of 32; S that halves the chunk (96 -> 32, 200 ->
# 8); P and N below 64 and not powers of two
SSD_SHAPES = [(2, 512, 3, 64, 64, 128), (1, 256, 4, 64, 64, 64), (2, 64, 8, 32, 16, 32),
              (1, 96, 2, 32, 16, 64), (2, 200, 2, 24, 40, 128), (1, 33, 3, 64, 64, 128)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype,adtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("model", [False, True])
def test_ssd_matches_plain(cuda, B, S, H, P, N, chunk, dtype, adtype, model):
    from repro_torch.kernels import counts
    from repro_torch.kernels.mamba2_ssd import ops

    x, Bm, Cm, a = _ssd_inputs(B, S, H, P, N, dtype, adtype, cuda, seed=S + P + N)
    c = ops.cut_chunk(chunk, S)
    before = counts.LAUNCHES["mamba2_ssd"]
    y, st = ops._ssd(x, Bm, Cm, a, chunk, model)
    py, pst = ops.ssd_plain(x, Bm, Cm, a, c, model)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["mamba2_ssd"] == before + 1
    assert y.dtype == dtype and st.shape == (B, H, P, N)
    assert bool(torch.isfinite(y.float()).all())
    _ssd_close(y, py, st, pst, model)


def test_ssd_strided_views_and_pallas_layout_on_the_card(cuda):
    """B and C as views of one wider row, as the model splits them; and
    ``ssd_fwd`` in the Pallas layout against the sequential oracle."""
    from repro_torch.kernels.mamba2_ssd import ops, ref

    B, S, H, P, N = 2, 256, 4, 64, 64
    x, Bm, Cm, a = _ssd_inputs(B, S, H, P, N, torch.bfloat16, torch.float32, cuda, seed=3)
    wide = torch.cat([x.reshape(B, S, H * P), Bm.reshape(B, S, H * N), Cm.reshape(B, S, H * N)],
                     -1)
    Bv = wide[..., H * P:H * (P + N)].reshape(B, S, H, N)
    Cv = wide[..., H * (P + N):].reshape(B, S, H, N)
    got = ops.ssd_heads(x, Bv, Cv, a, chunk=128)
    want = ops.ssd_heads(x, Bm, Cm, a, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rows = [t[:, :, 0].contiguous().float() for t in (x, Bm, Cm)]
    y, st = ops.ssd_fwd(*rows, a[:, :, 0].contiguous(), chunk=64)
    yo, so = ref.ssd_ref(*(t[:, :, None] for t in rows), a[:, :, :1].contiguous())
    torch.cuda.synchronize()
    _ssd_close(y, yo[:, :, 0], st, so[:, 0], False)


def test_ssd_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.mamba2_ssd import ops

    x, Bm, Cm, a = _ssd_inputs(1, 64, 2, 32, 16, torch.float32, torch.float32, cuda)
    with pytest.raises(ValueError, match="chunk 256 > 128"):
        ops.ssd_heads(*_ssd_inputs(1, 256, 1, 8, 8, torch.float32, torch.float32, cuda),
                      chunk=256)
    with pytest.raises(ValueError, match="P = 96"):
        ops.ssd_heads(*_ssd_inputs(1, 8, 1, 96, 8, torch.float32, torch.float32, cuda), chunk=8)
    with pytest.raises(TypeError, match="not supported"):
        ops.ssd_cuda(x.half(), Bm.half(), Cm.half(), a, 32, True)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_cuda(x, Bm.transpose(2, 3).contiguous().transpose(2, 3), Cm, a, 32, True)
    x.requires_grad_(True)
    with pytest.raises(NotImplementedError, match="no backward"):
        ops.ssd_heads(x, Bm, Cm, a, chunk=32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_zamba2_on_the_card_matches_the_cpu(cuda, dtype):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, decode_step, forward
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.params import tree_map

    cfg = reduced(get_arch("zamba2-2.7b"))
    rt = Runtime(param_dtype=dtype, compute_dtype=dtype, attn_impl="flash", q_block=32,
                 kv_block=32)
    host = init_params(build_param_specs(cfg, rt), torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)   # the rates, skip and step bias, zero by the init rules
    for name in ("A_log", "D", "dt_bias"):
        leaf = host["blocks"]["mamba"][name]
        host["blocks"]["mamba"][name] = torch.randn(leaf.shape, generator=g) * 0.5
    card = tree_map(lambda t: t.to(cuda), host)
    tokens = np.random.default_rng(0).integers(2, cfg.vocab, (2, 64))
    L, groups = cfg.n_layers, cfg.n_layers // cfg.attn_every
    counts.reset()
    with torch.no_grad():
        got = forward(card, cfg, rt, tokens=torch.from_numpy(tokens).to(cuda))
        assert counts.LAUNCHES["mamba2_ssd"] == L
        assert counts.LAUNCHES["flash_attn_fwd"] == groups
        assert counts.LAUNCHES["rmsnorm_fwd"] == 2 * L + 2 * groups + 1
        cache = init_cache(cfg, rt, 2, 8, device=cuda)
        for t in range(2):
            lg, cache = decode_step(card, cfg, rt, cache, torch.from_numpy(tokens[:, t:t + 1])
                                    .to(cuda))
        assert counts.LAUNCHES["flash_decode"] == 2 * groups
        assert counts.LAUNCHES["mamba2_ssd"] == L
        assert sum(counts.PLAIN_CALLS.values()) == 0
        want = forward(host, cfg, rt, tokens=torch.from_numpy(tokens))
        hc = init_cache(cfg, rt, 2, 8, device="cpu")
        for t in range(2):
            hl, hc = decode_step(host, cfg, rt, hc, torch.from_numpy(tokens[:, t:t + 1]))
    tol = 1e-5 if dtype == "float32" else 5e-2
    for a, b in ((got, want), (lg, hl)):
        err = (torch.softmax(a.float().cpu(), -1) - torch.softmax(b.float(), -1)).abs().max()
        assert float(err) < tol, float(err)
    for key in ("ssm", "conv", "attn_k"):
        torch.testing.assert_close(cache[key].cpu().float(), hc[key].float(),
                                   atol=tol * float(hc[key].float().abs().max()), rtol=0)
