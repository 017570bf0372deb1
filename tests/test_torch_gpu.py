"""Each CUDA kernel of the port against its plain version on the card.

Needs an NVIDIA GPU with nvcc; skipped elsewhere. On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Small shapes and the tuner's real shapes; every comparison of K1-K3 is
exact. K4 (flash-attention forward) is held to the float32 and bfloat16
tolerances of the reference's ``tests/test_kernels.py`` (2e-5, 2e-2), at
small shapes with every mask variant and at the llama3-8b prefill's shape;
the model's flash route is held to its plain blocked route on the card.
K5 and K6 (the backward) are held to the same tolerances over the same
grid, relative to the largest magnitude of each gradient where that
exceeds 1 (a gradient sums over up to Sk keys or Sq * G rows); the flash
autograd function and a reduced ``Trainer`` step on the card are held to
the same on the CPU.
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
                                          (1, 32, 96, 2, 64)])
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

    q, k, v = _flash_inputs(1, 64, 64, 1, 48, torch.float32, cuda)
    lse = torch.zeros((1, 64, 1), device=cuda)
    with pytest.raises(ValueError, match="head dim"):
        ops.flash_dq(q, k, v, q, lse, lse)
    q, k, v = _flash_inputs(1, 64, 64, 1, 64, torch.float32, cuda)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_dkv(q, k, v, q, lse.double(), lse)
    with pytest.raises(ValueError, match="divide"):
        ops.flash_dq(q, k, v, q, lse, lse, kv_block=48)


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
