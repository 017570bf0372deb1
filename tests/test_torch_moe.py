"""The MoE serving path of the port against the JAX package, on the CPU.

The models are ``reduced(get_arch("mixtral-8x22b"))`` (4 layers, d_model
128, 4 query and 2 KV heads of 32, 4 experts top-2 of width 128, vocab
512) and small MoE configurations made from it by hand. Weights and inputs
are drawn by numpy from a seed and fed to both packages, the port's through
``convert.lm_params_from_numpy``. The reference's flash route and its
grouped-matmul kernel run in Pallas interpret mode, as
``tests/test_kernels.py`` runs them; the port runs the plain versions of K4
and K9.

Routing is discrete, so each MoE comparison first requires the port's
``expert_idx`` to be identical to the reference's (``jax.lax.top_k`` over
the float32 router softmax), then compares outputs. Tolerances: the
grouped matmul within ``_tol(dtype) * D`` absolute and ``_tol(dtype)``
relative (``tests/test_kernels.py``); MoE outputs and float32 logits
within 1e-5 of their scale; bfloat16 MoE outputs within 5e-2 of their
scale, and bfloat16 logits by their softmax within 5e-2 (the bound of
``tests/test_decode_consistency.py``).
"""
from __future__ import annotations

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.moe_gmm.kernel import gmm_pallas
from repro.kernels.moe_gmm.ref import gmm_ref
from repro.models import Runtime as JRuntime
from repro.models import build_param_specs as j_specs
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import param_bytes as j_param_bytes
from repro.models.moe import moe_apply as j_moe_apply
from repro.models.moe import moe_specs as j_moe_specs
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import configs as PC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import counts
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models import Runtime as PRuntime
from repro_torch.models import build_param_specs as p_specs
from repro_torch.models import decode_step as p_decode
from repro_torch.models import forward as p_forward
from repro_torch.models import init_cache as p_init_cache
from repro_torch.models import loss_fn as p_loss_fn
from repro_torch.models import param_bytes as p_param_bytes
from repro_torch.models.moe import moe_apply as p_moe_apply
from repro_torch.models.moe import moe_route as p_moe_route
from repro_torch.models import init_params as p_init_params
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serving import Request as PRequest
from repro_torch.serving import ServingEngine as PEngine

CPU = torch.device("cpu")
F32 = 1e-5            # float32: relative to the output's scale
BF16 = 5e-2           # bfloat16 MoE outputs: relative to their scale
SOFTMAX_BOUND = 5e-2  # bfloat16 logits: max softmax difference
ARCH = "mixtral-8x22b"
RT_KW = dict(remat="none", attn_chunk=16, q_block=16, kv_block=16, act_shard=False)
GMM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _port(tree):
    """The port's tensors on the CPU from a tree of jax or numpy arrays."""
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _assert_scaled(got, want, tol=F32):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x scale {scale}"


def _softmax_err(a, b) -> float:
    pa = torch.softmax(torch.from_numpy(_np(a)), dim=-1)
    pb = torch.softmax(torch.from_numpy(_np(b)), dim=-1)
    return float((pa - pb).abs().max())


def _runtimes(dtype: str, impl: str = "xla", **kw):
    kw = dict(RT_KW, param_dtype=dtype, compute_dtype=dtype, attn_impl=impl, **kw)
    return JRuntime(**kw), PRuntime(**kw)


def _cfgs(**kw):
    """(reference config, port config): the reduced mixtral with ``kw``
    replaced (``moe_kw`` replaces fields of its MoEConfig)."""
    moe_kw = kw.pop("moe_kw", {})
    out = []
    for C in (RC, PC):
        cfg = C.reduced(C.get_arch(ARCH))
        out.append(dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, **moe_kw), **kw))
    return tuple(out)


def _np_tree(specs, seed: int):
    """numpy weights for a reference spec tree: ones and zeros as the spec
    says, else a standard normal times 1/sqrt(fan_in) (``scaled``) or 0.02,
    cast to the spec's dtype."""
    rng = np.random.default_rng(seed)

    def one(s):
        if s.init == "ones":
            a = np.ones(s.shape, np.float32)
        elif s.init == "zeros":
            a = np.zeros(s.shape, np.float32)
        else:
            fan_in = s.shape[s.fan_in_axis] if len(s.shape) >= 2 else s.shape[-1]
            scale = 1.0 / np.sqrt(fan_in) if s.init == "scaled" else 0.02
            a = (rng.standard_normal(s.shape) * scale).astype(np.float32)
        return np.asarray(jnp.asarray(a, s.dtype))

    return jax.tree.map(one, specs, is_leaf=lambda s: hasattr(s, "fan_in_axis"))


@functools.cache
def _model(dtype: str, first_dense: int = 0):
    """(cfgs, reference params, port params) of the reduced mixtral; the
    tests read the weights and never write them."""
    jcfg, pcfg = _cfgs(moe_kw=dict(first_dense_layers=first_dense))
    jrt, _ = _runtimes(dtype)
    tree = _np_tree(j_specs(jcfg, jrt), seed=first_dense)
    return (jcfg, pcfg), jax.tree.map(jnp.asarray, tree), _port(tree)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, (B, S)).astype(np.int32)


# ------------------------------------------------------------ grouped matmul


@pytest.mark.parametrize("E,C,D,F", [(2, 32, 48, 24), (3, 40, 64, 40), (4, 20, 200, 72)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("masked", [False, True])
def test_gmm_plain_matches_pallas_kernel_and_ref(E, C, D, F, dtype, masked):
    rng = np.random.default_rng(E * C + D)
    xj = jnp.asarray(rng.standard_normal((E, C, D)), JDT[dtype])
    wj = jnp.asarray(rng.standard_normal((E, D, F)), JDT[dtype])
    gs = np.array([C] + [C // 2] * (E - 1), np.int32) if masked else None
    got = gmm_ops.grouped_matmul(_port(xj), _port(wj),
                                 None if gs is None else torch.from_numpy(gs))
    assert got.dtype == _port(xj).dtype and tuple(got.shape) == (E, C, F)
    gj = None if gs is None else jnp.asarray(gs)
    for want in (gmm_pallas(xj, wj, gj, interpret=True), gmm_ref(xj, wj, gj)):
        np.testing.assert_allclose(_np(got), _np(want), atol=GMM_TOL[dtype] * D,
                                   rtol=GMM_TOL[dtype])
    if masked:
        assert not _np(got)[1:, C // 2:].any()


def test_gmm_group_sizes_past_the_ends():
    """Group sizes of 0 and past C, as ``gmm_ref`` takes them."""
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 10, 16)).astype(np.float32)
    w = rng.standard_normal((3, 16, 8)).astype(np.float32)
    gs = np.array([0, 13, 4], np.int32)
    got = gmm_ops.grouped_matmul(torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(gs))
    want = gmm_ref(jnp.asarray(x), jnp.asarray(w), jnp.asarray(gs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5 * 16, rtol=2e-5)
    assert not got[0].any() and not got[2, 4:].any()


def test_gmm_takes_the_plain_version_on_the_cpu():
    counts.reset()
    x, w = torch.ones((2, 4, 8)), torch.ones((2, 8, 3))
    gmm_ops.grouped_matmul(x, w)
    assert counts.PLAIN_CALLS["moe_gmm"] == 1 and counts.LAUNCHES["moe_gmm"] == 0
    with pytest.raises(ValueError, match="needs tensors on the card"):
        gmm_ops.gmm_cuda(x, w)
    with pytest.raises(TypeError, match="not supported"):
        gmm_ops.gmm_cuda(x.double(), w.double())
    assert counts.LAUNCHES["moe_gmm"] == 0


# ---------------------------------------------------------------- moe_apply


def _j_expert_idx(p, x, cfg):
    """The reference's routing (``moe_apply``, lines 67-69)."""
    logits = jnp.einsum("bsd,de->bse", x.astype(jnp.float32), p["router"].astype(jnp.float32))
    return np.asarray(jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.moe.top_k)[1])


MOE_CASES = {
    "reduced": ({}, {}, {}),
    "capacity_factor_0.5": ({}, {}, dict(capacity_factor=0.5)),
    "zero_router": ({}, {}, {}),
    "shared_sq_relu": (dict(act="sq_relu"), dict(n_shared=1), {}),
}


@pytest.mark.parametrize("case", sorted(MOE_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_moe_apply_matches_reference(case, dtype):
    cfg_kw, moe_kw, rt_kw = MOE_CASES[case]
    jcfg, pcfg = _cfgs(moe_kw=moe_kw, **cfg_kw)
    jrt, prt = _runtimes(dtype, **rt_kw)
    tree = _np_tree(j_moe_specs(jcfg, dtype=JDT[dtype]), seed=7)
    if case == "zero_router":
        tree["router"] = np.zeros_like(tree["router"])
    rng = np.random.default_rng(8)
    x = np.asarray(jnp.asarray(rng.standard_normal((2, 16, jcfg.d_model)), JDT[dtype]))
    jp, jx = jax.tree.map(jnp.asarray, tree), jnp.asarray(x)
    pp, px = _port(tree), _port(x)

    gate_vals, expert_idx, slot, Cr = p_moe_route(pp["router"], px, pcfg, prt)
    np.testing.assert_array_equal(expert_idx.numpy(), _j_expert_idx(jp, jx, jcfg))
    if case == "zero_router":   # ties go to the lower index, as jax.lax.top_k
        assert (expert_idx.numpy() == [0, 1]).all()
    if case in ("capacity_factor_0.5", "zero_router"):
        assert (slot == Cr).any(), "the case must drop tokens"
    got = p_moe_apply(pp, px, pcfg, prt)
    want = j_moe_apply(jp, jx, jcfg, jrt)
    assert got.dtype == px.dtype
    _assert_scaled(got, want, F32 if dtype == "float32" else BF16)


# ------------------------------------------------------------- whole model


def test_param_specs_and_bytes_match_at_full_width():
    jcfg, pcfg = RC.get_arch(ARCH), PC.get_arch(ARCH)
    js, ps = j_specs(jcfg, JRuntime()), p_specs(pcfg, PRuntime())
    flat_j = jax.tree.leaves(js, is_leaf=lambda s: hasattr(s, "fan_in_axis"))
    flat_p = tree_leaves(ps)
    assert [(s.shape, s.axes, s.init, s.fan_in_axis, str(s.dtype).split(".")[-1])
            for s in flat_p] == \
        [(s.shape, s.axes, s.init, s.fan_in_axis, jnp.dtype(s.dtype).name) for s in flat_j]
    assert p_param_bytes(ps) == j_param_bytes(js)
    assert ps["blocks"]["moe"]["router"].dtype == torch.float32
    assert ps["blocks"]["moe"]["w_up"].shape == (56, 8, 6144, 16384)


def test_convert_carries_the_moe_tree():
    (jcfg, _), jp, pp = _model("bfloat16")
    moe = pp["blocks"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert all(moe[k].dtype == torch.bfloat16 for k in ("w_gate", "w_up", "w_down"))
    for k in ("w_gate", "w_down"):
        want = np.asarray(jp["blocks"]["moe"][k]).view(np.int16)
        np.testing.assert_array_equal(moe[k].view(torch.int16).numpy(), want)
    np.testing.assert_array_equal(moe["router"].numpy(), np.asarray(jp["blocks"]["moe"]["router"]))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(impl, dtype):
    """At S = 32 with the window overridden to 8, so the window masks."""
    (jcfg, pcfg), jp, pp = _model(dtype)
    jcfg, pcfg = (dataclasses.replace(c, window=8) for c in (jcfg, pcfg))
    jrt, prt = _runtimes(dtype, impl)
    tokens = _tokens(2, 32, jcfg.vocab, seed=1)
    want = j_forward(jp, jcfg, jrt, tokens=jnp.asarray(tokens))
    counts.reset()
    got = p_forward(pp, pcfg, prt, tokens=torch.from_numpy(tokens))
    assert counts.PLAIN_CALLS["moe_gmm"] == 3 * pcfg.n_layers
    if dtype == "float32":
        _assert_scaled(got, want)
    else:
        assert _softmax_err(got, want) < SOFTMAX_BOUND


def test_forward_with_a_leading_dense_layer_matches_reference():
    (jcfg, pcfg), jp, pp = _model("float32", first_dense=1)
    assert set(pp) >= {"dense_blocks", "blocks"} and pp["blocks"]["ln1"].shape[0] == 3
    jrt, prt = _runtimes("float32")
    tokens = _tokens(2, 16, jcfg.vocab, seed=2)
    want = j_forward(jp, jcfg, jrt, tokens=jnp.asarray(tokens))
    _assert_scaled(p_forward(pp, pcfg, prt, tokens=torch.from_numpy(tokens)), want)


def _teacher_force(step, cache, tokens, to_input):
    out = []
    for t in range(tokens.shape[1]):
        lg, cache = step(cache, to_input(tokens[:, t:t + 1]))
        out.append(_np(lg[:, 0]))
    return np.stack(out, axis=1), cache


@pytest.mark.parametrize("dtype,first_dense", [("float32", 0), ("bfloat16", 0),
                                               ("float32", 1)])
def test_decode_step_logits_and_caches_match_reference(dtype, first_dense):
    (jcfg, pcfg), jp, pp = _model(dtype, first_dense)
    jrt, prt = _runtimes(dtype)
    tokens = _tokens(2, 10, jcfg.vocab, seed=3)
    jstep = jax.jit(lambda c, t: j_decode(jp, jcfg, jrt, c, t))
    want, jc = _teacher_force(jstep, j_init_cache(jcfg, jrt, 2, 16), tokens, jnp.asarray)
    counts.reset()
    got, pc = _teacher_force(lambda c, t: p_decode(pp, pcfg, prt, c, t),
                             p_init_cache(pcfg, prt, 2, 16, device="cpu"), tokens,
                             torch.from_numpy)
    assert counts.PLAIN_CALLS["moe_gmm"] == 3 * (pcfg.n_layers - first_dense) * 10
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    if dtype == "float32":
        _assert_scaled(got, want)
        _assert_scaled(pc["k"], jc["k"])
        _assert_scaled(pc["v"], jc["v"])
    else:
        assert _softmax_err(got, want) < SOFTMAX_BOUND
        np.testing.assert_allclose(_np(pc["k"]), _np(jc["k"]), atol=5e-2, rtol=5e-2)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_decode_matches_port_forward_when_no_token_is_dropped(dtype):
    """With capacity E/K per row no assignment is dropped, so the forward
    and the decode path compute one function (at the configuration's 1.25
    the forward may drop what decode, one token at a time, keeps)."""
    (_, pcfg), _, pp = _model(dtype)
    _, prt = _runtimes(dtype, "flash",
                       capacity_factor=pcfg.moe.n_experts / pcfg.moe.top_k)
    tokens = _tokens(1, 16, pcfg.vocab, seed=5)
    par = p_forward(pp, pcfg, prt, tokens=torch.from_numpy(tokens))
    dec, _ = _teacher_force(lambda c, t: p_decode(pp, pcfg, prt, c, t),
                            p_init_cache(pcfg, prt, 1, 16, device="cpu"), tokens,
                            torch.from_numpy)
    if dtype == "float32":
        _assert_scaled(dec, par)
    else:
        assert _softmax_err(dec, par) < SOFTMAX_BOUND


def test_serving_engine_tokens_match_reference():
    (jcfg, pcfg), jp, pp = _model("float32")
    jrt, prt = _runtimes("float32")
    rng = np.random.default_rng(0)
    specs = [(rng.integers(2, jcfg.vocab, n).astype(np.int32), m, temp)
             for n, m, temp in [(9, 6, 0.0), (5, 4, 0.0), (7, 6, 0.8), (3, 5, 0.0),
                                (6, 3, 1.2)]]
    jreqs = [JRequest(prompt=p, max_new_tokens=m, temperature=t) for p, m, t in specs]
    preqs = [PRequest(prompt=p, max_new_tokens=m, temperature=t) for p, m, t in specs]
    JEngine(jp, jcfg, jrt, batch_size=4, max_len=32, seed=3).generate(jreqs)
    PEngine(pp, pcfg, prt, batch_size=4, max_len=32, seed=3).generate(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert all(r.done for r in preqs)


def test_serve_launcher_runs_mixtral_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--prompt-len", "4",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("generated 3 tokens") == 2 and "mixtral-8x22b (reduced)" in out


# ------------------------------------------- what this slice opened (MLA, training)


def test_mla_is_refused_with_its_roadmap_item():
    """MLA was refused until deepseek-v3 was ported: its specs, cache,
    forward and decode now run at the reduced model (held against the
    reference in ``tests/test_torch_mla.py``)."""
    cfg = PC.reduced(PC.get_arch("deepseek-v3-671b"))
    rt = PRuntime(param_dtype="float32", compute_dtype="float32", attn_chunk=16)
    params = p_init_params(p_specs(cfg, rt), torch.Generator().manual_seed(0), CPU)
    assert "mtp" in params and "w_uk" in params["blocks"]["attn"]
    cache = p_init_cache(cfg, rt, 1, 8, device="cpu")
    assert set(cache) == {"c_kv", "k_rope", "pos"}
    tokens = torch.arange(2, 6, dtype=torch.int32)[None]
    logits = p_forward(params, cfg, rt, tokens=tokens)
    step, cache = p_decode(params, cfg, rt, cache, tokens[:, :1])
    assert logits.shape == (1, 4, cfg.vocab) and step.shape == (1, 1, cfg.vocab)
    assert bool(torch.isfinite(logits).all()) and int(cache["pos"][0]) == 1


def test_moe_training_is_refused_with_its_roadmap_item():
    """Training the MoE family was refused until K9 had a backward: the loss
    now trains every leaf through K9b's plain version (held against the
    reference in ``tests/test_torch_train_moe.py``)."""
    (_, pcfg), _, pp = _model("float32")
    batch = {"tokens": torch.arange(2, 10, dtype=torch.int32)[None],
             "labels": torch.arange(3, 11, dtype=torch.int32)[None]}
    params = tree_map(lambda t: t.detach().clone().requires_grad_(True), pp)
    leaves = tree_leaves(params)
    counts.reset()
    loss = p_loss_fn(params, pcfg, _runtimes("float32")[1], batch)
    grads = torch.autograd.grad(loss, leaves)
    assert counts.PLAIN_CALLS["moe_gmm_bwd"] == 3 * pcfg.n_layers
    assert bool(torch.isfinite(loss)) and all(bool(torch.isfinite(g).all()) for g in grads)
    assert all(bool(g.abs().max() > 0) for g in grads)


def test_gmm_checks_its_arguments_on_both_routes():
    """The CPU route refuses what the kernel refuses, so a layout the card
    would refuse shows on the CPU too."""
    x, w = torch.ones((2, 6, 4)), torch.ones((2, 4, 3))
    with pytest.raises(ValueError, match="contiguous"):
        gmm_ops.grouped_matmul(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(ValueError, match="shape"):
        gmm_ops.grouped_matmul(x, torch.ones((2, 5, 3)))
    with pytest.raises(TypeError, match="dtype"):
        gmm_ops.grouped_matmul(x, w.to(torch.bfloat16))


def test_gmm_refuses_inputs_that_need_a_gradient():
    """K9 had no backward, so inputs that needed a gradient were refused; now
    ``grouped_matmul`` gives them one through K9b's plain version on the
    CPU, and under ``torch.no_grad()`` returns a tensor without a graph."""
    x, w = torch.ones((2, 4, 8)), torch.ones((2, 8, 3))
    for xg, wg in ((x.clone().requires_grad_(True), w), (x, w.clone().requires_grad_(True))):
        counts.reset()
        out = gmm_ops.grouped_matmul(xg, wg, torch.tensor([4, 2]))
        out.sum().backward()
        assert counts.PLAIN_CALLS["moe_gmm_bwd"] == 1
        if xg.requires_grad:
            assert torch.equal(xg.grad[0], torch.full((4, 8), 3.0))
            assert torch.equal(xg.grad[1, :2], torch.full((2, 8), 3.0))
            assert not xg.grad[1, 2:].any() and wg.grad is None
        else:
            assert torch.equal(wg.grad[0], torch.full((8, 3), 4.0))
            assert torch.equal(wg.grad[1], torch.full((8, 3), 2.0))
        with torch.no_grad():
            assert not gmm_ops.grouped_matmul(xg, wg).requires_grad
