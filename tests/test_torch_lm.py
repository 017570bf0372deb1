"""The LM serving path of the port against the JAX package, on the CPU.

The model is ``reduced(get_arch("llama3-8b"))`` (4 layers, d_model 128, 4
query and 2 KV heads of 32, d_ff 256, vocab 512). The weights are the
reference's ``init_params(..., PRNGKey(0))``, carried over with
``convert.lm_params_from_numpy``; inputs are drawn by numpy from a seed.
The reference's flash route runs its Pallas kernel in interpret mode, as
``tests/test_kernels.py`` runs it; the port's runs the plain version of K4.

Tolerances: in float32 the two packages compute the same operations in
another summation order, so outputs agree to about 1e-5 relative to their
scale (``F32``); in bfloat16 each package rounds to bfloat16 at the same
places but after differently ordered float32 sums, so logits are compared
by their softmax within 5e-2, the bound of ``tests/test_decode_consistency.py``.
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
from repro.kernels.flash_attn.kernel import flash_fwd_pallas
from repro.kernels.flash_attn.ref import attention_ref as j_attention_ref
from repro.models import Runtime as JRuntime
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import build_param_specs as j_specs
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import param_bytes as j_param_bytes
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro.serving.engine import prefill_with_cache as j_prefill
from repro_torch import configs as PC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import counts
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.kernels.flash_attn import ref as flash_ref
from repro_torch.models import Runtime as PRuntime
from repro_torch.models import attention as PA
from repro_torch.models import blocks as PB
from repro_torch.models import build_param_specs as p_specs
from repro_torch.models import decode_step as p_decode
from repro_torch.models import forward as p_forward
from repro_torch.models import init_cache as p_init_cache
from repro_torch.models import init_params as p_init_params
from repro_torch.models import param_bytes as p_param_bytes
from repro_torch.serving import Request as PRequest
from repro_torch.serving import ServingEngine as PEngine
from repro_torch.serving import prefill_with_cache as p_prefill

CPU = torch.device("cpu")
F32 = 1e-5           # float32: relative to the output's scale
SOFTMAX_BOUND = 5e-2  # bfloat16: max softmax difference
ARCH = "llama3-8b"
RT_KW = dict(remat="none", attn_chunk=16, q_block=16, kv_block=16, act_shard=False)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _t(a: np.ndarray, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.asarray(a)).to(dtype)


def _j(a: np.ndarray, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


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


def _runtimes(dtype: str, impl: str = "xla"):
    kw = dict(RT_KW, param_dtype=dtype, compute_dtype=dtype, attn_impl=impl)
    return JRuntime(**kw), PRuntime(**kw)


@functools.cache
def _model(dtype: str):
    """(cfg, reference params, port params) for the reduced llama3-8b; the
    tests read the weights and never write them."""
    cfg = RC.reduced(RC.get_arch(ARCH))
    jrt, _ = _runtimes(dtype)
    jp = j_init_params(j_specs(cfg, jrt), jax.random.PRNGKey(0))
    return cfg, jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, (B, S)).astype(np.int32)


# ---------------------------------------------------------------- configs


@pytest.mark.parametrize("name", sorted(RC.ARCHS))
def test_configs_are_the_reference_configs(name):
    ref, port = RC.get_arch(name), PC.get_arch(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(PC.reduced(port)) == dataclasses.asdict(RC.reduced(ref))
    assert port.param_count() == ref.param_count()


def test_param_specs_and_bytes_match_at_full_width():
    cfg_j, cfg_p = RC.get_arch(ARCH), PC.get_arch(ARCH)
    js, ps = j_specs(cfg_j, JRuntime()), p_specs(cfg_p, PRuntime())
    flat_j = jax.tree.leaves(js, is_leaf=lambda s: hasattr(s, "fan_in_axis"))
    from repro_torch.models.params import tree_leaves

    flat_p = tree_leaves(ps)
    assert [(s.shape, s.axes, s.init, s.fan_in_axis) for s in flat_p] == \
        [(s.shape, s.axes, s.init, s.fan_in_axis) for s in flat_j]
    # bf16: two bytes per parameter; param_count() leaves out the norm gains
    n_norm = (2 * cfg_p.n_layers + 1) * cfg_p.d_model
    assert p_param_bytes(ps) == j_param_bytes(js) == 2 * (cfg_p.param_count() + n_norm)


def test_init_params_rules():
    cfg = PC.reduced(PC.get_arch(ARCH))
    specs = p_specs(cfg, PRuntime(param_dtype="float32"))
    p = p_init_params(specs, torch.Generator().manual_seed(0), CPU)
    assert torch.equal(p["final_ln"], torch.ones(cfg.d_model))
    assert p["blocks"]["ffn"]["w_up"].shape == (cfg.n_layers, cfg.d_model, cfg.d_ff)
    assert abs(float(p["embed"].std()) - 0.02) < 2e-3
    want = 1.0 / np.sqrt(cfg.d_model)
    assert abs(float(p["blocks"]["ffn"]["w_up"].std()) - want) < 0.05 * want
    # same seed, same tensors; bf16 is the float32 draw rounded
    q = p_init_params(p_specs(cfg, PRuntime()), torch.Generator().manual_seed(0), CPU)
    assert torch.equal(q["embed"], p["embed"].to(torch.bfloat16))


@pytest.mark.parametrize("family_arch", ["deepseek-v3-671b", "rwkv6-7b", "zamba2-2.7b",
                                         "seamless-m4t-medium"])
def test_other_families_are_refused_with_their_roadmap_item(family_arch):
    cfg = PC.reduced(PC.get_arch(family_arch))
    scans = {"ssm": "rwkv6_wkv", "hybrid": "mamba2_ssd"}
    if cfg.family in scans:
        # the SSM and hybrid families serve and train: a gradient flows into
        # every leaf through their scans' backward (K12b, K8b; plain here)
        from repro_torch.models import loss_fn as p_loss_fn
        from repro_torch.models.params import tree_leaves

        params = p_init_params(p_specs(cfg, PRuntime()), torch.Generator().manual_seed(0), CPU)
        batch = {"tokens": torch.arange(2, 10, dtype=torch.int32)[None],
                 "labels": torch.arange(3, 11, dtype=torch.int32)[None]}
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        counts.reset()
        loss = p_loss_fn(params, cfg, PRuntime(), batch)
        grads = torch.autograd.grad(loss, leaves)
        assert counts.PLAIN_CALLS[scans[cfg.family] + "_bwd"] == cfg.n_layers
        assert bool(torch.isfinite(loss))
        assert all(bool(torch.isfinite(g).all()) for g in grads)
        return
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 10"):
        p_specs(cfg, PRuntime())
    with pytest.raises(NotImplementedError, match="ROADMAP.md item 10"):
        p_init_cache(cfg, PRuntime(), 1, 8, device="cpu")


def test_bf16_weights_carry_their_bits():
    cfg, jp, pp = _model("bfloat16")
    assert pp["embed"].dtype == torch.bfloat16
    want = np.asarray(jp["embed"]).view(np.int16)
    np.testing.assert_array_equal(pp["embed"].view(torch.int16).numpy(), want)


# ----------------------------------------------------------------- blocks


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rmsnorm(dtype):
    rng = np.random.default_rng(1)
    x, w = rng.standard_normal((2, 5, 64)) * 3, rng.standard_normal(64)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    got = PB.rmsnorm(_t(x, td), _t(w, td), 1e-5)
    want = JB.rmsnorm(_j(x, jd), _j(w, jd), 1e-5)
    assert got.dtype == td
    # float32: one rounding apart; bfloat16: within one bf16 ulp
    tol = 1e-6 if dtype == "float32" else 2 ** -7
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("sections", [None, (16, 24, 24), (4, 6, 6)])
def test_apply_rope(sections):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((2, 24, 3, 32))
    if sections is None:
        pos = rng.integers(0, 500, (2, 24))
    else:
        pos = rng.integers(0, 500, (2, 24, 3))
    got = PB.apply_rope(_t(x), torch.from_numpy(pos.astype(np.int32)), mrope_sections=sections)
    want = JB.apply_rope(_j(x), jnp.asarray(pos, jnp.int32), mrope_sections=sections)
    # sin/cos of angles up to 500 rad: float32 argument reduction differs
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-5, rtol=1e-5)


def test_mrope_positions():
    np.testing.assert_array_equal(PB.mrope_positions(2, 7).numpy(),
                                  np.asarray(JB.mrope_positions(2, 7)))


@pytest.mark.parametrize("act", ["swiglu", "gelu", "sq_relu"])
def test_ffn_apply(act):
    rng = np.random.default_rng(3)
    specs = JB.ffn_specs(64, 96, act)
    w = {k: rng.standard_normal(s.shape) / 8 for k, s in specs.items()}
    x = rng.standard_normal((2, 5, 64))
    got = PB.ffn_apply({k: _t(v) for k, v in w.items()}, _t(x), act)
    want = JB.ffn_apply({k: _j(v) for k, v in w.items()}, _j(x), act)
    _assert_scaled(got, want)


def test_gelu_is_the_tanh_approximation():
    x = np.linspace(-4, 4, 101)
    w = {"w_up": np.eye(101), "w_down": np.eye(101)}
    got = PB.ffn_apply({k: _t(v) for k, v in w.items()}, _t(x)[None], "gelu")
    want = JB.ffn_apply({k: _j(v) for k, v in w.items()}, _j(x)[None], "gelu")
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-6)


# -------------------------------------------------------------- attention


def _attn_weights(cfg, seed=4):
    rng = np.random.default_rng(seed)
    specs = JA.attention_specs(cfg)
    return {k: rng.standard_normal(s.shape) / np.sqrt(cfg.d_model) for k, s in specs.items()}


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("window", [None, 8])
def test_attention_apply(impl, window):
    cfg = dataclasses.replace(RC.reduced(RC.get_arch(ARCH)), window=window)
    pcfg = dataclasses.replace(PC.reduced(PC.get_arch(ARCH)), window=window)
    jrt, prt = _runtimes("float32", impl)
    w = _attn_weights(cfg)
    x = np.random.default_rng(5).standard_normal((2, 32, cfg.d_model))
    pos = np.broadcast_to(np.arange(32, dtype=np.int32), (2, 32))
    got = PA.attention_apply({k: _t(v) for k, v in w.items()}, _t(x), pcfg, prt,
                             torch.from_numpy(pos.copy()))
    want = JA.attention_apply({k: _j(v) for k, v in w.items()}, _j(x), cfg, jrt,
                              jnp.asarray(pos))
    _assert_scaled(got, want)


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (False, None, 0),
                                                    (True, 8, 0), (True, None, 16),
                                                    (False, 8, 16)])
def test_flash_attention_xla_matches_reference(causal, window, q_offset):
    rng = np.random.default_rng(6)
    q = rng.standard_normal((2, 16, 2, 3, 32))
    k = rng.standard_normal((2, 32, 2, 32))
    v = rng.standard_normal((2, 32, 2, 32))
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=8, kv_chunk=8)
    got = PA.flash_attention_xla(_t(q), _t(k), _t(v), **kw)
    want = JA.flash_attention_xla(_j(q), _j(k), _j(v), **kw)
    _assert_scaled(got, want)


# ---------------------------------------------------- K4 and its oracles


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (False, None, 0),
                                                    (True, 16, 0), (True, None, 32)])
def test_flash_fwd_plain_matches_pallas_kernel(dtype, causal, window, q_offset):
    rng = np.random.default_rng(7)
    BH, Sq, Sk, G, D = 3, 32, 32 + q_offset, 2, 16
    q, k, v = (rng.standard_normal(s) for s in ((BH, Sq, G, D), (BH, Sk, D), (BH, Sk, D)))
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=16, kv_block=16)
    counts.reset()
    o, lse = flash_ops.flash_fwd(_t(q, td), _t(k, td), _t(v, td), **kw)
    assert counts.PLAIN_CALLS["flash_attn_fwd"] == 1 and counts.LAUNCHES["flash_attn_fwd"] == 0
    jo, jlse = flash_fwd_pallas(_j(q, jd), _j(k, jd), _j(v, jd), interpret=True, **kw)
    assert o.dtype == td and lse.dtype == torch.float32
    # the tolerances of the reference's tests/test_kernels.py
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(o), _np(jo), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=tol, rtol=tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_plain_rows_with_no_visible_key_match_pallas_kernel(dtype, causal):
    # positions 8..39 over 16 keys with a window of 4: the rows from position
    # 19 on see no key; the reference averages every V row there
    rng = np.random.default_rng(9)
    BH, Sq, Sk, G, D = 2, 32, 16, 2, 16
    q, k, v = (rng.standard_normal(s) for s in ((BH, Sq, G, D), (BH, Sk, D), (BH, Sk, D)))
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    kw = dict(causal=causal, window=4, q_offset=8, q_block=16, kv_block=8)
    o, lse = flash_ops.flash_fwd(_t(q, td), _t(k, td), _t(v, td), **kw)
    jo, jlse = flash_fwd_pallas(_j(q, jd), _j(k, jd), _j(v, jd), interpret=True, **kw)
    assert bool((lse[:, 11:] == -1e30).all())
    tol = 2e-5 if dtype == "float32" else 2e-2
    np.testing.assert_allclose(_np(o), _np(jo), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(lse), _np(jlse), atol=tol, rtol=tol)


@pytest.mark.parametrize("causal,window,q_offset", [(True, None, 0), (False, None, 0),
                                                    (True, 8, 0), (False, 8, 0),
                                                    (True, None, 24), (True, 8, 24)])
def test_plain_blocked_forward_matches_attention_ref(causal, window, q_offset):
    rng = np.random.default_rng(8)
    B, Sq, Sk, Hkv, G, D = 2, 16, 16 + q_offset, 2, 2, 32
    q = _t(rng.standard_normal((B, Sq, Hkv, G, D)))
    k = _t(rng.standard_normal((B, Sk, Hkv, D)))
    v = _t(rng.standard_normal((B, Sk, Hkv, D)))
    got = flash_ops.flash_attention(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                    q_block=8, kv_block=8)
    want = flash_ref.attention_ref(q, k, v, causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=2e-5)
    jwant = j_attention_ref(_j(q.numpy()), _j(k.numpy()), _j(v.numpy()), causal=causal,
                            window=window, q_offset=q_offset)
    np.testing.assert_allclose(want.numpy(), _np(jwant), atol=2e-5, rtol=2e-5)


def test_flash_blocks_refused_as_in_the_reference():
    q = torch.zeros((1, 24, 1, 16))
    k = torch.zeros((1, 24, 16))
    with pytest.raises(ValueError, match="divide"):
        flash_ops.flash_fwd(q, k, k, q_block=16, kv_block=8)
    with pytest.raises(AssertionError):
        flash_fwd_pallas(jnp.zeros((1, 24, 1, 16)), jnp.zeros((1, 24, 16)),
                         jnp.zeros((1, 24, 16)), q_block=16, kv_block=8)


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(impl, dtype):
    cfg, jp, pp = _model(dtype)
    jrt, prt = _runtimes(dtype, impl)
    tokens = _tokens(2, 32, cfg.vocab)
    counts.reset()
    got = p_forward(pp, cfg, prt, tokens=torch.from_numpy(tokens))
    if impl == "flash":
        assert counts.PLAIN_CALLS["flash_attn_fwd"] == cfg.n_layers
    assert got.dtype == getattr(torch, dtype) and got.shape == (2, 32, cfg.vocab)
    want = j_forward(jp, cfg, jrt, tokens=jnp.asarray(tokens))
    if dtype == "float32":
        _assert_scaled(got, want)
    else:
        assert _softmax_err(got, want) < SOFTMAX_BOUND


def test_forward_routes_agree():
    cfg, _, pp = _model("float32")
    tokens = torch.from_numpy(_tokens(2, 32, cfg.vocab, seed=1))
    a = p_forward(pp, cfg, _runtimes("float32", "xla")[1], tokens=tokens)
    b = p_forward(pp, cfg, _runtimes("float32", "flash")[1], tokens=tokens)
    _assert_scaled(a, b)


def test_forward_from_input_embeddings_matches_reference():
    cfg, jp, pp = _model("float32")
    jrt, prt = _runtimes("float32", "flash")
    emb = np.random.default_rng(9).standard_normal((2, 16, cfg.d_model)).astype(np.float32)
    got = p_forward(pp, cfg, prt, inputs_embeds=_t(emb))
    _assert_scaled(got, j_forward(jp, cfg, jrt, inputs_embeds=_j(emb)))


def test_forward_vlm_backbone_matches_reference():
    cfg = RC.reduced(RC.get_arch("qwen2-vl-72b"))
    jrt, prt = _runtimes("float32", "flash")
    jp = j_init_params(j_specs(cfg, jrt), jax.random.PRNGKey(3))
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    tokens = _tokens(1, 16, cfg.vocab, seed=2)
    got = p_forward(pp, PC.reduced(PC.get_arch("qwen2-vl-72b")), prt,
                    tokens=torch.from_numpy(tokens))
    _assert_scaled(got, j_forward(jp, cfg, jrt, tokens=jnp.asarray(tokens)))


# ----------------------------------------------------------------- decode


def _teacher_force(step, cache, tokens, to_input):
    out = []
    for t in range(tokens.shape[1]):
        lg, cache = step(cache, to_input(tokens[:, t:t + 1]))
        out.append(_np(lg[:, 0]))
    return np.stack(out, axis=1), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_logits_and_caches_match_reference(dtype):
    cfg, jp, pp = _model(dtype)
    jrt, prt = _runtimes(dtype)
    tokens = _tokens(2, 12, cfg.vocab, seed=3)
    jstep = jax.jit(lambda c, t: j_decode(jp, cfg, jrt, c, t))
    want, jc = _teacher_force(jstep, j_init_cache(cfg, jrt, 2, 16), tokens, jnp.asarray)
    got, pc = _teacher_force(lambda c, t: p_decode(pp, cfg, prt, c, t),
                             p_init_cache(cfg, prt, 2, 16, device="cpu"), tokens,
                             torch.from_numpy)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    if dtype == "float32":
        _assert_scaled(got, want)
        _assert_scaled(pc["k"], jc["k"])
        _assert_scaled(pc["v"], jc["v"])
    else:
        assert _softmax_err(got, want) < SOFTMAX_BOUND
        # cache entries are bf16 projections: within a few bf16 ulps
        np.testing.assert_allclose(_np(pc["k"]), _np(jc["k"]), atol=5e-2, rtol=5e-2)


def test_ring_buffer_decode_matches_reference():
    """Sliding-window cache (S == window): slots wrap around."""
    cfg = dataclasses.replace(RC.reduced(RC.get_arch(ARCH)), window=8)
    pcfg = dataclasses.replace(PC.reduced(PC.get_arch(ARCH)), window=8)
    _, jp, pp = _model("float32")
    jrt, prt = _runtimes("float32")
    tokens = _tokens(2, 13, cfg.vocab, seed=4)
    jstep = jax.jit(lambda c, t: j_decode(jp, cfg, jrt, c, t))
    want, jc = _teacher_force(jstep, j_init_cache(cfg, jrt, 2, 32), tokens, jnp.asarray)
    got, pc = _teacher_force(lambda c, t: p_decode(pp, pcfg, prt, c, t),
                             p_init_cache(pcfg, prt, 2, 32, device="cpu"), tokens,
                             torch.from_numpy)
    assert pc["k"].shape[2] == 8
    _assert_scaled(got, want)
    _assert_scaled(pc["k"], jc["k"])


def test_prefill_with_cache_matches_reference():
    cfg, jp, pp = _model("float32")
    jrt, prt = _runtimes("float32")
    tokens = _tokens(3, 10, cfg.vocab, seed=6)
    jl, jc = j_prefill(jp, cfg, jrt, j_init_cache(cfg, jrt, 3, 12), jnp.asarray(tokens))
    pl, pc = p_prefill(pp, cfg, prt, p_init_cache(cfg, prt, 3, 12, device="cpu"),
                       torch.from_numpy(tokens))
    _assert_scaled(pl, jl)
    _assert_scaled(pc["k"], jc["k"])
    _assert_scaled(pc["v"], jc["v"])
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_decode_matches_port_forward(dtype):
    cfg, _, pp = _model(dtype)
    _, prt = _runtimes(dtype, "flash")
    tokens = _tokens(1, 16, cfg.vocab, seed=5)
    par = p_forward(pp, cfg, prt, tokens=torch.from_numpy(tokens))
    dec, _ = _teacher_force(lambda c, t: p_decode(pp, cfg, prt, c, t),
                            p_init_cache(cfg, prt, 1, 16, device="cpu"), tokens,
                            torch.from_numpy)
    if dtype == "float32":
        _assert_scaled(dec, par)
    else:
        assert _softmax_err(dec, par) < SOFTMAX_BOUND


# ---------------------------------------------------------------- serving


def test_serving_engine_tokens_match_reference():
    cfg, jp, pp = _model("float32")
    jrt, prt = _runtimes("float32")
    rng = np.random.default_rng(0)
    specs = [(rng.integers(2, cfg.vocab, n).astype(np.int32), m, temp)
             for n, m, temp in [(9, 6, 0.0), (5, 4, 0.0), (7, 6, 0.8), (3, 5, 0.0),
                                (6, 3, 1.2)]]
    jreqs = [JRequest(prompt=p, max_new_tokens=m, temperature=t) for p, m, t in specs]
    preqs = [PRequest(prompt=p, max_new_tokens=m, temperature=t) for p, m, t in specs]
    JEngine(jp, cfg, jrt, batch_size=4, max_len=32, seed=3).generate(jreqs)
    PEngine(pp, cfg, prt, batch_size=4, max_len=32, seed=3).generate(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert [len(r.generated) for r in preqs] == [m for _, m, _ in specs]
    assert all(r.done for r in preqs)


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--device", "cpu", "--requests", "2", "--prompt-len", "4", "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("generated 3 tokens") == 2
