"""The dense-LM training path of the port against the JAX package, on the CPU.

The model is ``reduced(get_arch("llama3-8b"))`` (4 layers, d_model 128, 4
query and 2 KV heads of 32, d_ff 256, vocab 512) with the reference's
weights from ``init_params(..., PRNGKey(0))``, carried over with
``convert.lm_params_from_numpy``; inputs are drawn by numpy from a seed.
The reference's flash route runs its Pallas kernels in interpret mode, as
``tests/test_kernels.py`` runs them; the port's runs the plain versions of
K4-K6 (a CPU tensor takes them).

Tolerances, each relative to the largest magnitude of the reference's
result (``_assert_scaled``): in float32 both packages compute the same
operations in another summation order, so values and gradients agree to
about 1e-5 (``F32``); the backward kernels' plain versions against the
Pallas kernels to 2e-5 (the float32 tolerance of ``tests/test_kernels.py``)
and, in bfloat16, to 2e-2 (its bf16 tolerance). In bfloat16 the two
packages round to bfloat16 at the same places but after differently ordered
float32 sums, and a gradient passes through every layer's roundings: losses
agree within 5e-3 and every gradient leaf within 5e-2 of its largest
magnitude (``BF16_GRAD``), where a wrong formula moves it by O(1).
"""
from __future__ import annotations

import dataclasses
import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.data import SyntheticTokenPipeline as JPipeline
from repro.kernels.flash_attn import ops as j_flash_ops
from repro.kernels.flash_attn.kernel import flash_dkv_pallas, flash_dq_pallas
from repro.models import Runtime as JRuntime
from repro.models import attention as JA
from repro.models import build_param_specs as j_specs
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.models.model import chunked_ce as j_chunked_ce
from repro.optim import adamw_init as j_adamw_init
from repro.optim import adamw_update as j_adamw_update
from repro.train.checkpoint import CheckpointManager as JCheckpoint
from repro.train.step import make_train_step as j_make_train_step
from repro.train.trainer import Trainer as JTrainer
from repro_torch import configs as PC
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.data import SyntheticTokenPipeline as PPipeline
from repro_torch.kernels import counts
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import Runtime as PRuntime
from repro_torch.models import attention as PA
from repro_torch.models import chunked_ce as p_chunked_ce
from repro_torch.models import loss_fn as p_loss_fn
from repro_torch.models.params import tree_leaves
from repro_torch.optim import AdamWState, adamw_init, adamw_update
from repro_torch.optim import cosine_schedule, linear_warmup_cosine
from repro_torch.train import make_train_step
from repro_torch.train.checkpoint import CheckpointManager as PCheckpoint
from repro_torch.train.trainer import Trainer as PTrainer

CPU = torch.device("cpu")
F32 = 1e-5
KERNEL_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
BF16_LOSS = 5e-3
BF16_GRAD = 5e-2
ARCH = "llama3-8b"
RT_KW = dict(remat="none", attn_chunk=16, q_block=16, kv_block=16, act_shard=False)


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32) -> torch.Tensor:
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(np.asarray(a, np.float32), dtype)


def _assert_scaled(got, want, tol=F32):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x scale {scale}"


def _runtimes(dtype: str, impl: str = "xla", **extra):
    kw = dict(RT_KW, param_dtype=dtype, compute_dtype=dtype, attn_impl=impl, **extra)
    return JRuntime(**kw), PRuntime(**kw)


def _cfgs():
    return RC.reduced(RC.get_arch(ARCH)), PC.reduced(PC.get_arch(ARCH))


def _ref_params(dtype: str, seed: int = 0):
    """The reference's parameter tree (jax arrays) for the reduced model."""
    jrt, _ = _runtimes(dtype)
    return j_init_params(j_specs(_cfgs()[0], jrt), jax.random.PRNGKey(seed))


def _port(tree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _batch(B, S, vocab, seed=0):
    toks = np.random.default_rng(seed).integers(2, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


# --------------------------------------------- K5/K6 against the Pallas kernels


@pytest.mark.parametrize("dtype,causal,window,q_offset,Sk,q_block,kv_block", [
    ("float32", True, None, 0, 32, 16, 8), ("float32", False, None, 0, 32, 32, 16),
    ("float32", True, 8, 16, 48, 8, 16), ("bfloat16", True, None, 16, 48, 16, 16),
    # positions 8..39 over 16 keys, window 4: rows from position 19 on see
    # no key, so lse is -1e30 and the reference gives every key p = 1
    ("float32", True, 4, 8, 16, 16, 8), ("bfloat16", False, 4, 8, 16, 32, 16),
])
def test_flash_backward_plain_matches_pallas_kernels(dtype, causal, window, q_offset, Sk,
                                                     q_block, kv_block):
    # o and lse from the port's forward (held to the Pallas forward by
    # tests/test_torch_lm.py), delta = sum(do * o) as ``_flash_bwd`` takes it
    rng = np.random.default_rng(11)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    q, k, v, do = (_t(rng.standard_normal(s), td) for s in
                   ((2, 32, 2, 16), (2, Sk, 16), (2, Sk, 16), (2, 32, 2, 16)))
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=q_block,
              kv_block=kv_block)
    o, lse = flash_ops.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(dim=-1)
    args = [_j(_np(a), jd) for a in (q, k, v, do)] + [_j(_np(lse)), _j(_np(delta))]
    jdq = flash_dq_pallas(*args, interpret=True, **kw)
    jdk, jdv = flash_dkv_pallas(*args, interpret=True, **kw)
    counts.reset()
    dq = flash_ops.flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = flash_ops.flash_dkv(q, k, v, do, lse, delta, **kw)
    assert counts.PLAIN_CALLS["flash_attn_dq"] == counts.PLAIN_CALLS["flash_attn_dkv"] == 1
    assert counts.LAUNCHES["flash_attn_dq"] == counts.LAUNCHES["flash_attn_dkv"] == 0
    assert (dq.dtype, dk.dtype, dv.dtype) == (td, td, td)
    if window == 4:
        assert bool((lse[:, 22:] == -1e30).all())
    tol = KERNEL_TOL[dtype]
    for got, want in ((dq, jdq), (dk, jdk), (dv, jdv)):
        np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)


def test_flash_backward_blocks_refused_as_in_the_reference():
    q = torch.zeros((1, 24, 1, 16))
    k = torch.zeros((1, 24, 16))
    lse = torch.zeros((1, 24, 1))
    with pytest.raises(ValueError, match="divide"):
        flash_ops.flash_dq(q, k, k, q, lse, lse, q_block=16, kv_block=8)
    with pytest.raises(ValueError, match="divide"):
        flash_ops.flash_dkv(q, k, k, q, lse, lse, q_block=16, kv_block=8)


# ------------------------------------------------------ attention gradients


def _attn_inputs(B, Sq, Sk, Hkv, G, D, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((B, Sq, Hkv, G, D)), rng.standard_normal((B, Sk, Hkv, D)),
            rng.standard_normal((B, Sk, Hkv, D)), rng.standard_normal((B, Sq, Hkv, G, D)))


def _port_grads(fn, arrays, td):
    ts = [_t(a, td).requires_grad_(True) for a in arrays[:3]]
    out = fn(*ts)
    out.backward(_t(arrays[3], td))
    return out, [t.grad for t in ts]


def _ref_grads(fn, arrays, jd):
    def out_and_vjp(q, k, v, do):
        out, vjp = jax.vjp(fn, q, k, v)
        return out, vjp(do)

    return jax.jit(out_and_vjp)(*[_j(a, jd) for a in arrays])


@pytest.mark.parametrize("dtype,causal,window,q_offset", [
    ("float32", True, None, 0), ("float32", False, 8, 16), ("bfloat16", True, 8, 16)])
def test_flash_autograd_matches_reference_vjp(dtype, causal, window, q_offset):
    arrays = _attn_inputs(2, 32, 32 + q_offset, 2, 2, 16, seed=12)
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=16, kv_block=16)
    counts.reset()
    out, grads = _port_grads(lambda q, k, v: flash_ops.flash_attention(q, k, v, **kw), arrays,
                             getattr(torch, dtype))
    assert counts.PLAIN_CALLS["flash_attn_dq"] == counts.PLAIN_CALLS["flash_attn_dkv"] == 1
    jout, jgrads = _ref_grads(lambda q, k, v: j_flash_ops.flash_attention(
        q, k, v, interpret=True, **kw), arrays, getattr(jnp, dtype))
    tol = F32 if dtype == "float32" else KERNEL_TOL[dtype]
    _assert_scaled(out, jout, tol)
    for got, want in zip(grads, jgrads):
        _assert_scaled(got, want, tol)


@pytest.mark.parametrize("dtype,causal,window,q_offset", [
    ("float32", True, None, 0), ("float32", False, None, 0), ("float32", True, 8, 0),
    ("float32", False, 8, 16), ("bfloat16", True, 8, 16)])
def test_xla_route_backward_matches_reference_vjp(dtype, causal, window, q_offset):
    arrays = _attn_inputs(2, 32, 32 + q_offset, 2, 3, 16, seed=13)
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_chunk=8, kv_chunk=16)
    out, grads = _port_grads(lambda q, k, v: PA.flash_attention_xla(q, k, v, **kw), arrays,
                             getattr(torch, dtype))
    jout, jgrads = _ref_grads(lambda q, k, v: JA.flash_attention_xla(q, k, v, **kw), arrays,
                              getattr(jnp, dtype))
    assert [g.dtype for g in grads] == [getattr(torch, dtype)] * 3
    tol = F32 if dtype == "float32" else KERNEL_TOL[dtype]
    _assert_scaled(out, jout, tol)
    for got, want in zip(grads, jgrads):
        _assert_scaled(got, want, tol)


def test_xla_route_keeps_only_its_residuals():
    """The custom backward saves q, k, v, out and lse, not every block's p."""
    arrays = _attn_inputs(1, 64, 64, 2, 2, 16, seed=14)
    ts = [_t(a).requires_grad_(True) for a in arrays[:3]]
    saved = []
    with torch.autograd.graph.saved_tensors_hooks(lambda t: saved.append(t.numel()) or t,
                                                  lambda t: t):
        PA.flash_attention_xla(*ts, q_chunk=16, kv_chunk=16)
    q_numel = arrays[0].size
    assert sorted(saved) == sorted([q_numel, arrays[1].size, arrays[2].size, q_numel,
                                    q_numel // 16])


# ------------------------------------------------------------------- loss


@pytest.mark.parametrize("dtype,S,chunk", [("float32", 32, 8), ("float32", 24, 16),
                                           ("bfloat16", 24, 16)])
def test_chunked_ce_value_and_grads_match_reference(dtype, S, chunk):
    rng = np.random.default_rng(15)
    x, w = rng.standard_normal((2, S, 64)), rng.standard_normal((96, 64)) / 8
    labels = rng.integers(0, 96, (2, S)).astype(np.int32)
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    xt, wt = _t(x, td).requires_grad_(True), _t(w, td).requires_grad_(True)
    loss = p_chunked_ce(xt, wt, torch.from_numpy(labels), chunk=chunk)
    loss.backward()
    jloss, (jgx, jgw) = jax.jit(jax.value_and_grad(
        lambda a, b: j_chunked_ce(a, b, jnp.asarray(labels), chunk=chunk), (0, 1)))(
        _j(x, jd), _j(w, jd))
    assert loss.dtype == torch.float32 and xt.grad.dtype == td and wt.grad.dtype == td
    if dtype == "float32":
        assert abs(float(loss) - float(jloss)) <= F32 * abs(float(jloss))
        _assert_scaled(xt.grad, jgx)
        _assert_scaled(wt.grad, jgw)
    else:
        # the logits are exact float32 products of the same bf16 inputs
        assert abs(float(loss) - float(jloss)) <= F32 * abs(float(jloss))
        _assert_scaled(xt.grad, jgx, 2 ** -7)
        _assert_scaled(wt.grad, jgw, 2 ** -7)


def test_chunked_ce_is_the_mean_token_cross_entropy():
    rng = np.random.default_rng(16)
    x, w = _t(rng.standard_normal((2, 12, 32))), _t(rng.standard_normal((40, 32)))
    labels = torch.from_numpy(rng.integers(0, 40, (2, 12)))
    want = torch.nn.functional.cross_entropy((x @ w.t()).reshape(-1, 40), labels.reshape(-1))
    assert abs(float(p_chunked_ce(x, w, labels, chunk=5)) - float(want)) < 1e-5


@functools.cache
def _ref_loss_and_grads(dtype: str, impl: str):
    """The reference's loss and gradients (numpy) on one batch."""
    cfg = _cfgs()[0]
    jrt, _ = _runtimes(dtype, impl)
    jp = _ref_params(dtype)
    toks, labels = _batch(2, 32, cfg.vocab, seed=17)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(p, cfg, jrt, batch)))(jp)
    return float(loss), [_np(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("impl,dtype", [("xla", "float32"), ("flash", "float32"),
                                        ("flash", "bfloat16")])
def test_loss_fn_value_and_grads_match_reference(impl, dtype):
    cfg = _cfgs()[1]
    _, prt = _runtimes(dtype, impl)
    params = _port(_ref_params(dtype))
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    toks, labels = _batch(2, 32, cfg.vocab, seed=17)
    counts.reset()
    loss = p_loss_fn(params, cfg, prt, {"tokens": torch.from_numpy(toks),
                                        "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, leaves)
    if impl == "flash":
        for k in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
            assert counts.PLAIN_CALLS[k] == cfg.n_layers and counts.LAUNCHES[k] == 0
    jloss, jgrads = _ref_loss_and_grads(dtype, impl)
    assert [g.dtype for g in grads] == [p.dtype for p in leaves]
    if dtype == "float32":
        assert abs(float(loss) - jloss) <= F32 * jloss
        for got, want in zip(grads, jgrads):
            _assert_scaled(got, want)
    else:
        assert abs(float(loss) - jloss) <= BF16_LOSS
        for got, want in zip(grads, jgrads):
            _assert_scaled(got, want, BF16_GRAD)


def test_loss_fn_routes_agree():
    cfg = _cfgs()[1]
    params = _port(_ref_params("float32"))
    toks, labels = _batch(2, 32, cfg.vocab, seed=18)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    leaves = tree_leaves(params)
    out = []
    for impl in ("xla", "flash"):
        for p in leaves:
            p.requires_grad_(True)
        loss = p_loss_fn(params, cfg, _runtimes("float32", impl)[1], batch)
        out.append((loss, torch.autograd.grad(loss, leaves)))
    assert abs(float(out[0][0]) - float(out[1][0])) <= F32 * float(out[0][0])
    for a, b in zip(out[0][1], out[1][1]):
        _assert_scaled(b, a)


def test_loss_fn_refuses_what_is_not_ported():
    cfg = _cfgs()[1]
    params = _port(_ref_params("float32"))
    batch = {"tokens": torch.zeros((1, 8), dtype=torch.int32),
             "labels": torch.zeros((1, 8), dtype=torch.int32)}
    # remat, refused until it was ported, recomputes each layer and gives the
    # loss that remat="none" gives (tests/test_torch_remat.py holds it)
    rt = _runtimes("float32")[1]
    assert torch.equal(p_loss_fn(params, cfg, dataclasses.replace(rt, remat="full"), batch),
                       p_loss_fn(params, cfg, rt, batch))
    # a config without an mtp subtree ignores mtp_depth, as the reference does
    jcfg = dataclasses.replace(_cfgs()[0], mtp_depth=1)
    jb = {k: jnp.asarray(v.numpy()) for k, v in batch.items()}
    want = float(j_loss_fn(_ref_params("float32"), jcfg, _runtimes("float32")[0], jb))
    got = float(p_loss_fn(params, dataclasses.replace(cfg, mtp_depth=1), _runtimes("float32")[1],
                          batch))
    assert abs(got - want) <= F32 * want
    # gradient compression, refused until it was ported, builds a step
    # (tests/test_torch_compression.py holds its steps to the reference)
    assert callable(make_train_step(cfg, PRuntime(grad_compression="int8")))


# ------------------------------------------------------------------ AdamW


def _tree(rng, dtype):
    return {"a": rng.standard_normal((3, 17)).astype(np.float32),
            "b": {"c": rng.standard_normal(40).astype(np.float32),
                  "d": (rng.standard_normal((2, 5)) * 1e-3).astype(np.float32)}}


@pytest.mark.parametrize("pdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("sdtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("clip", [1.0, None, 1e-3])
def test_adamw_update_matches_reference(pdtype, sdtype, clip):
    """Three updates; float32 state agrees to float32 rounding (1e-6 of the
    parameters' scale), bf16 state or parameters to one bf16 step."""
    rng = np.random.default_rng(19)
    jd, td = getattr(jnp, pdtype), getattr(torch, pdtype)
    jsd, tsd = getattr(jnp, sdtype), getattr(torch, sdtype)
    p0 = _tree(rng, pdtype)
    jp = jax.tree.map(lambda a: _j(a, jd), p0)
    pp = _port(jp)
    jst, pst = j_adamw_init(jp, dtype=jsd), adamw_init(pp, dtype=tsd)
    for step in range(3):
        g = _tree(rng, pdtype)
        jp, jst = j_adamw_update(jp, jax.tree.map(lambda a: _j(a, jd), g), jst, lr=1e-2,
                                 clip_norm=clip)
        pp, pst = adamw_update(pp, _port(jax.tree.map(lambda a: _j(a, jd), g)), pst, lr=1e-2,
                               clip_norm=clip)
    assert int(pst.step) == int(jst.step) == 3 and pst.step.dtype == torch.int32
    tol = 1e-6 if pdtype == sdtype == "float32" else 2 ** -7
    for got, want in zip(tree_leaves(pp), jax.tree.leaves(jp)):
        assert got.dtype == td
        _assert_scaled(got, want, tol)
    for got, want in zip(tree_leaves(pst.m) + tree_leaves(pst.v),
                         jax.tree.leaves(jst.m) + jax.tree.leaves(jst.v)):
        assert got.dtype == tsd
        _assert_scaled(got, want, tol if sdtype == "float32" else 2 ** -7)


def test_adamw_update_is_in_place_in_slices(monkeypatch):
    from repro_torch.optim import adamw as adamw_mod

    rng = np.random.default_rng(20)
    p = {"w": _t(rng.standard_normal(1000))}
    g = {"w": _t(rng.standard_normal(1000))}
    whole, _ = adamw_update({"w": p["w"].clone()}, g, adamw_init(p), lr=1e-2)
    monkeypatch.setattr(adamw_mod, "_SLICE", 64)
    st = adamw_init(p)
    ptr = p["w"].data_ptr()
    out, st2 = adamw_update(p, g, st, lr=1e-2)
    assert out["w"].data_ptr() == ptr and st2.m is st.m
    assert torch.equal(out["w"], whole["w"])


def test_schedules():
    from repro.optim import cosine_schedule as jcos
    from repro.optim import linear_warmup_cosine as jwarm

    for step in (0, 3, 10, 57, 100, 140):
        assert abs(cosine_schedule(step, 3e-4, 100) - float(jcos(step, 3e-4, 100))) < 1e-10
        assert abs(linear_warmup_cosine(step, 3e-4, 10, 100)
                   - float(jwarm(step, 3e-4, 10, 100))) < 1e-10


# ------------------------------------------------------------------- data


@pytest.mark.parametrize("kw", [dict(vocab=512, seq_len=32, global_batch=4, seed=0),
                                dict(vocab=128256, seq_len=64, global_batch=2, seed=3),
                                dict(vocab=1000, seq_len=16, global_batch=6, seed=1,
                                     host_index=1, host_count=3)])
def test_pipeline_batches_are_identical(kw):
    jp, pp = JPipeline(**kw), PPipeline(**kw)
    for _ in range(3):
        a, b = next(jp), next(pp)
        assert a.keys() == b.keys()
        for k in a:
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
    pp.skip_to(9)
    np.testing.assert_array_equal(next(pp)["tokens"], jp.batch_at(9)["tokens"])
    assert pp.state() == {"step": 10}


# ------------------------------------------------------------------ steps


def test_train_steps_match_reference():
    """Three ``make_train_step`` steps in float32: losses to F32, parameters
    to 1e-6 of their scale (Adam divides by sqrt(v): where a gradient is
    near eps, float32 noise in it moves that parameter's update by up to a
    few hundredths of lr, so the bound is 0.1 x lr x steps absolute)."""
    cfgj, cfgp = _cfgs()
    jrt, prt = _runtimes("float32", "flash")
    jp = _ref_params("float32")
    pp = _port(jp)
    jst = j_adamw_init(jp)
    pst = adamw_init(pp)
    jstep = jax.jit(j_make_train_step(cfgj, jrt, lr=1e-3))
    pstep = make_train_step(cfgp, prt, lr=1e-3)
    pipe = JPipeline(cfgj.vocab, 16, 2, seed=5)
    for _ in range(3):
        b = next(pipe)
        jp, jst, jm = jstep(jp, jst, {k: jnp.asarray(v) for k, v in b.items()})
        pp, pst, pm = pstep(pp, pst, {k: torch.from_numpy(v) for k, v in b.items()})
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= F32 * float(jm["loss"])
    for got, want in zip(tree_leaves(pp), jax.tree.leaves(jp)):
        np.testing.assert_allclose(_np(got), _np(want), atol=0.1 * 1e-3 * 3, rtol=0)
    assert not any(p.requires_grad for p in tree_leaves(pp))


def test_train_step_reduces_loss_on_a_repeated_batch():
    cfg = _cfgs()[1]
    _, prt = _runtimes("float32", "flash")
    params = _port(_ref_params("float32"))
    st = adamw_init(params)
    step = make_train_step(cfg, prt, lr=3e-3)
    toks, labels = _batch(2, 16, cfg.vocab, seed=21)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    losses = []
    for _ in range(3):
        params, st, m = step(params, st, batch)
        losses.append(float(m["loss"]))
    assert losses[2] < losses[1] < losses[0]


# ---------------------------------------------------------------- trainer


def _trainers(dtype: str, **kw):
    """A reference and a port ``Trainer`` on the same weights and state."""
    cfgj, cfgp = _cfgs()
    jrt, prt = _runtimes(dtype, "flash", opt_state_dtype=dtype)
    args = dict(seq_len=16, global_batch=2, lr=1e-3, seed=0)
    jt = JTrainer(cfgj, jrt, **args, **kw.get("j", {}))
    pt = PTrainer(cfgp, prt, **args, device="cpu", **kw.get("p", {}))
    pt.params = _port(jt.params)
    opt = jax.tree.map(np.asarray, jt.opt)
    pt.opt = adamw_state_from_numpy(opt.step, opt.m, opt.v, CPU)
    return jt, pt


def test_trainer_losses_match_reference():
    """bf16 parameters and bf16 AdamW moments (float32 steps are held by
    ``test_train_steps_match_reference``)."""
    jt, pt = _trainers("bfloat16")
    assert pt.opt.m["embed"].dtype == torch.bfloat16
    jl, pl = jt.run(3, log_every=100), pt.run(3, log_every=100)
    assert pt.step == jt.step == 3
    np.testing.assert_allclose(pl, jl, atol=BF16_LOSS)


def test_trainer_draws_its_own_weights_from_the_seed():
    cfg = _cfgs()[1]
    rt = _runtimes("float32")[1]
    a = PTrainer(cfg, rt, seq_len=8, global_batch=1, seed=4, device="cpu")
    b = PTrainer(cfg, rt, seq_len=8, global_batch=1, seed=4, device="cpu")
    c = PTrainer(cfg, rt, seq_len=8, global_batch=1, seed=5, device="cpu")
    assert torch.equal(a.params["embed"], b.params["embed"])
    assert not torch.equal(a.params["embed"], c.params["embed"])
    assert int(a.opt.step) == 0 and a.opt.v["embed"].dtype == torch.float32


def test_trainer_is_freed_after_run():
    """The SIGTERM hook that run() installs keeps no reference to the
    trainer, so dropping it frees its weights."""
    import gc
    import signal
    import weakref

    cfg = _cfgs()[1]
    previous = signal.getsignal(signal.SIGTERM)
    try:
        t = PTrainer(cfg, _runtimes("float32")[1], seq_len=8, global_batch=1, seed=4,
                     device="cpu")
        t.run(1, log_every=100)
        ref = weakref.ref(t)
        del t
        gc.collect()
        assert ref() is None
    finally:
        signal.signal(signal.SIGTERM, previous)


# ------------------------------------------------------------ checkpoints


def test_checkpoint_written_by_the_port_restores_in_the_reference(tmp_path):
    _, pt = _trainers("bfloat16", p=dict(ckpt_dir=str(tmp_path)))
    pt.run(2, log_every=100)
    jt, _ = _trainers("bfloat16")
    mgr = JCheckpoint(str(tmp_path))
    assert mgr.latest_step() == 2
    state, extra = mgr.restore({"params": jt.params, "opt": jt.opt})
    assert extra == {"step": 2, "data": {"step": 2}}
    with open(tmp_path / "step_0000000002" / "manifest.json") as f:
        keys = {m["key"]: m["dtype"] for m in json.load(f)["leaves"]}
    assert keys["params/blocks/attn/wq"] == "bfloat16" and keys["opt/step"] == "int32"
    assert keys["opt/m/embed"] == "bfloat16"
    assert state["params"]["embed"].dtype == jnp.bfloat16
    assert int(state["opt"].step) == 2
    want = tree_leaves({"params": pt.params}) + [pt.opt.step] + tree_leaves(pt.opt.m) + \
        tree_leaves(pt.opt.v)
    got = jax.tree.leaves(state["params"]) + [state["opt"].step] + \
        jax.tree.leaves(state["opt"].m) + jax.tree.leaves(state["opt"].v)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        if w.dtype == torch.bfloat16:
            np.testing.assert_array_equal(np.asarray(g).view(np.int16),
                                          w.view(torch.int16).numpy())
        else:
            np.testing.assert_array_equal(np.asarray(g), w.numpy())


def test_checkpoint_written_by_the_reference_restores_in_the_port(tmp_path):
    jt, _ = _trainers("bfloat16")
    # a state as after some steps: moments drawn by numpy, step 7, cursor 7
    rng = np.random.default_rng(22)
    draw = lambda a: jnp.asarray(rng.standard_normal(a.shape), a.dtype)  # noqa: E731
    jt.opt = jt.opt._replace(step=jnp.int32(7), m=jax.tree.map(draw, jt.opt.m),
                             v=jax.tree.map(draw, jt.opt.v))
    jt.step = 7
    jt.pipeline.skip_to(7)
    jt.ckpt = JCheckpoint(str(tmp_path))
    jt.save(block=True)
    _, pt = _trainers("bfloat16", p=dict(ckpt_dir=str(tmp_path)))
    assert pt.maybe_resume() and pt.step == 7 and pt.pipeline.state() == {"step": 7}
    assert pt.params["embed"].dtype == torch.bfloat16 and pt.opt.step.dtype == torch.int32
    want = jax.tree.leaves(jt.params) + [jt.opt.step] + jax.tree.leaves(jt.opt.m) + \
        jax.tree.leaves(jt.opt.v)
    got = tree_leaves(pt.params) + [pt.opt.step] + tree_leaves(pt.opt.m) + tree_leaves(pt.opt.v)
    for g, w in zip(got, want):
        w = np.asarray(w)
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(g.view(torch.int16).numpy(), w.view(np.int16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)


def test_port_checkpoint_round_trip_and_gc(tmp_path):
    mgr = PCheckpoint(str(tmp_path), keep_k=2, async_save=False)
    state = {"a": torch.arange(6, dtype=torch.float32).reshape(2, 3),
             "b": {"c": torch.ones(4, dtype=torch.bfloat16)},
             "opt": AdamWState(torch.tensor(7, dtype=torch.int32), {"x": torch.zeros(2)},
                               {"x": torch.ones(2)})}
    for step in (10, 20, 30):
        mgr.save(step, state, extra={"step": step, "data": {"step": step}})
    assert mgr.all_steps() == [20, 30]
    assert not any(n.endswith(".tmp") for n in os.listdir(tmp_path))
    restored, extra = mgr.restore(state, device="cpu")
    assert extra["step"] == 30 and isinstance(restored["opt"], AdamWState)
    for got, want in zip(tree_leaves(restored["a"]) + [restored["b"]["c"], restored["opt"].step],
                         [state["a"], state["b"]["c"], state["opt"].step]):
        assert got.dtype == want.dtype and torch.equal(got, want)


def test_trainer_resume_is_exact(tmp_path):
    cfg = _cfgs()[1]
    rt = _runtimes("float32", "flash")[1]
    kw = dict(seq_len=16, global_batch=2, seed=3, lr=1e-3, device="cpu")
    t1 = PTrainer(cfg, rt, ckpt_dir=str(tmp_path), save_every=2, **kw)
    t1.run(2, log_every=100)
    t2 = PTrainer(cfg, rt, ckpt_dir=str(tmp_path), **kw)
    losses_b = t2.run(2, log_every=100)
    assert t2.step == 4
    t3 = PTrainer(cfg, rt, **kw)
    losses_c = t3.run(4, log_every=100)
    assert losses_b == losses_c[2:]
    for a, b in zip(tree_leaves(t2.params), tree_leaves(t3.params)):
        assert torch.equal(a, b)


# --------------------------------------------------------------- launcher


def test_train_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import train

    train.main(["--reduced", "--steps", "2", "--seq-len", "16", "--batch", "2",
                "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final loss" in out and "(start" in out
