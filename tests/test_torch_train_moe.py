"""Training of the MoE family in the port against the JAX package, on the
CPU: the grouped matmul's backward (K9b's plain version ``gmm_bwd_plain``
against ``jax.vjp`` of the reference's ``gmm_ref``), ``moe_apply``'s
gradients, and ``loss_fn``, every gradient leaf, train steps,
``Trainer.run`` and the launcher at ``reduced(get_arch("mixtral-8x22b"))``
(4 layers, d_model 128, 4 query and 2 KV heads of 32, 4 experts top-2 of
width 128, vocab 512). The port runs the plain versions of K9, K9b, K4-K6
and K10/K11 (a CPU tensor takes them).

Weights and inputs are drawn by numpy from a seed and fed to both packages,
the port's through ``convert.lm_params_from_numpy``. The reference's
results are computed once a module (jitted) and shared.

Routing is discrete; the router is float32 in both packages, and at these
draws the two packages route every token alike (held by
``tests/test_torch_moe.py``), so the gradients compare directly. The
dropped-token case runs at capacity factor 0.5, where each layer drops
assignments at the capacity slot ``Cr``, which is cut from the experts'
input and so gets no gradient.

Tolerances, each relative to the largest magnitude of the reference's
result: in float32 1e-5 (the llama tests' bound; the summation order
differs); in bfloat16 the losses within 5e-3 and every gradient leaf within
5e-2 of its scale (``tests/test_torch_train.py``'s bounds), where a wrong
formula moves a leaf by O(1). The grouped matmul's backward: float32 2e-5
and bfloat16 2e-2 of ``D`` or ``C`` summed terms (``tests/test_kernels.py``'s
grouped-matmul tolerances). Train steps in float32: losses within 1e-5
relative, parameters within 2 lr a step and all but 1e-5 of them within 0.1
lr a step (``tests/test_torch_train_ssm.py``'s account of Adam's division).
"""
from __future__ import annotations

import contextlib
import functools
from pathlib import Path
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.moe_gmm.ref import gmm_ref
from repro.models import Runtime as JRuntime
from repro.models import build_param_specs as j_specs
from repro.models import loss_fn as j_loss_fn
from repro.models.moe import moe_apply as j_moe_apply
from repro.models.moe import moe_specs as j_moe_specs
from repro.optim import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro.train.trainer import Trainer as JTrainer
from repro_torch import configs as PC
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.kernels import counts
from repro_torch.kernels.moe_gmm import ops as gmm_ops
from repro_torch.models import Runtime as PRuntime
from repro_torch.models import loss_fn as p_loss_fn
from repro_torch.models import moe as P_MOE
from repro_torch.models.moe import moe_apply as p_moe_apply
from repro_torch.models.moe import moe_route as p_moe_route
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw_init
from repro_torch.train import make_train_step
from repro_torch.train.trainer import Trainer as PTrainer

CPU = torch.device("cpu")
F32 = 1e-5
BF16_LOSS = 5e-3
BF16_GRAD = 5e-2
GMM_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
ARCH = "mixtral-8x22b"
RT_KW = dict(remat="none", attn_chunk=16, q_block=16, kv_block=16, act_shard=False)
DROP_CF = 0.5   # a capacity factor at which every layer drops assignments


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _assert_scaled(got, want, tol=F32):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x scale {scale}"


def _runtimes(dtype: str, impl: str = "xla", **kw):
    kw = dict(RT_KW, param_dtype=dtype, compute_dtype=dtype, attn_impl=impl, **kw)
    return JRuntime(**kw), PRuntime(**kw)


def _cfgs():
    return RC.reduced(RC.get_arch(ARCH)), PC.reduced(PC.get_arch(ARCH))


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
def _weights(dtype: str):
    return _np_tree(j_specs(_cfgs()[0], _runtimes(dtype)[0]), seed=0)


def _batch(B, S, vocab, seed=0):
    toks = np.random.default_rng(seed).integers(2, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


# ---------------------------------------------------- K9b's plain version


def _gmm_vjp(x, w, dy, gs, masked_einsum: bool):
    """(dx, dw) of the reference: ``jax.vjp`` of ``gmm_ref``, or of the
    model's einsum with the rows past the group size set to 0."""
    def ref(a, b):
        if not masked_einsum:
            return gmm_ref(a, b, gs)
        out = jnp.einsum("ecd,edf->ecf", a, b)
        if gs is None:
            return out
        rows = jnp.arange(a.shape[1])[None, :] < gs[:, None]
        return jnp.where(rows[..., None], out, 0).astype(out.dtype)

    _, vjp = jax.vjp(ref, x, w)
    return vjp(dy)


GMM_BWD_CASES = [
    # (E, C, D, F, group sizes): ragged, 0, C, past C, None
    (2, 32, 48, 24, None),
    (3, 40, 64, 40, (40, 0, 17)),
    (4, 20, 200, 72, (0, 20, 25, 3)),
    (2, 77, 50, 30, (77, 1)),
]


@pytest.mark.parametrize("E,C,D,F,gs", GMM_BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gmm_bwd_plain_matches_reference_vjp(E, C, D, F, gs, dtype):
    """A nonzero cotangent on the masked rows reaches neither gradient, and
    the masked rows of dx are 0."""
    rng = np.random.default_rng(E * C + D)
    xj = jnp.asarray(rng.standard_normal((E, C, D)), JDT[dtype])
    wj = jnp.asarray(rng.standard_normal((E, D, F)) / np.sqrt(D), JDT[dtype])
    dyj = jnp.asarray(rng.standard_normal((E, C, F)), JDT[dtype])   # nonzero everywhere
    gj = None if gs is None else jnp.asarray(np.array(gs, np.int32))
    pt = [lm_params_from_numpy({"a": np.asarray(t)}, CPU)["a"] for t in (xj, wj, dyj)]
    gp = None if gs is None else torch.tensor(gs, dtype=torch.int32)
    dx, dw = gmm_ops.gmm_bwd_plain(*pt, gp)
    assert dx.dtype == dw.dtype == pt[0].dtype
    for masked_einsum in (False, True):
        jdx, jdw = _gmm_vjp(xj, wj, dyj, gj, masked_einsum)
        np.testing.assert_allclose(_np(dx), _np(jdx), atol=GMM_TOL[dtype] * F,
                                   rtol=GMM_TOL[dtype])
        np.testing.assert_allclose(_np(dw), _np(jdw), atol=GMM_TOL[dtype] * C,
                                   rtol=GMM_TOL[dtype])
    if gs is not None:
        for e, n in enumerate(gs):
            assert not _np(dx)[e, n:].any()


def test_gmm_bwd_plain_never_reads_masked_rows():
    """NaN in x and dy past the group sizes reaches neither gradient."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((3, 12, 16)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 16, 8)).astype(np.float32))
    dy = torch.from_numpy(rng.standard_normal((3, 12, 8)).astype(np.float32))
    gs = torch.tensor([12, 5, 0], dtype=torch.int32)
    want = gmm_ops.gmm_bwd_plain(x, w, dy, gs)
    xn, dyn = x.clone(), dy.clone()
    for e, n in enumerate(gs.tolist()):
        xn[e, n:], dyn[e, n:] = float("nan"), float("nan")
    got = gmm_ops.gmm_bwd_plain(xn, w, dyn, gs)
    for g, t in zip(got, want):
        assert torch.equal(g, t)


@pytest.mark.parametrize("need", [(True, True), (True, False), (False, True)])
def test_grouped_matmul_gradients_on_the_cpu(need):
    """``grouped_matmul`` differentiates through ``_GmmFunction``: one plain
    backward call, the gradients ``jax.vjp`` gives, none for an input that
    needs none."""
    rng = np.random.default_rng(5)
    x = rng.standard_normal((3, 40, 64)).astype(np.float32)
    w = (rng.standard_normal((3, 64, 40)) / 8).astype(np.float32)
    dy = rng.standard_normal((3, 40, 40)).astype(np.float32)
    gs = np.array([40, 0, 17], np.int32)
    xt = torch.from_numpy(x).requires_grad_(need[0])
    wt = torch.from_numpy(w).requires_grad_(need[1])
    counts.reset()
    out = gmm_ops.grouped_matmul(xt, wt, torch.from_numpy(gs))
    assert out.requires_grad
    out.backward(torch.from_numpy(dy))
    assert counts.PLAIN_CALLS["moe_gmm"] == 1 and counts.PLAIN_CALLS["moe_gmm_bwd"] == 1
    jdx, jdw = _gmm_vjp(jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy), jnp.asarray(gs), False)
    for t, want, on in ((xt, jdx, need[0]), (wt, jdw, need[1])):
        if on:
            _assert_scaled(t.grad, want, GMM_TOL["float32"])
        else:
            assert t.grad is None
    with torch.no_grad():
        assert not gmm_ops.grouped_matmul(xt, wt).requires_grad


# --------------------------------------------------------------- moe_apply


@functools.cache
def _moe_case(cf):
    jcfg, pcfg = _cfgs()
    tree = _np_tree(j_moe_specs(jcfg, dtype=jnp.float32), seed=7)
    x = np.random.default_rng(8).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    g = np.random.default_rng(9).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    jrt, prt = _runtimes("float32", capacity_factor=cf)
    jp = jax.tree.map(jnp.asarray, tree)
    _, vjp = jax.vjp(lambda p, a: j_moe_apply(p, a, jcfg, jrt), jp, jnp.asarray(x))
    jgp, jgx = vjp(jnp.asarray(g))
    return (pcfg, prt, tree, x, g), (jax.tree.map(np.asarray, jgp), np.asarray(jgx))


@pytest.mark.parametrize("cf", [None, DROP_CF])
def test_moe_apply_gradients_match_reference(cf):
    """Every weight's and x's gradient through the router (softmax, stable
    sort, renormalisation), the dispatch and the combine; at capacity
    factor 0.5 tokens are dropped, and a token with every assignment dropped
    gets no gradient."""
    (pcfg, prt, tree, x, g), (jgp, jgx) = _moe_case(cf)
    pp = lm_params_from_numpy(tree, CPU)
    for t in pp.values():
        t.requires_grad_(True)
    px = torch.from_numpy(x).requires_grad_(True)
    counts.reset()
    out = p_moe_apply(pp, px, pcfg, prt)
    out.backward(torch.from_numpy(g))
    assert counts.PLAIN_CALLS["moe_gmm_bwd"] == 3
    _assert_scaled(px.grad, jgx)
    for k in sorted(pp):
        _assert_scaled(pp[k].grad, jgp[k])
    _, idx, slot, Cr = p_moe_route(pp["router"], px.detach(), pcfg, prt)
    dropped = (slot == Cr).reshape(idx.shape)
    if cf is None:
        return
    assert dropped.any(), "the case must drop assignments"
    all_dropped = dropped.all(-1)
    assert all_dropped.any(), "the case must drop every assignment of some token"
    assert not px.grad[all_dropped].any()


# ----------------------------------------------------------------- loss_fn


@functools.cache
def _reference(dtype: str, cf=None):
    """(loss, gradient leaves as numpy) of the reference's ``loss_fn``."""
    jcfg, _ = _cfgs()
    jrt, _ = _runtimes(dtype, capacity_factor=cf)
    toks, labels = _batch(2, 32, jcfg.vocab, seed=17)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    loss, grads = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, jrt, batch)))(
        jax.tree.map(jnp.asarray, _weights(dtype)))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


def _port_loss(dtype: str, cf=None):
    """(loss, gradient leaves, plain calls, assignments dropped by layer) of
    the port's ``loss_fn``."""
    _, pcfg = _cfgs()
    _, prt = _runtimes(dtype, capacity_factor=cf)
    toks, labels = _batch(2, 32, pcfg.vocab, seed=17)
    params = lm_params_from_numpy(_weights(dtype), CPU)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    dropped = []

    def route(*args):
        out = p_moe_route(*args)
        dropped.append(int((out[2] == out[3]).sum()))
        return out

    counts.reset()
    with mock.patch.object(P_MOE, "moe_route", route):
        loss = p_loss_fn(params, pcfg, prt, {"tokens": torch.from_numpy(toks),
                                             "labels": torch.from_numpy(labels)})
    grads = torch.autograd.grad(loss, leaves)
    assert [g.dtype for g in grads] == [p.dtype for p in leaves]
    return float(loss.detach()), grads, dict(counts.PLAIN_CALLS), dropped


@pytest.mark.parametrize("dtype,cf", [("float32", None), ("float32", DROP_CF),
                                      ("bfloat16", None)])
def test_loss_fn_value_and_grads_match_reference(dtype, cf):
    loss, grads, plain, dropped = _port_loss(dtype, cf)
    jloss, jgrads = _reference(dtype, cf)
    n = _cfgs()[1].n_layers
    assert plain["moe_gmm"] == 3 * n and plain["moe_gmm_bwd"] == 3 * n
    if cf is not None:
        assert len(dropped) == n and all(dropped), dropped
    assert len(grads) == len(jgrads)
    if dtype == "float32":
        assert abs(loss - jloss) <= F32 * jloss
    else:
        assert abs(loss - jloss) <= BF16_LOSS
    for got, want in zip(grads, jgrads):
        assert bool(torch.isfinite(got).all())
        _assert_scaled(got, want, F32 if dtype == "float32" else BF16_GRAD)


def test_router_is_a_float32_leaf_among_bf16_leaves():
    """In bfloat16 the routers' gradients are float32 and every other leaf's
    bf16, as their leaves (``_port_loss`` holds each gradient to its leaf's
    dtype)."""
    _, grads, _, _ = _port_loss("bfloat16")
    n_f32 = sum(g.dtype == torch.float32 for g in grads)
    assert n_f32 == 1 and {g.dtype for g in grads} == {torch.float32, torch.bfloat16}


# ------------------------------------------------------------------- steps


def _assert_adam_close(got_leaves, want_leaves, lr: float, steps: int):
    diffs = np.concatenate([np.abs(_np(g) - _np(w)).ravel()
                            for g, w in zip(got_leaves, want_leaves)])
    assert float(diffs.max()) <= 2 * lr * steps, float(diffs.max())
    assert float((diffs > 0.1 * lr * steps).mean()) <= 1e-5


def test_train_steps_match_reference():
    """Two ``make_train_step`` steps in float32."""
    jcfg, pcfg = _cfgs()
    jrt, prt = _runtimes("float32")
    tree = _weights("float32")
    jp = jax.tree.map(jnp.asarray, tree)
    pp = lm_params_from_numpy(tree, CPU)
    jst, pst = j_adamw_init(jp), adamw_init(pp)
    jstep = jax.jit(j_make_train_step(jcfg, jrt, lr=1e-3))
    pstep = make_train_step(pcfg, prt, lr=1e-3)
    for seed in range(2):
        toks, labels = _batch(2, 32, pcfg.vocab, seed=seed)
        jp, jst, jm = jstep(jp, jst, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
        pp, pst, pm = pstep(pp, pst, {"tokens": torch.from_numpy(toks),
                                      "labels": torch.from_numpy(labels)})
        assert abs(float(pm["loss"]) - float(jm["loss"])) <= F32 * float(jm["loss"])
    _assert_adam_close(tree_leaves(pp), jax.tree.leaves(jp), lr=1e-3, steps=2)
    assert pp["blocks"]["moe"]["router"].dtype == torch.float32
    assert not any(p.requires_grad for p in tree_leaves(pp))


def test_trainer_losses_match_reference():
    """``Trainer.run`` in float32, two steps, the port's trainer on the
    reference trainer's own weights and AdamW state."""
    jcfg, pcfg = _cfgs()
    kw = dict(RT_KW, param_dtype="float32", compute_dtype="float32", attn_impl="flash",
              opt_state_dtype="float32")
    args = dict(seq_len=32, global_batch=2, lr=1e-3, seed=0)
    jt = JTrainer(jcfg, JRuntime(**kw), **args)
    pt = PTrainer(pcfg, PRuntime(**kw), **args, device="cpu")
    pt.params = lm_params_from_numpy(jax.tree.map(np.asarray, jt.params), CPU)
    opt = jax.tree.map(np.asarray, jt.opt)
    pt.opt = adamw_state_from_numpy(opt.step, opt.m, opt.v, CPU)
    counts.reset()
    jl, pl = jt.run(2, log_every=100), pt.run(2, log_every=100)
    assert pt.step == jt.step == 2
    assert counts.PLAIN_CALLS["moe_gmm_bwd"] == 2 * 3 * pcfg.n_layers
    np.testing.assert_allclose(pl, jl, rtol=F32, atol=0)


def test_train_step_reduces_loss_on_a_repeated_batch():
    _, pcfg = _cfgs()
    _, prt = _runtimes("float32")
    params = lm_params_from_numpy(_weights("float32"), CPU)
    st = adamw_init(params)
    step = make_train_step(pcfg, prt, lr=3e-3)
    toks, labels = _batch(2, 32, pcfg.vocab, seed=21)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    losses = []
    for _ in range(3):
        params, st, m = step(params, st, batch)
        losses.append(float(m["loss"]))
    assert losses[2] < losses[1] < losses[0]


def test_train_launcher_runs_mixtral_on_the_cpu(capsys):
    from repro_torch.launch.train import main

    main(["--arch", ARCH, "--reduced", "--steps", "2", "--seq-len", "32", "--batch", "2",
          "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final loss" in out and "nan" not in out.lower()


def test_moe_route_is_its_parts():
    """``moe_route`` is ``router_probs``, a stable top-k, ``gates_at`` and
    ``capacity_slots``: the parts that a replay of recorded choices reuses."""
    _, pcfg = _cfgs()
    _, prt = _runtimes("float32", capacity_factor=DROP_CF)
    rng = np.random.default_rng(23)
    router = torch.from_numpy(rng.standard_normal((pcfg.d_model, 4)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((2, 16, pcfg.d_model)).astype(np.float32))
    gates, idx, slot, Cr = p_moe_route(router, x, pcfg, prt)
    probs = P_MOE.router_probs(router, x)
    assert torch.equal(idx, torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :2])
    assert torch.equal(gates, P_MOE.gates_at(probs, idx))
    assert torch.equal(slot, P_MOE.capacity_slots(idx, 4, Cr))
    assert bool((slot == Cr).any()), "the case must drop assignments"
    np.testing.assert_allclose(gates.sum(-1).numpy(), 1.0, rtol=1e-6)


def test_smoke_replay_takes_the_gates_of_its_own_router():
    """``chip_smoke.replay_routing`` with ``own_gates``: a run replaying
    another run's choices gets the loss and router gradient of a run whose
    router chose the same experts itself; without it, the recorded gates."""
    import sys

    root = str(Path(__file__).resolve().parents[1])
    sys.path.insert(0, root)
    try:
        import chip_smoke
    finally:
        sys.path.remove(root)
    _, pcfg = _cfgs()
    _, prt = _runtimes("float32")
    toks, labels = _batch(2, 32, pcfg.vocab, seed=17)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    params = lm_params_from_numpy(_weights("float32"), CPU)
    with chip_smoke.record_routing() as (rec, _), torch.no_grad():
        p_loss_fn(params, pcfg, prt, batch)
    router = params["blocks"]["moe"]["router"]
    router.mul_(1.0 + 1e-3)      # other gates, the same choices at this draw
    router.requires_grad_(True)

    def run(ctx):
        with ctx as otherwise:
            loss = p_loss_fn(params, pcfg, prt, batch)
        grad = torch.autograd.grad(loss, router)[0] if loss.requires_grad else None
        return float(loss.detach()), grad, otherwise

    own = run(contextlib.nullcontext(None))
    replayed = run(chip_smoke.replay_routing(lambda n, r: rec[n], own_gates=True))
    recorded = run(chip_smoke.replay_routing(lambda n, r: rec[n]))
    assert replayed[2] == recorded[2] == [0] * pcfg.n_layers
    assert replayed[0] == own[0] and torch.equal(replayed[1], own[1])
    assert recorded[0] != own[0] and recorded[1] is None   # the recorded gates are constants
