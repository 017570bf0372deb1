"""Training of the SSM and hybrid families in the port against the JAX
package, on the CPU: the loss and every gradient leaf of ``loss_fn``, train
steps and ``Trainer.run`` at ``reduced(get_arch("rwkv6-7b"))`` (4 layers,
d_model 128, 4 WKV heads of 32, chunk 32) and ``reduced(get_arch(
"zamba2-2.7b"))`` (6 Mamba2 layers in two groups of 3, d_model 128, 8 SSD
heads of P = 32, N = 16, chunk 32, the shared attention block after each
group). The port runs the plain versions of K12/K12b and K8/K8b (a CPU
tensor takes them); ``tests/test_torch_scan_grad.py`` holds those to the
reference's scans.

Weights are drawn by numpy from a seed and fed to both packages, the port's
through ``convert.lm_params_from_numpy``; leaves that the init rules set to
zero (``u_bonus``, the token-shift mixes, ``D``, ``dt_bias``) are drawn too,
so that every term takes part. The hybrid's ``A_log`` keeps its init value
0 except in ``test_reference_ssd_gradient_is_nan_where_the_port_is_finite``:
drawn at scale 0.5, the decay over a chunk of 32 reaches e^-88, the
reference's ``jnp.where(causal, jnp.exp(rel), 0.0)`` overflows above the
diagonal and its gradient is 0 * inf = NaN in every leaf below the head,
where the port, which evaluates only the kept triangle, stays finite.
Reference results are computed once a module (jitted) and shared.

Tolerances, each relative to the largest magnitude of the reference's
result, with its reason:

- ``loss_fn`` in float32: the losses within 1e-5 relative and every
  gradient leaf within 1e-5 of its scale for the four-layer rwkv6 (the
  llama tests' bound); within 3e-5 for zamba2, whose six Mamba2 layers and
  two shared-attention passes add float32 roundings of differently ordered
  sums, and whose per-head scalars (A_log, D, dt_bias) each sum 4096 terms
  with cancellation (measured: 2.4e-5 at most). The rwkv6 float32 checks run
  both packages' ``_wkv_chunked`` in the Pallas kernel's function (the
  reference's differentiable ``wkv_scan``, the port's K12 with K12b), which
  has no bf16 rounding; the bfloat16 checks run the model's own.
- ``loss_fn`` in bfloat16: the losses within 5e-3 (``BF16_LOSS`` of
  ``tests/test_torch_train.py``). Each package's bf16 gradients lie 3-29 %
  (of the largest magnitude) from the float32 gradient, the two packages'
  2-9 % from each other, more than llama's: so every leaf within 0.1 of its
  scale of the reference's, and no further in norm from the reference's
  float32 gradient than 1.25 times the reference's own bf16 gradient is
  (measured: 1.10 at most). A wrong formula moves a leaf by O(1) of its
  scale.
- Train steps and ``Trainer.run`` in float32: losses within 1e-5 relative.
  Adam divides each gradient by its root mean square, so where a gradient
  is near zero float32 noise moves that parameter's update by up to its
  whole size, lr: every parameter within 2 lr a step of the reference's,
  and all but 1e-5 of them within 0.1 lr a step (the llama test's bound).
  In bfloat16 the two trainers' runs differ by 0.03 after one update, and
  each lies up to 0.04 from the float32 run (measured): noise, not a gate.
"""
from __future__ import annotations

import contextlib
import functools
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.rwkv6_wkv.ops import wkv_scan as j_wkv_scan
from repro.models import Runtime as JRuntime
from repro.models import build_param_specs as j_specs
from repro.models import loss_fn as j_loss_fn
from repro.models import rwkv6 as J6
from repro.optim import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro.train.trainer import Trainer as JTrainer
from repro_torch import configs as PC
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.kernels import counts
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import Runtime as PRuntime
from repro_torch.models import loss_fn as p_loss_fn
from repro_torch.models import rwkv6 as P6
from repro_torch.models.params import tree_leaves
from repro_torch.optim import adamw_init
from repro_torch.train import make_train_step
from repro_torch.train.trainer import Trainer as PTrainer

CPU = torch.device("cpu")
F32 = 1e-5
HYBRID_F32 = 3e-5
BF16_LOSS = 5e-3
BF16_GRAD = 5e-2
ARCHS = {"ssm": "rwkv6-7b", "hybrid": "zamba2-2.7b"}
SCANS = {"ssm": "rwkv6_wkv", "hybrid": "mamba2_ssd"}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _assert_scaled(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max()) / max(float(np.abs(want).max()), 1e-30)
    assert err <= tol, f"max err {err} of the scale > {tol}"


def _runtimes(dtype: str):
    kw = dict(remat="none", act_shard=False, param_dtype=dtype, compute_dtype=dtype,
              attn_impl="xla")
    return JRuntime(**kw), PRuntime(**kw)


def _cfgs(family: str):
    return RC.reduced(RC.get_arch(ARCHS[family])), PC.reduced(PC.get_arch(ARCHS[family]))


def _np_tree(specs, seed: int):
    """numpy weights for a reference spec tree: ones where the spec says, a
    normal draw elsewhere (zeros-initialised leaves at scale 0.5), times
    1/sqrt(fan_in) (``scaled``) or 0.02, cast to the spec's dtype."""
    rng = np.random.default_rng(seed)

    def one(s):
        if s.init == "ones":
            a = np.ones(s.shape, np.float32)
        elif s.init == "zeros":
            a = (rng.standard_normal(s.shape) * 0.5).astype(np.float32)
        else:
            fan_in = s.shape[s.fan_in_axis] if len(s.shape) >= 2 else s.shape[-1]
            scale = 1.0 / np.sqrt(fan_in) if s.init == "scaled" else 0.02
            a = (rng.standard_normal(s.shape) * scale).astype(np.float32)
        return np.asarray(jnp.asarray(a, s.dtype))

    return jax.tree.map(one, specs, is_leaf=lambda s: hasattr(s, "fan_in_axis"))


@functools.cache
def _weights(family: str, dtype: str, drawn_rates: bool = False):
    """The reference's tree of the reduced model (numpy), drawn once; the
    hybrid's ``A_log`` at its init value 0 unless ``drawn_rates``."""
    tree = _np_tree(j_specs(_cfgs(family)[0], _runtimes(dtype)[0]), seed=0)
    if family == "hybrid" and not drawn_rates:
        mamba = tree["blocks"]["mamba"]
        mamba["A_log"] = np.zeros_like(mamba["A_log"])
    return tree


@contextlib.contextmanager
def _float32_wkv(on: bool = True):
    """Both packages' ``_wkv_chunked`` in the Pallas kernel's function (every
    product float32), differentiable: the reference's ``wkv_scan`` and the
    port's K12 with K12b."""
    def ref(r, k, v, w, u, chunk):
        B, S, H, K = r.shape

        def bh(t):
            return t.transpose(0, 2, 1, 3).reshape(B * H, S, K)

        u_bh = jnp.broadcast_to(u[None], (B, H, K)).reshape(B * H, K)
        y = j_wkv_scan(bh(r), bh(k), bh(v), bh(w), u_bh, chunk=chunk, interpret=True)
        return y.reshape(B, H, S, K).transpose(0, 2, 1, 3)

    def port(r, k, v, w, u, chunk):
        return wkv_ops._wkv(r, k, v, w, u[None], chunk, False)[0]

    if not on:
        yield
        return
    with mock.patch.object(J6, "_wkv_chunked", ref), mock.patch.object(P6, "_wkv_chunked", port):
        yield


def _batch(B, S, vocab, seed=0):
    toks = np.random.default_rng(seed).integers(2, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


def _f32_wkv(family: str, dtype: str) -> bool:
    return family == "ssm" and dtype == "float32"


@functools.cache
def _reference(family: str, dtype: str, drawn_rates: bool = False):
    """(loss, gradient leaves as numpy) of the reference's ``loss_fn``."""
    jcfg, _ = _cfgs(family)
    jrt, _ = _runtimes(dtype)
    toks, labels = _batch(2, 64, jcfg.vocab, seed=17)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    with _float32_wkv(_f32_wkv(family, dtype)):
        loss, grads = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, jrt, batch)))(
            jax.tree.map(jnp.asarray, _weights(family, dtype, drawn_rates)))
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)]


@functools.cache
def _port(family: str, dtype: str, drawn_rates: bool = False):
    """(loss, gradient leaves, plain calls) of the port's ``loss_fn``."""
    _, pcfg = _cfgs(family)
    _, prt = _runtimes(dtype)
    toks, labels = _batch(2, 64, pcfg.vocab, seed=17)
    params = lm_params_from_numpy(_weights(family, dtype, drawn_rates), CPU)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    counts.reset()
    with _float32_wkv(_f32_wkv(family, dtype)):
        loss = p_loss_fn(params, pcfg, prt, {"tokens": torch.from_numpy(toks),
                                             "labels": torch.from_numpy(labels)})
        grads = torch.autograd.grad(loss, leaves)
    assert [g.dtype for g in grads] == [p.dtype for p in leaves]
    return float(loss.detach()), grads, dict(counts.PLAIN_CALLS)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_loss_fn_value_and_grads_match_reference_f32(family):
    loss, grads, plain = _port(family, "float32")
    jloss, jgrads = _reference(family, "float32")
    n = _cfgs(family)[1].n_layers
    assert plain[SCANS[family]] == plain[SCANS[family] + "_bwd"] == n
    assert abs(loss - jloss) <= F32 * jloss
    assert len(grads) == len(jgrads)
    for got, want in zip(grads, jgrads):
        assert bool(torch.isfinite(got).all())
        _assert_scaled(got, want, F32 if family == "ssm" else HYBRID_F32)


def test_reference_ssd_gradient_is_nan_where_the_port_is_finite():
    """With the decay rates drawn at scale 0.5 the two losses agree, every
    gradient leaf of the reference's is NaN but the final norm's and the
    head's, and the port's are finite."""
    loss, grads, _ = _port("hybrid", "float32", True)
    jloss, jgrads = _reference("hybrid", "float32", True)
    assert abs(loss - jloss) <= F32 * jloss
    assert all(bool(torch.isfinite(g).all()) for g in grads)
    finite = [bool(np.isfinite(g).all()) for g in jgrads]
    assert finite.count(True) == 2, finite


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_loss_fn_value_and_grads_match_reference_bf16(family):
    loss, grads, _ = _port(family, "bfloat16")
    jloss, jgrads = _reference(family, "bfloat16")
    _, jgrads32 = _reference(family, "float32")   # the float32 gradient both are compared to
    assert abs(loss - jloss) <= BF16_LOSS

    def dist(g, ref):
        return float(np.linalg.norm(_np(g) - _np(ref)) / np.linalg.norm(_np(ref)))

    for got, want, want32 in zip(grads, jgrads, jgrads32):
        _assert_scaled(got, want, 2 * BF16_GRAD)
        assert dist(got, want32) <= 1.25 * dist(want, want32), (dist(got, want32),
                                                                 dist(want, want32))


def _assert_adam_close(got_leaves, want_leaves, lr: float, steps: int):
    """Every parameter within 2 lr a step, all but 1e-5 of them within 0.1
    lr a step (the docstring's account)."""
    diffs = np.concatenate([np.abs(_np(g) - _np(w)).ravel()
                            for g, w in zip(got_leaves, want_leaves)])
    assert float(diffs.max()) <= 2 * lr * steps, float(diffs.max())
    assert float((diffs > 0.1 * lr * steps).mean()) <= 1e-5


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_train_steps_match_reference(family):
    """Two ``make_train_step`` steps in float32."""
    jcfg, pcfg = _cfgs(family)
    jrt, prt = _runtimes("float32")
    tree = _weights(family, "float32")
    jp = jax.tree.map(jnp.asarray, tree)
    pp = lm_params_from_numpy(tree, CPU)
    jst, pst = j_adamw_init(jp), adamw_init(pp)
    with _float32_wkv(family == "ssm"):
        jstep = jax.jit(j_make_train_step(jcfg, jrt, lr=1e-3))
        pstep = make_train_step(pcfg, prt, lr=1e-3)
        for seed in range(2):
            toks, labels = _batch(2, 32, pcfg.vocab, seed=seed)
            jp, jst, jm = jstep(jp, jst, {"tokens": jnp.asarray(toks),
                                          "labels": jnp.asarray(labels)})
            pp, pst, pm = pstep(pp, pst, {"tokens": torch.from_numpy(toks),
                                          "labels": torch.from_numpy(labels)})
            assert abs(float(pm["loss"]) - float(jm["loss"])) <= F32 * float(jm["loss"])
    _assert_adam_close(tree_leaves(pp), jax.tree.leaves(jp), lr=1e-3, steps=2)
    assert not any(p.requires_grad for p in tree_leaves(pp))


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_trainer_losses_match_reference(family):
    """``Trainer.run`` in float32, two steps, the port's trainer on the
    reference trainer's own weights and AdamW state."""
    jcfg, pcfg = _cfgs(family)
    kw = dict(remat="none", act_shard=False, param_dtype="float32", compute_dtype="float32",
              attn_impl="xla", opt_state_dtype="float32")
    args = dict(seq_len=32, global_batch=2, lr=1e-3, seed=0)
    with _float32_wkv(family == "ssm"):
        jt = JTrainer(jcfg, JRuntime(**kw), **args)
        pt = PTrainer(pcfg, PRuntime(**kw), **args, device="cpu")
        pt.params = lm_params_from_numpy(jax.tree.map(np.asarray, jt.params), CPU)
        opt = jax.tree.map(np.asarray, jt.opt)
        pt.opt = adamw_state_from_numpy(opt.step, opt.m, opt.v, CPU)
        jl, pl = jt.run(2, log_every=100), pt.run(2, log_every=100)
    assert pt.step == jt.step == 2
    np.testing.assert_allclose(pl, jl, rtol=F32, atol=0)


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_train_step_reduces_loss_on_a_repeated_batch(family):
    _, pcfg = _cfgs(family)
    _, prt = _runtimes("float32")
    params = lm_params_from_numpy(_weights(family, "float32"), CPU)
    st = adamw_init(params)
    step = make_train_step(pcfg, prt, lr=3e-3)
    toks, labels = _batch(2, 32, pcfg.vocab, seed=21)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    losses = []
    for _ in range(3):
        params, st, m = step(params, st, batch)
        losses.append(float(m["loss"]))
    assert losses[2] < losses[1] < losses[0]


@pytest.mark.parametrize("family", ["ssm", "hybrid"])
def test_train_launcher_runs_on_the_cpu(family, capsys):
    from repro_torch.launch.train import main

    main(["--arch", ARCHS[family], "--reduced", "--steps", "2", "--seq-len", "32",
          "--batch", "2", "--device", "cpu"])
    out = capsys.readouterr().out
    assert "final loss" in out and "nan" not in out.lower()
