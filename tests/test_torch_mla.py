"""MLA serving and the multi-token-prediction loss of deepseek-v3 in the port
against the JAX package, on the CPU.

The model is ``reduced(get_arch("deepseek-v3-671b"))``: 4 layers (1 dense,
3 MoE), d_model 128, 4 heads, MLA with q rank 64, latent 32, nope 32, rope
16 and v 32, 4 experts top-2 of width 128 with one shared expert, vocab
512, and its MTP block (``mtp_depth`` 1). Weights and inputs are drawn by
numpy from a seed and fed to both packages, the port's through
``convert.lm_params_from_numpy``; the reference's results are computed once
a module and shared. The port runs the plain versions of K9, K9b and
K10/K11 (a CPU tensor takes them); MLA's attention is the plain blocked
route in both packages, whatever ``attn_impl`` says.

Tolerances, each relative to the largest magnitude of the reference's
result: float32 1e-5 (the summation order differs); bfloat16 the MLA
pieces and the decode caches within 5e-2 of their scale, logits by their
softmax within 5e-2 (``tests/test_decode_consistency.py``'s bound), the
losses within 5e-3 and every gradient leaf within 5e-2 of its scale
(``tests/test_torch_train.py``'s bounds). In float32 both packages route
every token alike at these draws, which the logits' and gradients' 1e-5
show. In bfloat16 a token whose router scores sit near a tie routes
otherwise under the packages' other roundings, and everything downstream
moves with it; where the tests compare bfloat16 caches and gradients, the
port therefore replays the reference's expert choices (recorded from its
``jax.lax.top_k`` as it runs) with its slots and gates recomputed by the
port's own ``capacity_slots`` and router (``_replaying``).
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
from repro.models import Runtime as JRuntime
from repro.models import attention as JA
from repro.models import build_param_specs as j_specs
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import loss_fn as j_loss_fn
from repro.models import param_bytes as j_param_bytes
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import configs as PC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import counts
from repro_torch.models import Runtime as PRuntime
from repro_torch.models import attention as PA
from repro_torch.models import build_param_specs as p_specs
from repro_torch.models import decode_step as p_decode
from repro_torch.models import forward as p_forward
from repro_torch.models import init_cache as p_init_cache
from repro_torch.models import loss_fn as p_loss_fn
from repro_torch.models import moe as P_MOE
from repro_torch.models import param_bytes as p_param_bytes
from repro_torch.models.params import tree_leaves
from repro_torch.serving import Request as PRequest
from repro_torch.serving import ServingEngine as PEngine

CPU = torch.device("cpu")
F32 = 1e-5
BF16 = 5e-2
SOFTMAX_BOUND = 5e-2
BF16_LOSS = 5e-3
ARCH = "deepseek-v3-671b"
RT_KW = dict(remat="none", attn_chunk=16, q_block=16, kv_block=16, act_shard=False)
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}


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


def _softmax_err(a, b) -> float:
    pa = torch.softmax(torch.from_numpy(_np(a)), dim=-1)
    pb = torch.softmax(torch.from_numpy(_np(b)), dim=-1)
    return float((pa - pb).abs().max())


def _runtimes(dtype: str, impl: str = "xla"):
    kw = dict(RT_KW, param_dtype=dtype, compute_dtype=dtype, attn_impl=impl)
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
def _model(dtype: str):
    """(reference params, port params) of the reduced deepseek-v3; the tests
    read the weights and never write them."""
    jcfg, _ = _cfgs()
    tree = _np_tree(j_specs(jcfg, _runtimes(dtype)[0]), seed=0)
    return jax.tree.map(jnp.asarray, tree), lm_params_from_numpy(tree, CPU)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, (B, S)).astype(np.int32)


def _layer(tree, i):
    return {k: v[i] for k, v in tree.items()}


@contextlib.contextmanager
def _recording_top_k():
    """While active, every ``jax.lax.top_k`` the reference traces appends its
    indices, as it runs, to the yielded list: the expert choices of its MoE
    layers in call order (layer by layer, step by step)."""
    rec: list = []
    top_k = jax.lax.top_k

    def recording(x, k):
        vals, idx = top_k(x, k)
        jax.debug.callback(lambda i: rec.append(np.array(i)), idx, ordered=True)
        return vals, idx

    with mock.patch.object(jax.lax, "top_k", recording):
        yield rec


@contextlib.contextmanager
def _replaying(rec):
    """While active, the port's n-th ``moe_route`` takes the reference's n-th
    recorded expert choices, with its own capacity slots and its own
    router's gates at them; the yielded list gets, per call, the number of
    choices its own routing would have made otherwise."""
    route = P_MOE.moe_route
    flips: list = []

    def replayed(router, x, cfg, rt):
        own = route(router, x, cfg, rt)
        idx = torch.from_numpy(rec[len(flips)]).long()
        flips.append(int((idx != own[1]).sum()))
        return (P_MOE.gates_at(P_MOE.router_probs(router, x), idx), idx,
                P_MOE.capacity_slots(idx, cfg.moe.n_experts, own[3]), own[3])

    with mock.patch.object(P_MOE, "moe_route", replayed):
        yield flips


def _leaf_paths(tree, prefix=()):
    """Key paths of a parameter tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], prefix + (k,))]
    return [prefix]


# ------------------------------------------------------------------ pieces


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mla_pieces_match_reference(dtype):
    """``_mla_qkv`` and ``mla_apply`` of the first MoE layer on one input, and
    ``mla_decode_apply`` over a cache holding 5 written slots."""
    jcfg, pcfg = _cfgs()
    jrt, prt = _runtimes(dtype)
    jp, pp = _model(dtype)
    ja, pa = _layer(jp["blocks"]["attn"], 0), _layer(pp["blocks"]["attn"], 0)
    x = np.random.default_rng(1).standard_normal((2, 16, jcfg.d_model)).astype(np.float32)
    jx, px = jnp.asarray(x, JDT[dtype]), torch.from_numpy(x).to(getattr(torch, dtype))
    pos = np.broadcast_to(np.arange(16, dtype=np.int32)[None], (2, 16))
    tol = F32 if dtype == "float32" else BF16
    for got, want in zip(PA._mla_qkv(pa, px, pcfg, torch.from_numpy(pos.copy())),
                         JA._mla_qkv(ja, jx, jcfg, jnp.asarray(pos))):
        assert got.dtype == px.dtype
        _assert_scaled(got, want, tol)
    got = PA.mla_apply(pa, px, pcfg, prt, torch.from_numpy(pos.copy()))
    want = JA.mla_apply(ja, jx, jcfg, jrt, jnp.asarray(pos))
    _assert_scaled(got, want, tol)

    m = jcfg.mla
    rng = np.random.default_rng(2)
    ckv = rng.standard_normal((2, 8, m.kv_lora_rank)).astype(np.float32)
    krope = rng.standard_normal((2, 8, m.qk_rope_head_dim)).astype(np.float32)
    cpos = np.array([4, 6], np.int32)
    jc = {"c_kv": jnp.asarray(ckv, JDT[dtype]), "k_rope": jnp.asarray(krope, JDT[dtype]),
          "pos": jnp.asarray(cpos)}
    pc = {"c_kv": torch.from_numpy(ckv).to(px.dtype), "k_rope": torch.from_numpy(krope).to(
        px.dtype), "pos": torch.from_numpy(cpos)}
    got, pc2 = PA.mla_decode_apply(pa, px[:, :1], pc, pcfg, prt)
    want, jc2 = JA.mla_decode_apply(ja, jx[:, :1], jc, jcfg, jrt)
    _assert_scaled(got, want, tol)
    for k in ("c_kv", "k_rope"):
        assert pc2[k] is pc[k]   # written in place
        _assert_scaled(pc2[k], jc2[k], tol)
    np.testing.assert_array_equal(pc2["pos"].numpy(), np.asarray(jc2["pos"]))


def test_mla_takes_the_plain_route_whatever_attn_impl_says():
    """head dim 192 at full width: K4 takes at most 128, so MLA never calls it."""
    _, pcfg = _cfgs()
    _, prt = _runtimes("float32", "flash")
    _, pp = _model("float32")
    counts.reset()
    p_forward(pp, pcfg, prt, tokens=torch.from_numpy(_tokens(1, 16, pcfg.vocab)))
    assert counts.PLAIN_CALLS["flash_attn_fwd"] == 0 and counts.LAUNCHES["flash_attn_fwd"] == 0
    m = PC.get_arch(ARCH).mla
    assert m.qk_nope_head_dim + m.qk_rope_head_dim == 192


# ----------------------------------------------------------- whole model


def test_param_specs_and_bytes_match_at_full_width():
    """The MLA stacks and the ``mtp`` subtree, leaf for leaf."""
    jcfg, pcfg = RC.get_arch(ARCH), PC.get_arch(ARCH)
    js, ps = j_specs(jcfg, JRuntime()), p_specs(pcfg, PRuntime())
    flat_j = jax.tree.leaves(js, is_leaf=lambda s: hasattr(s, "fan_in_axis"))
    flat_p = tree_leaves(ps)
    assert [(s.shape, s.axes, s.init, s.fan_in_axis, str(s.dtype).split(".")[-1])
            for s in flat_p] == \
        [(s.shape, s.axes, s.init, s.fan_in_axis, jnp.dtype(s.dtype).name) for s in flat_j]
    assert p_param_bytes(ps) == j_param_bytes(js)
    assert set(ps) == {"embed", "final_ln", "out", "dense_blocks", "blocks", "mtp"}
    assert ps["blocks"]["attn"]["w_uk"].shape == (58, 512, 128, 128)
    assert ps["mtp"]["ffn"]["w_up"].shape == (7168, 2048)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(dtype):
    jcfg, pcfg = _cfgs()
    jrt, prt = _runtimes(dtype)
    jp, pp = _model(dtype)
    tokens = _tokens(2, 32, jcfg.vocab, seed=1)
    want = j_forward(jp, jcfg, jrt, tokens=jnp.asarray(tokens))
    counts.reset()
    got = p_forward(pp, pcfg, prt, tokens=torch.from_numpy(tokens))
    n_moe = pcfg.n_layers - pcfg.moe.first_dense_layers
    assert counts.PLAIN_CALLS["moe_gmm"] == 3 * n_moe
    # q_norm, kv_norm and ln1, ln2 a layer, and the final norm
    assert counts.PLAIN_CALLS["rmsnorm_fwd"] == 4 * pcfg.n_layers + 1
    if dtype == "float32":
        _assert_scaled(got, want)
    else:
        assert _softmax_err(got, want) < SOFTMAX_BOUND


def test_init_cache_matches_reference():
    jcfg, pcfg = _cfgs()
    for dtype in ("float32", "bfloat16"):
        jrt, prt = _runtimes(dtype)
        jc, pc = j_init_cache(jcfg, jrt, 3, 24), p_init_cache(pcfg, prt, 3, 24, device="cpu")
        assert set(pc) == set(jc) == {"c_kv", "k_rope", "pos"}
        for k in pc:
            assert tuple(pc[k].shape) == jc[k].shape
            assert str(pc[k].dtype).split(".")[-1] == jnp.dtype(jc[k].dtype).name
            assert not pc[k].any()
    full = p_init_cache(PC.get_arch(ARCH), PRuntime(), 1, 16, device="cpu")
    assert full["c_kv"].shape == (61, 1, 16, 512) and full["k_rope"].shape == (61, 1, 16, 64)


def _teacher_force(step, cache, tokens, to_input):
    out = []
    for t in range(tokens.shape[1]):
        lg, cache = step(cache, to_input(tokens[:, t:t + 1]))
        out.append(_np(lg[:, 0]))
    return np.stack(out, axis=1), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_logits_and_caches_match_reference(dtype):
    jcfg, pcfg = _cfgs()
    jrt, prt = _runtimes(dtype)
    jp, pp = _model(dtype)
    tokens = _tokens(2, 10, jcfg.vocab, seed=3)
    n_moe = pcfg.n_layers - pcfg.moe.first_dense_layers
    with _recording_top_k() as rec:
        jstep = jax.jit(lambda c, t: j_decode(jp, jcfg, jrt, c, t))
        want, jc = _teacher_force(jstep, j_init_cache(jcfg, jrt, 2, 16), tokens, jnp.asarray)
        jax.effects_barrier()
    assert len(rec) == n_moe * 10
    counts.reset()
    # float32 routes alike on its own; bfloat16 replays the reference's choices
    replay = _replaying(rec) if dtype == "bfloat16" else contextlib.nullcontext([])
    with replay as flips:
        got, pc = _teacher_force(lambda c, t: p_decode(pp, pcfg, prt, c, t),
                                 p_init_cache(pcfg, prt, 2, 16, device="cpu"), tokens,
                                 torch.from_numpy)
    assert counts.PLAIN_CALLS["moe_gmm"] == 3 * n_moe * 10
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    tol = F32 if dtype == "float32" else BF16
    if dtype == "float32":
        _assert_scaled(got, want)
    else:
        assert len(flips) == n_moe * 10
        assert _softmax_err(got, want) < SOFTMAX_BOUND
    for k in ("c_kv", "k_rope"):
        _assert_scaled(pc[k], jc[k], tol)


def test_convert_carries_the_tree_and_the_caches():
    """The reference's MLA cache, carried by ``lm_params_from_numpy`` after
    six reference decode steps, continues in the port's decode step to the
    reference's next logits; the tree keeps its bf16 bits."""
    jcfg, pcfg = _cfgs()
    jrt, prt = _runtimes("float32")
    jp, pp = _model("float32")
    tokens = _tokens(2, 7, jcfg.vocab, seed=4)
    jstep = jax.jit(lambda c, t: j_decode(jp, jcfg, jrt, c, t))
    _, jc = _teacher_force(jstep, j_init_cache(jcfg, jrt, 2, 16), tokens[:, :6], jnp.asarray)
    want, _ = jstep(jc, jnp.asarray(tokens[:, 6:]))
    pc = lm_params_from_numpy(jax.tree.map(np.asarray, jc), CPU)
    got, _ = p_decode(pp, pcfg, prt, pc, torch.from_numpy(tokens[:, 6:]))
    _assert_scaled(got, want)
    jb, pb = _model("bfloat16")
    want_bits = np.asarray(jb["blocks"]["attn"]["w_uk"]).view(np.int16)
    np.testing.assert_array_equal(pb["blocks"]["attn"]["w_uk"].view(torch.int16).numpy(),
                                  want_bits)


def test_serving_engine_tokens_match_reference():
    jcfg, pcfg = _cfgs()
    jrt, prt = _runtimes("float32")
    jp, pp = _model("float32")
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


def test_serve_launcher_runs_deepseek_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--prompt-len", "4",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("generated 3 tokens") == 2 and "deepseek-v3-671b (reduced)" in out


# ------------------------------------------------------------ loss with MTP


def _batch(B, S, vocab, seed=0):
    toks = np.random.default_rng(seed).integers(2, vocab, (B, S + 1)).astype(np.int32)
    return toks[:, :-1], toks[:, 1:]


@functools.cache
def _reference_loss(dtype: str):
    """(loss, gradient leaves as numpy, the MoE layers' expert choices) of
    the reference's ``loss_fn``, MTP included."""
    jcfg, _ = _cfgs()
    jrt, _ = _runtimes(dtype)
    toks, labels = _batch(2, 32, jcfg.vocab, seed=17)
    batch = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    with _recording_top_k() as rec:
        loss, grads = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, jrt, batch)))(
            _model(dtype)[0])
        jax.effects_barrier()
    return float(loss), [np.asarray(g) for g in jax.tree.leaves(grads)], rec


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_with_mtp_value_and_grads_match_reference(dtype):
    """Every leaf, the ``mtp`` subtree's included, gets the reference's
    gradient (in bfloat16 with the reference's expert choices replayed);
    the MTP term adds 0.3 of its loss (the loss without the subtree is the
    next-token CE alone)."""
    _, pcfg = _cfgs()
    _, prt = _runtimes(dtype)
    toks, labels = _batch(2, 32, pcfg.vocab, seed=17)
    batch = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)}
    params = lm_params_from_numpy(jax.tree.map(np.asarray, _model(dtype)[0]), CPU)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    jloss, jgrads, rec = _reference_loss(dtype)
    n_moe = pcfg.n_layers - pcfg.moe.first_dense_layers
    assert len(rec) == n_moe
    counts.reset()
    replay = _replaying(rec) if dtype == "bfloat16" else contextlib.nullcontext([])
    with replay:
        loss = p_loss_fn(params, pcfg, prt, batch)
    grads = torch.autograd.grad(loss, leaves)
    assert counts.PLAIN_CALLS["moe_gmm_bwd"] == 3 * n_moe
    assert [g.dtype for g in grads] == [p.dtype for p in leaves]
    assert len(grads) == len(jgrads)
    assert all(bool(torch.isfinite(g).all()) and bool(g.abs().max() > 0) for g in grads)
    if dtype == "float32":
        assert abs(float(loss.detach()) - jloss) <= F32 * jloss
    else:
        assert abs(float(loss.detach()) - jloss) <= BF16_LOSS
    paths = _leaf_paths(params)
    for path, got, want in zip(paths, grads, jgrads):
        try:
            _assert_scaled(got, want, F32 if dtype == "float32" else BF16)
        except AssertionError as err:
            raise AssertionError(f"{'.'.join(path)}: {err}") from None
    with torch.no_grad():
        no_mtp = {k: v for k, v in params.items() if k != "mtp"}
        ce = float(p_loss_fn(no_mtp, pcfg, prt, batch))
    assert float(loss.detach()) > ce
