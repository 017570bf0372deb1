"""The enc-dec family of the port (seamless-m4t-medium) against the JAX
package, on the CPU.

The model is ``reduced(get_arch("seamless-m4t-medium"))``: 2 encoder and 2
decoder layers, d_model 128, 4 heads of 32 (4 KV heads, G = 1), d_ff 256,
vocab 512. Its weights are the reference's ``init_params(...,
PRNGKey(0))``, carried over with ``convert.lm_params_from_numpy``; the
encoder input ``enc_embeds`` (the audio frontend's stand-in) and the
decoder tokens are drawn by numpy from a seed, with an encoder length (24)
other than the decoder's (16), so cross-attention runs at Sq != Sk. The
reference's flash route runs its Pallas kernels in interpret mode; the
port's runs the plain versions of K4-K7 and K10/K11 (a CPU tensor takes
them).

The reference has no function that fills the encoder cache (its serving
engine attends over zeros), so the decode tests fill ``enc_k`` and
``enc_v`` themselves, each package's from its own encoder output through
each layer's ``xattn`` ``wk`` and ``wv``.

Tolerances, relative to the largest magnitude of the reference's result:
float32 1e-5 (another summation order); bfloat16 logits by their softmax
within 5e-2 (``tests/test_decode_consistency.py``'s bound), the loss within
5e-3 and every gradient leaf within 5e-2 of its scale
(``tests/test_torch_train.py``'s bounds).
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.flash_attn.kernel import flash_fwd_pallas
from repro.models import Runtime as JRuntime
from repro.models import attention as JA
from repro.models import blocks as JB
from repro.models import build_param_specs as j_specs
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import init_params as j_init_params
from repro.models import loss_fn as j_loss_fn
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import configs as PC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import counts
from repro_torch.kernels.flash_attn import ops as flash_ops
from repro_torch.models import Runtime as PRuntime
from repro_torch.models import build_param_specs as p_specs
from repro_torch.models import decode_step as p_decode
from repro_torch.models import forward as p_forward
from repro_torch.models import init_cache as p_init_cache
from repro_torch.models import loss_fn as p_loss_fn
from repro_torch.models import model as PM
from repro_torch.models.params import tree_leaves, tree_map
from repro_torch.serving import Request as PRequest
from repro_torch.serving import ServingEngine as PEngine
from repro_torch.train import make_prefill_step

CPU = torch.device("cpu")
F32 = 1e-5
SOFTMAX_BOUND = 5e-2
BF16_LOSS = 5e-3
BF16_GRAD = 5e-2
ARCH = "seamless-m4t-medium"
B, S, SE = 2, 16, 24          # batch, decoder tokens, encoder frames
RT_KW = dict(remat="none", attn_chunk=8, q_block=8, kv_block=8, act_shard=False)
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


def _assert_logits(got, want, dtype: str):
    if dtype == "float32":
        _assert_scaled(got, want)
    else:
        assert _softmax_err(got, want) <= SOFTMAX_BOUND


def _runtimes(dtype: str, impl: str = "xla"):
    kw = dict(RT_KW, param_dtype=dtype, compute_dtype=dtype, attn_impl=impl)
    return JRuntime(**kw), PRuntime(**kw)


def _cfgs():
    return RC.reduced(RC.get_arch(ARCH)), PC.reduced(PC.get_arch(ARCH))


@functools.cache
def _model(dtype: str):
    """(reference params, port params) of the reduced model; the tests read
    the weights and never write them."""
    jp = j_init_params(j_specs(_cfgs()[0], _runtimes(dtype)[0]), jax.random.PRNGKey(0))
    return jp, lm_params_from_numpy(jax.tree.map(np.asarray, jp), CPU)


def _inputs(seed: int = 0):
    """(decoder tokens (B, S), labels (B, S), enc_embeds (B, SE, d) float32)."""
    rng = np.random.default_rng(seed)
    toks = rng.integers(2, _cfgs()[0].vocab, (B, S + 1)).astype(np.int32)
    enc = rng.standard_normal((B, SE, _cfgs()[0].d_model)).astype(np.float32)
    return toks[:, :-1], toks[:, 1:], enc


def _batches(dtype: str, seed: int = 0):
    toks, labels, enc = _inputs(seed)
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
          "enc_embeds": jnp.asarray(enc, JDT[dtype])}
    pb = {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels),
          "enc_embeds": torch.from_numpy(enc).to(getattr(torch, dtype))}
    return jb, pb


# ------------------------------------------------------------------ specs


def test_param_specs_match_the_reference():
    jcfg, pcfg = _cfgs()
    for cfg_j, cfg_p in ((jcfg, pcfg), (RC.get_arch(ARCH), PC.get_arch(ARCH))):
        js, ps = j_specs(cfg_j, JRuntime()), p_specs(cfg_p, PRuntime())
        flat_j = jax.tree_util.tree_flatten_with_path(
            js, is_leaf=lambda s: hasattr(s, "fan_in_axis"))[0]
        paths = [tuple(k.key for k in path) for path, _ in flat_j]
        assert paths == [p for p in _paths(ps)]
        assert [(s.shape, s.axes, s.init, s.fan_in_axis, str(s.dtype)[6:]) for s in tree_leaves(ps)] \
            == [(s.shape, s.axes, s.init, s.fan_in_axis, jnp.dtype(s.dtype).name)
                for _, s in flat_j]
    full = p_specs(PC.get_arch(ARCH), PRuntime())
    n = sum(int(np.prod(s.shape)) for s in tree_leaves(full))
    # param_count() leaves out the norm gains: 2 a encoder layer, 3 a
    # decoder layer, enc_ln and final_ln
    n_norm = (2 * 12 + 3 * 12 + 2) * 1024
    assert n - n_norm == PC.get_arch(ARCH).param_count() == 977_694_720
    assert set(full) == {"embed", "out", "final_ln", "enc_blocks", "blocks", "enc_ln"}
    assert set(full["blocks"]) == {"attn", "xattn", "ffn", "ln1", "ln2", "ln3"}


def _paths(tree, prefix=()):
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _paths(tree[k], prefix + (k,))]
    return [prefix]


# ---------------------------------------------------------------- forward


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_reference(impl, dtype):
    jcfg, pcfg = _cfgs()
    jrt, prt = _runtimes(dtype, impl)
    jp, pp = _model(dtype)
    jb, pb = _batches(dtype)
    want = j_forward(jp, jcfg, jrt, tokens=jb["tokens"], enc_embeds=jb["enc_embeds"])
    counts.reset()
    got = p_forward(pp, pcfg, prt, tokens=pb["tokens"], enc_embeds=pb["enc_embeds"])
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (B, S, pcfg.vocab)
    _assert_logits(got, want, dtype)
    n_attn = pcfg.n_encoder_layers + 2 * pcfg.n_layers
    assert counts.PLAIN_CALLS["flash_attn_fwd"] == (n_attn if impl == "flash" else 0)
    assert counts.PLAIN_CALLS["rmsnorm_fwd"] == 2 * pcfg.n_encoder_layers + 3 * pcfg.n_layers + 2


def test_forward_needs_encoder_inputs():
    _, pcfg = _cfgs()
    _, pp = _model("float32")
    with pytest.raises(ValueError, match="enc_embeds"):
        p_forward(pp, pcfg, _runtimes("float32")[1], tokens=torch.zeros((1, 4), dtype=torch.int32))


def test_prefill_step_passes_the_encoder_inputs():
    _, pcfg = _cfgs()
    _, prt = _runtimes("float32")
    _, pp = _model("float32")
    _, pb = _batches("float32")
    got = make_prefill_step(pcfg, prt)(pp, {"tokens": pb["tokens"], "enc_embeds": pb["enc_embeds"]})
    assert torch.equal(got, p_forward(pp, pcfg, prt, tokens=pb["tokens"],
                                      enc_embeds=pb["enc_embeds"]))


def test_plain_k4_at_the_cross_shape_matches_pallas():
    # the cross-attention's call of K4: non-causal, Sq != Sk, G = 1, D 64
    rng = np.random.default_rng(3)
    q = rng.standard_normal((4, 24, 1, 64)).astype(np.float32)
    k, v = (rng.standard_normal((4, 40, 64)).astype(np.float32) for _ in range(2))
    kw = dict(causal=False, window=None, q_offset=0, q_block=8, kv_block=8)
    jo, jlse = flash_fwd_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True,
                                **kw)
    counts.reset()
    po, plse = flash_ops.flash_fwd(*(torch.from_numpy(a) for a in (q, k, v)), **kw)
    assert counts.PLAIN_CALLS["flash_attn_fwd"] == 1
    _assert_scaled(po, jo, 2e-5)
    _assert_scaled(plse, jlse, 2e-5)


# ------------------------------------------------------------------- loss


@functools.cache
def _ref_loss_and_grads(dtype: str, impl: str):
    jcfg = _cfgs()[0]
    jrt, _ = _runtimes(dtype, impl)
    jp, _ = _model(dtype)
    jb, _ = _batches(dtype, seed=4)
    loss, grads = jax.jit(jax.value_and_grad(lambda p: j_loss_fn(p, jcfg, jrt, jb)))(jp)
    return float(loss), [_np(g) for g in jax.tree.leaves(grads)]


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_loss_fn_value_and_grads_match_reference(impl, dtype):
    _, pcfg = _cfgs()
    _, prt = _runtimes(dtype, impl)
    params = tree_map(lambda p: p.detach().clone().requires_grad_(True), _model(dtype)[1])
    leaves = tree_leaves(params)
    _, pb = _batches(dtype, seed=4)
    counts.reset()
    loss = p_loss_fn(params, pcfg, prt, pb)
    grads = torch.autograd.grad(loss, leaves)
    n_attn = pcfg.n_encoder_layers + 2 * pcfg.n_layers
    for k in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
        assert counts.PLAIN_CALLS[k] == (n_attn if impl == "flash" else 0)
    n_norm = 2 * pcfg.n_encoder_layers + 3 * pcfg.n_layers + 2
    assert counts.PLAIN_CALLS["rmsnorm_fwd"] == counts.PLAIN_CALLS["rmsnorm_bwd"] == n_norm
    jloss, jgrads = _ref_loss_and_grads(dtype, impl)
    assert [g.dtype for g in grads] == [p.dtype for p in leaves]
    assert abs(float(loss.detach()) - jloss) <= (F32 * jloss if dtype == "float32" else BF16_LOSS)
    for got, want in zip(grads, jgrads):
        _assert_scaled(got, want, F32 if dtype == "float32" else BF16_GRAD)


def test_trainer_fails_without_encoder_inputs():
    """The reference's pipeline yields tokens and labels only, so its Trainer
    fails in ``forward`` on the enc-dec family; the port's fails there too."""
    from repro_torch.train.trainer import Trainer

    _, pcfg = _cfgs()
    trainer = Trainer(pcfg, PRuntime(**RT_KW), seq_len=8, global_batch=1, seed=0, device="cpu")
    with pytest.raises(ValueError, match="enc_embeds"):
        trainer.run(1)


# ---------------------------------------------------------------- decode


def _j_encode(jp, cfg, jrt, enc):
    """The reference's encoder (its ``forward``'s ``eblk`` stack and
    ``enc_ln``), written out with its own blocks."""
    e = enc.astype(jrt.cdtype)
    Be, Se = e.shape[:2]
    epos = jnp.broadcast_to(jnp.arange(Se, dtype=jnp.int32)[None], (Be, Se))
    for i in range(cfg.n_encoder_layers):
        p = jax.tree.map(lambda a: a[i], jp["enc_blocks"])
        e = e + JA.attention_apply(p["attn"], JB.rmsnorm(e, p["ln1"], cfg.norm_eps), cfg, jrt,
                                   epos, causal=False)
        e = e + JB.ffn_apply(p["ffn"], JB.rmsnorm(e, p["ln2"], cfg.norm_eps), cfg.act)
    return JB.rmsnorm(e, jp["enc_ln"], cfg.norm_eps)


def _j_cache(jp, cfg, jrt, enc, max_len):
    e = _j_encode(jp, cfg, jrt, enc)
    c = j_init_cache(cfg, jrt, e.shape[0], max_len, enc_len=e.shape[1])
    xa = jp["blocks"]["xattn"]
    c["enc_k"] = jnp.einsum("bsd,ldhe->lbshe", e, xa["wk"]).astype(c["enc_k"].dtype)
    c["enc_v"] = jnp.einsum("bsd,ldhe->lbshe", e, xa["wv"]).astype(c["enc_v"].dtype)
    return c


def _p_cache(pp, cfg, prt, enc, max_len):
    e = PM._encode(pp, cfg, prt, enc)
    c = p_init_cache(cfg, prt, e.shape[0], max_len, enc_len=e.shape[1], device="cpu")
    xa = pp["blocks"]["xattn"]
    for i in range(cfg.n_layers):
        c["enc_k"][i] = torch.einsum("bsd,dhe->bshe", e, xa["wk"][i])
        c["enc_v"][i] = torch.einsum("bsd,dhe->bshe", e, xa["wv"][i])
    return c


def test_init_cache_keys_and_shapes():
    jcfg, pcfg = _cfgs()
    jc = j_init_cache(jcfg, JRuntime(), 3, 10, enc_len=7)
    pc = p_init_cache(pcfg, PRuntime(), 3, 10, enc_len=7, device="cpu")
    assert list(pc) == list(jc) == ["k", "v", "enc_k", "enc_v", "pos"]
    for k in jc:
        assert tuple(pc[k].shape) == jc[k].shape and str(pc[k].dtype)[6:] == jc[k].dtype.name
        assert not bool(pc[k].any())
    assert tuple(pc["enc_k"].shape) == (pcfg.n_layers, 3, 7, pcfg.n_kv_heads, pcfg.head_dim)


def test_encoder_output_matches_reference():
    jcfg, pcfg = _cfgs()
    jrt, prt = _runtimes("float32", "flash")
    jp, pp = _model("float32")
    _, _, enc = _inputs()
    _assert_scaled(PM._encode(pp, pcfg, prt, torch.from_numpy(enc)),
                   _j_encode(jp, jcfg, jrt, jnp.asarray(enc)))


@pytest.mark.parametrize("impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_matches_reference(impl, dtype):
    jcfg, pcfg = _cfgs()
    jrt, prt = _runtimes(dtype, impl)
    jp, pp = _model(dtype)
    toks, _, enc = _inputs(seed=5)
    jc = _j_cache(jp, jcfg, jrt, jnp.asarray(enc, JDT[dtype]), S)
    pc = _p_cache(pp, pcfg, prt, torch.from_numpy(enc).to(getattr(torch, dtype)), S)
    if dtype == "float32":
        _assert_scaled(pc["enc_k"], jc["enc_k"])
        _assert_scaled(pc["enc_v"], jc["enc_v"])
    jstep = jax.jit(lambda c, t: j_decode(jp, jcfg, jrt, c, t))
    for t in range(6):
        counts.reset()
        pl, pc = p_decode(pp, pcfg, prt, pc, torch.from_numpy(toks[:, t:t + 1]))
        jl, jc = jstep(jc, jnp.asarray(toks[:, t:t + 1]))
        _assert_logits(pl, jl, dtype)
        assert counts.PLAIN_CALLS["flash_decode"] == (2 * pcfg.n_layers if impl == "flash" else 0)
        assert counts.PLAIN_CALLS["rmsnorm_fwd"] == 3 * pcfg.n_layers + 1
    assert set(pc) == set(jc)
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    if dtype == "float32":
        for k in ("k", "v"):
            _assert_scaled(pc[k], jc[k])


def test_flash_cross_decode_matches_xla():
    _, pcfg = _cfgs()
    _, xla = _runtimes("float32")
    _, flash = _runtimes("float32", "flash")
    _, pp = _model("float32")
    toks, _, enc = _inputs(seed=6)
    caches = [_p_cache(pp, pcfg, rt, torch.from_numpy(enc), S) for rt in (xla, flash)]
    for t in range(4):
        tok = torch.from_numpy(toks[:, t:t + 1])
        lx, caches[0] = p_decode(pp, pcfg, xla, caches[0], tok)
        lf, caches[1] = p_decode(pp, pcfg, flash, caches[1], tok)
        _assert_scaled(lf, lx)


@pytest.mark.parametrize("package", ["reference", "port"])
def test_decode_matches_forward(package):
    jcfg, pcfg = _cfgs()
    jrt, prt = _runtimes("float32", "flash")
    jp, pp = _model("float32")
    toks, _, enc = _inputs(seed=7)
    if package == "reference":
        full = j_forward(jp, jcfg, jrt, tokens=jnp.asarray(toks), enc_embeds=jnp.asarray(enc))
        c = _j_cache(jp, jcfg, jrt, jnp.asarray(enc), S)
        step = jax.jit(lambda c, t: j_decode(jp, jcfg, jrt, c, t))
        steps = []
        for t in range(S):
            lg, c = step(c, jnp.asarray(toks[:, t:t + 1]))
            steps.append(_np(lg)[:, 0])
    else:
        full = p_forward(pp, pcfg, prt, tokens=torch.from_numpy(toks),
                         enc_embeds=torch.from_numpy(enc))
        c = _p_cache(pp, pcfg, prt, torch.from_numpy(enc), S)
        steps = []
        for t in range(S):
            lg, c = p_decode(pp, pcfg, prt, c, torch.from_numpy(toks[:, t:t + 1]))
            steps.append(_np(lg)[:, 0])
    _assert_scaled(np.stack(steps, axis=1), full)


# --------------------------------------------------------------- serving


def test_serving_engine_tokens_match_reference():
    jcfg, pcfg = _cfgs()
    jrt, prt = _runtimes("float32")
    jp, pp = _model("float32")
    rng = np.random.default_rng(0)
    specs = [(rng.integers(2, pcfg.vocab, n).astype(np.int32), m, temp)
             for n, m, temp in [(9, 6, 0.0), (5, 4, 0.0), (7, 6, 0.8), (3, 5, 0.0), (6, 3, 1.2)]]
    jreqs = [JRequest(prompt=p, max_new_tokens=m, temperature=t) for p, m, t in specs]
    preqs = [PRequest(prompt=p, max_new_tokens=m, temperature=t) for p, m, t in specs]
    JEngine(jp, jcfg, jrt, batch_size=4, max_len=32, seed=0).generate(jreqs)
    counts.reset()
    PEngine(pp, pcfg, prt, batch_size=4, max_len=32, seed=0).generate(preqs)
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert [len(r.generated) for r in preqs] == [m for _, m, _ in specs]
    assert counts.PLAIN_CALLS["flash_decode"] == 0     # the xla route


def test_serve_launcher_runs_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--prompt-len", "4",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("generated 3 tokens") == 2 and "seamless-m4t-medium (reduced)" in out
