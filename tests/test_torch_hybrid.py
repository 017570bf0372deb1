"""The hybrid serving path of the port (zamba2-2.7b, kernel K8) against the
JAX package, on the CPU, where the port runs K8's, K7's and K10's plain
versions.

The model is ``reduced(get_arch("zamba2-2.7b"))`` (6 Mamba2 layers in two
groups of 3, each followed by the shared attention + FFN block; d_model
128, 4 heads of 32, SSD heads of P = 32 with N = 16, chunk 32, d_ff 256,
vocab 512). Weights and inputs are drawn by numpy from a seed and fed to
both packages, the port's through ``convert.lm_params_from_numpy``. The
init rules set ``A_log``, ``D`` and ``dt_bias`` to zero; the tests draw
them too, so that the decay rates, the skip term and the step bias take
part. The reference's SSD kernel runs in Pallas interpret mode, as
``tests/test_kernels.py`` runs it. Reference forwards are computed once a
module and shared.

Tolerances, each with its reason:

- K8's Pallas-form plain version (every product float32) against
  ``ssd_fwd_pallas`` and the sequential ``ssd_ref``: 2e-5 absolute and
  1e-4 relative, the bound of ``tests/test_kernels.py``; with bf16 inputs
  both compute in float32 and round y once, so within one bf16 step (2**-7)
  of y's largest magnitude.
- K8's model form (the reference model's ``_ssd_chunked``): in float32 it
  has no rounding, 1e-5 of the output's scale. In bfloat16 it rounds the
  scores, the masked scores and both parts of y to bf16, so ulp-level
  differences between XLA's and torch's float32 cumsum and exp flip single
  roundings: at least ``FRAC`` of the elements within 1e-5 of the scale and
  every element within one bf16 step of it. The Pallas form fails that gate
  on the same inputs, which shows that it tells the two functions apart.
- The causal conv sums bf16 products in the reference's order: exact.
- Blocks, forward, decode and caches in float32: 1e-5 of their scale; in
  bfloat16 the blocks within 5e-2 of their scale and the logits' softmax
  within 5e-2, the bound of ``tests/test_decode_consistency.py``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.mamba2_ssd.kernel import ssd_fwd_pallas
from repro.kernels.mamba2_ssd.ref import ssd_ref
from repro.models import Runtime as JRuntime
from repro.models import build_param_specs as j_specs
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import mamba2 as JM
from repro.models import param_bytes as j_param_bytes
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import configs as PC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import counts
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.mamba2_ssd import ref as ssd_plain_ref
from repro_torch.models import Runtime as PRuntime
from repro_torch.models import build_param_specs as p_specs
from repro_torch.models import decode_step as p_decode
from repro_torch.models import forward as p_forward
from repro_torch.models import init_cache as p_init_cache
from repro_torch.models import param_bytes as p_param_bytes
from repro_torch.models import mamba2 as PM
from repro_torch.models.params import tree_leaves
from repro_torch.serving import Request as PRequest
from repro_torch.serving import ServingEngine as PEngine

CPU = torch.device("cpu")
ARCH = "zamba2-2.7b"
F32 = 1e-5            # float32 without bf16 roundings: relative to the scale
BF16 = 5e-2           # bfloat16 outputs: relative to their scale
SOFTMAX_BOUND = 5e-2  # bfloat16 logits: max softmax difference
BF16_STEP = 2.0 ** -7
FRAC = 0.95           # model form in bfloat16: share of elements within F32
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _port(tree):
    return lm_params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _scaled_err(got, want) -> np.ndarray:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want) / max(float(np.abs(want).max()), 1e-30)


def _assert_scaled(got, want, tol=F32):
    err = float(_scaled_err(got, want).max())
    assert err <= tol, f"max err {err} of the scale > {tol}"


def _share_within(got, want, tol=F32) -> float:
    return float((_scaled_err(got, want) <= tol).mean())


def _assert_bf16_flips_only(got, want):
    """The model form in bfloat16: at least FRAC of the elements within F32
    of the scale, and every element within one bf16 step of it."""
    err = _scaled_err(got, want)
    share = float((err <= F32).mean())
    assert share >= FRAC, f"only {share} of the elements within {F32} of the scale"
    assert float(err.max()) <= BF16_STEP, f"max err {float(err.max())} > one bf16 step"


def _softmax_err(a, b) -> float:
    pa = torch.softmax(torch.from_numpy(_np(a)), dim=-1)
    pb = torch.softmax(torch.from_numpy(_np(b)), dim=-1)
    return float((pa - pb).abs().max())


def _runtimes(dtype: str):
    kw = dict(remat="none", act_shard=False, param_dtype=dtype, compute_dtype=dtype)
    return JRuntime(**kw), PRuntime(**kw)


def _cfgs():
    return RC.reduced(RC.get_arch(ARCH)), PC.reduced(PC.get_arch(ARCH))


def _np_tree(specs, seed: int):
    """numpy weights for a reference spec tree: ones where the spec says, a
    normal draw elsewhere (zeros-initialised leaves, A_log, D and dt_bias, at
    scale 0.5), times 1/sqrt(fan_in) (``scaled``) or 0.02, cast to the
    spec's dtype."""
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
def _model(dtype: str):
    """(cfgs, reference params, port params) of the reduced zamba2; the tests
    read the weights and never write them."""
    jcfg, pcfg = _cfgs()
    jrt, _ = _runtimes(dtype)
    tree = _np_tree(j_specs(jcfg, jrt), seed=0)
    return (jcfg, pcfg), jax.tree.map(jnp.asarray, tree), _port(tree)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, (B, S)).astype(np.int32)


@functools.cache
def _ref_forward(dtype: str, B: int, S: int, seed: int) -> np.ndarray:
    """The reference's logits on ``_tokens(B, S, vocab, seed)``, once a module."""
    (jcfg, _), jp, _ = _model(dtype)
    jrt, _ = _runtimes(dtype)
    fwd = jax.jit(lambda t: j_forward(jp, jcfg, jrt, tokens=t))
    return _np(fwd(jnp.asarray(_tokens(B, S, jcfg.vocab, seed))))


def _ssd_inputs(shape, N: int, dtype: str, seed: int):
    """x, B, C at scale 0.5 and the log decay -softplus(normal), as the
    reference's ``test_mamba2_ssd_sweep`` draws them; x, B, C in ``dtype``,
    a float32. ``shape`` is (..., S, P) or (..., S, H, P)."""
    rng = np.random.default_rng(seed)
    bshape = shape[:-1] + (N,)
    x = rng.standard_normal(shape) * 0.5
    Bm, Cm = (rng.standard_normal(bshape) * 0.5 for _ in range(2))
    a = -np.logaddexp(rng.standard_normal(shape[:-1]), 0.0)
    js = [jnp.asarray(t, JDT[dtype]) for t in (x, Bm, Cm)] + [jnp.asarray(a, jnp.float32)]
    return js, [_port(t) for t in js]


# -------------------------------------------------------------------- K8

# (S, P, N, chunk): the reference's sweep; the reduced model's P, N and
# chunk; zamba2-2.7b's P = N = 64 at its chunk of 128; a chunk that halves
# (96 -> 32) and S not a power of two
SSD_CASES = [(64, 8, 4, 16), (128, 16, 8, 32), (64, 32, 16, 32), (256, 64, 64, 128),
             (96, 32, 16, 64), (40, 16, 8, 16)]


@pytest.mark.parametrize("S,P,N,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_pallas_form_matches_pallas_kernel_and_ref(S, P, N, chunk, dtype):
    BH = 3
    (x, Bm, Cm, a), pt = _ssd_inputs((BH, S, P), N, dtype, S + P + N)
    yj, hj = ssd_fwd_pallas(x, Bm, Cm, a, chunk=chunk, interpret=True)
    counts.reset()
    y, h = ssd_ops.ssd_fwd(*pt, chunk=chunk)
    assert counts.PLAIN_CALLS["mamba2_ssd"] == 1 and counts.LAUNCHES["mamba2_ssd"] == 0
    assert y.dtype == TDT[dtype] and h.dtype == torch.float32 and h.shape == (BH, P, N)
    assert torch.equal(ssd_ops.ssd_scan(*pt, chunk=chunk), y)
    np.testing.assert_allclose(_np(h), _np(hj), atol=2e-5, rtol=1e-4)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), _np(yj), atol=2e-5, rtol=1e-4)
        yr, hr = ssd_ref(x[:, :, None], Bm[:, :, None], Cm[:, :, None], a[:, :, None])
        np.testing.assert_allclose(_np(y), _np(yr[:, :, 0]), atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(_np(h), _np(hr[:, 0]), atol=2e-5, rtol=1e-4)
        # the port's copy of the oracle
        yo, ho = ssd_plain_ref.ssd_ref(*(t[:, :, None] for t in pt))
        np.testing.assert_allclose(_np(yo[:, :, 0]), _np(yr[:, :, 0]), atol=2e-5, rtol=1e-4)
        np.testing.assert_allclose(_np(ho[:, 0]), _np(hr[:, 0]), atol=2e-5, rtol=1e-4)
    else:   # both compute in float32 from the same bf16 inputs, then round y
        _assert_scaled(y, yj, BF16_STEP)


@pytest.mark.parametrize("S,P,N,chunk", SSD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_model_form_matches_reference_ssd_chunked(S, P, N, chunk, dtype):
    B, H = 2, 3
    js, pt = _ssd_inputs((B, S, H, P), N, dtype, 5 * S + P + N)
    want = JM._ssd_chunked(*js, chunk)
    counts.reset()
    got, h = ssd_ops.ssd_heads(*pt, chunk=chunk)
    assert counts.PLAIN_CALLS["mamba2_ssd"] == 1
    assert got.dtype == TDT[dtype] and h.shape == (B, H, P, N)
    assert torch.equal(PM._ssd_chunked(*pt, chunk), got)
    if dtype == "float32":
        _assert_scaled(got, want)
    else:
        _assert_bf16_flips_only(got, want)


def test_ssd_gate_tells_the_two_forms_apart():
    """In bfloat16 the Pallas form (every product float32, y rounded once)
    differs from the reference model's function far more often than the
    model-form gate allows."""
    B, S, H, P, N = 2, 128, 3, 32, 16
    js, pt = _ssd_inputs((B, S, H, P), N, "bfloat16", 13)
    want = JM._ssd_chunked(*js, 32)
    y_pallas, _ = ssd_ops._ssd(*pt, 32, False)
    assert _share_within(y_pallas, want) < FRAC
    _assert_bf16_flips_only(ssd_ops.ssd_heads(*pt, chunk=32)[0], want)


def test_ssd_reads_views_of_a_wider_row():
    """B and C split from one projection (strided rows) give what their
    contiguous copies give."""
    B, S, H, P, N = 2, 64, 3, 16, 8
    js, (x, Bm, Cm, a) = _ssd_inputs((B, S, H, P), N, "float32", 3)
    wide = torch.cat([Bm.reshape(B, S, H * N), Cm.reshape(B, S, H * N), torch.ones(B, S, 5)], -1)
    Bv = wide[..., :H * N].reshape(B, S, H, N)
    Cv = wide[..., H * N:2 * H * N].reshape(B, S, H, N)
    assert not Bv.is_contiguous()
    got = ssd_ops.ssd_heads(x, Bv, Cv, a, chunk=32)
    want = ssd_ops.ssd_heads(x, Bm, Cm, a, chunk=32)
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_ssd_cut_chunk_is_the_references_halving():
    for S in range(1, 300):
        for chunk in (1, 16, 32, 64, 128):
            want = min(chunk, S)
            while S % want:
                want //= 2
            assert ssd_ops.cut_chunk(chunk, S) == want


def test_ssd_refuses_what_the_kernel_does_not_take():
    def args(B=1, S=8, H=2, P=16, N=8, dtype=torch.float32):
        return [torch.zeros((B, S, H, P), dtype=dtype), torch.zeros((B, S, H, N), dtype=dtype),
                torch.zeros((B, S, H, N), dtype=dtype), torch.zeros((B, S, H))]

    with pytest.raises(ValueError, match="P = 65"):
        ssd_ops.ssd_heads(*args(P=65), chunk=8)
    with pytest.raises(ValueError, match="N = 80"):
        ssd_ops.ssd_heads(*args(N=80), chunk=8)
    with pytest.raises(ValueError, match="chunk 256 > 128"):
        ssd_ops.ssd_heads(*args(S=256), chunk=256)
    with pytest.raises(TypeError, match="not supported"):
        ssd_ops.ssd_heads(*args(dtype=torch.float16), chunk=8)
    a = args()
    a[1] = torch.zeros((1, 8, 2, 8), dtype=torch.bfloat16)
    with pytest.raises(TypeError, match="dtype"):
        ssd_ops.ssd_heads(*a, chunk=8)
    a = args()
    a[0] = torch.zeros((1, 8, 16, 2)).transpose(2, 3)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_heads(*a, chunk=8)
    a = args()
    a[3] = torch.zeros((1, 2, 8)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        ssd_ops.ssd_heads(*a, chunk=8)
    a = args()
    a[0].requires_grad_(True)
    with pytest.raises(NotImplementedError, match=r"no backward.*ROADMAP.md item 10\(c\)"):
        ssd_ops.ssd_heads(*a, chunk=8)
    with torch.no_grad():
        ssd_ops.ssd_heads(*a, chunk=8)
    with pytest.raises(ValueError, match=r"\(BH, S, P\)"):
        ssd_ops.ssd_scan(*(t[0] for t in args()[:3]), torch.zeros((8, 2, 1)))
    counts.reset()
    with pytest.raises(ValueError, match="needs tensors on the card"):
        ssd_ops.ssd_cuda(*args(), 8, True)
    assert counts.LAUNCHES["mamba2_ssd"] == 0


# ----------------------------------------------------------------- blocks


def _block(dtype: str, seed: int, S: int = 64):
    (jcfg, pcfg), jp, pp = _model(dtype)
    x = np.random.default_rng(seed).standard_normal((2, S, jcfg.d_model))
    xj = jnp.asarray(x, JDT[dtype])
    mj = jax.tree.map(lambda a: a[1], jp["blocks"]["mamba"])
    mp = {k: v[1] for k, v in pp["blocks"]["mamba"].items()}
    return (jcfg, pcfg), mj, mp, xj, _port(xj)


def test_causal_conv_matches_reference_exactly():
    """bf16 products summed in the reference's order, with and without a
    carried state."""
    rng = np.random.default_rng(4)
    xbc = jnp.asarray(rng.standard_normal((2, 40, 48)), jnp.bfloat16)
    w = jnp.asarray(rng.standard_normal((4, 48)) * 0.5, jnp.bfloat16)
    st = jnp.asarray(rng.standard_normal((2, 3, 48)), jnp.bfloat16)
    for state in (None, st):
        oj, sj = JM._causal_conv(xbc, w, state)
        op, sp = PM._causal_conv(_port(xbc), _port(w), None if state is None else _port(state))
        assert op.dtype == torch.bfloat16
        np.testing.assert_array_equal(_np(op), _np(oj))
        np.testing.assert_array_equal(_np(sp), _np(sj))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_apply_matches_reference(dtype):
    (jcfg, pcfg), mj, mp, xj, xp = _block(dtype, 1)
    jrt, prt = _runtimes(dtype)
    want = JM.mamba2_apply(mj, xj, jcfg, jrt)
    counts.reset()
    got = PM.mamba2_apply(mp, xp, pcfg, prt)
    assert counts.PLAIN_CALLS["mamba2_ssd"] == 1 and counts.PLAIN_CALLS["rmsnorm_fwd"] == 1
    assert got.dtype == xp.dtype
    _assert_scaled(got, want, F32 if dtype == "float32" else BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_decode_apply_and_init_state_match_reference(dtype):
    (jcfg, pcfg), mj, mp, xj, xp = _block(dtype, 2)
    jrt, prt = _runtimes(dtype)
    sj = JM.mamba2_init_state(jcfg, 2, JDT[dtype])
    sp = PM.mamba2_init_state(pcfg, 2, TDT[dtype])
    assert set(sp) == set(sj) == {"ssm", "conv"}
    for key in sj:
        assert tuple(sp[key].shape) == sj[key].shape and not sp[key].any()
        assert str(sp[key].dtype).split(".")[-1] == jnp.dtype(sj[key].dtype).name
    outs_j, outs_p = [], []
    for t in range(6):   # a few steps, so the carried states are not zero
        oj, sj = JM.mamba2_decode_apply(mj, xj[:, t:t + 1], sj, jcfg, jrt)
        op, sp = PM.mamba2_decode_apply(mp, xp[:, t:t + 1], sp, pcfg, prt)
        outs_j.append(_np(oj))
        outs_p.append(_np(op))
    tol = F32 if dtype == "float32" else BF16
    _assert_scaled(np.stack(outs_p), np.stack(outs_j), tol)
    _assert_scaled(sp["ssm"], sj["ssm"], tol)
    assert sp["ssm"].dtype == torch.float32
    _assert_scaled(sp["conv"], sj["conv"], tol)


def test_mamba2_decode_matches_its_forward_in_float32():
    """The recurrence and the chunked form compute one function where
    nothing rounds to bf16."""
    (_, pcfg), _, mp, _, xp = _block("float32", 3, S=40)
    _, prt = _runtimes("float32")
    fwd = PM.mamba2_apply(mp, xp, pcfg, prt)
    st = PM.mamba2_init_state(pcfg, 2)
    dec = []
    for t in range(xp.shape[1]):
        o, st = PM.mamba2_decode_apply(mp, xp[:, t:t + 1], st, pcfg, prt)
        dec.append(o)
    _assert_scaled(torch.cat(dec, 1), fwd)


# ------------------------------------------------------------- whole model


def test_param_specs_and_bytes_match_at_full_width():
    jcfg, pcfg = RC.get_arch(ARCH), PC.get_arch(ARCH)
    js, ps = j_specs(jcfg, JRuntime()), p_specs(pcfg, PRuntime())
    flat_j = jax.tree.leaves(js, is_leaf=lambda s: hasattr(s, "fan_in_axis"))
    flat_p = tree_leaves(ps)
    assert [(s.shape, s.axes, s.init, s.fan_in_axis, str(s.dtype).split(".")[-1])
            for s in flat_p] == \
        [(s.shape, s.axes, s.init, s.fan_in_axis, jnp.dtype(s.dtype).name) for s in flat_j]
    n = p_param_bytes(ps)
    assert n == j_param_bytes(js)
    # per Mamba2 layer, in bf16: w_in d x (2 di + 2 H N + H), w_out di x d, the
    # conv 4 x (di + 2 H N), the gated norm di and the pre-norm d; A_log, D
    # and dt_bias in float32. The shared block once: q, k, v, o (d x d each),
    # the swiglu FFN 3 d d_ff and two norms. Embedding, untied head, final norm.
    d, di, H, N, L, f, V = 2560, 5120, 80, 64, 54, 10240, 32000
    mamba = 2 * (d * (2 * di + 2 * H * N + H) + di * d + 4 * (di + 2 * H * N) + di + d) + 4 * 3 * H
    shared = 2 * (4 * d * d + 3 * d * f + 2 * d)
    assert n == L * mamba + shared + 2 * (2 * V * d + d)
    assert round(n / 1e9, 2) == 7.64


def test_convert_carries_the_hybrid_tree():
    _, jp, pp = _model("bfloat16")
    assert set(pp) == {"embed", "final_ln", "out", "blocks", "shared_attn"}
    assert set(pp["shared_attn"]) == {"attn", "ffn", "ln1", "ln2"}
    m = pp["blocks"]["mamba"]
    assert m["A_log"].dtype == torch.float32 and m["w_in"].dtype == torch.bfloat16
    np.testing.assert_array_equal(m["D"].numpy(), np.asarray(jp["blocks"]["mamba"]["D"]))
    for got, want in ((m["w_conv"], jp["blocks"]["mamba"]["w_conv"]),
                      (pp["shared_attn"]["attn"]["wq"], jp["shared_attn"]["attn"]["wq"])):
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      np.asarray(want).view(np.int16))


@pytest.mark.parametrize("S", [64, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(S, dtype):
    """S = 64 is two chunks of 32; S = 48 halves the chunk to 16."""
    (_, pcfg), _, pp = _model(dtype)
    _, prt = _runtimes(dtype)
    want = _ref_forward(dtype, 2, S, S)
    counts.reset()
    got = p_forward(pp, pcfg, prt, tokens=torch.from_numpy(_tokens(2, S, pcfg.vocab, S)))
    L, groups = pcfg.n_layers, pcfg.n_layers // pcfg.attn_every
    assert counts.PLAIN_CALLS["mamba2_ssd"] == L
    assert counts.PLAIN_CALLS["rmsnorm_fwd"] == 2 * L + 2 * groups + 1
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (2, S, pcfg.vocab)
    if dtype == "float32":
        _assert_scaled(got, want)
    else:
        assert _softmax_err(got, want) < SOFTMAX_BOUND


def _teacher_force(step, cache, tokens, to_input):
    out = []
    for t in range(tokens.shape[1]):
        lg, cache = step(cache, to_input(tokens[:, t:t + 1]))
        out.append(_np(lg[:, 0]))
    return np.stack(out, axis=1), cache


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_step_logits_and_caches_match_reference(dtype):
    (jcfg, pcfg), jp, pp = _model(dtype)
    jrt, prt = _runtimes(dtype)
    tokens = _tokens(2, 10, jcfg.vocab, seed=3)
    jc0, pc0 = j_init_cache(jcfg, jrt, 2, 16), p_init_cache(pcfg, prt, 2, 16, device="cpu")
    assert set(pc0) == set(jc0) == {"ssm", "conv", "attn_k", "attn_v", "pos"}
    for key in jc0:
        assert tuple(pc0[key].shape) == jc0[key].shape
        assert str(pc0[key].dtype).split(".")[-1] == jnp.dtype(jc0[key].dtype).name
    jstep = jax.jit(lambda c, t: j_decode(jp, jcfg, jrt, c, t))
    want, jc = _teacher_force(jstep, jc0, tokens, jnp.asarray)
    counts.reset()
    got, pc = _teacher_force(lambda c, t: p_decode(pp, pcfg, prt, c, t), pc0, tokens,
                             torch.from_numpy)
    L, groups = pcfg.n_layers, pcfg.n_layers // pcfg.attn_every
    assert counts.PLAIN_CALLS["rmsnorm_fwd"] == (2 * L + 2 * groups + 1) * 10
    assert counts.PLAIN_CALLS["mamba2_ssd"] == 0
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    if dtype == "float32":
        _assert_scaled(got, want)
        for key in ("ssm", "conv", "attn_k", "attn_v"):
            _assert_scaled(pc[key], jc[key])
    else:
        assert _softmax_err(got, want) < SOFTMAX_BOUND
        for key in ("ssm", "conv", "attn_k", "attn_v"):
            _assert_scaled(pc[key], jc[key], BF16)


@pytest.mark.parametrize("attn_impl", ["xla", "flash"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_decode_matches_port_forward(dtype, attn_impl):
    """The chunked form against the recurrence, both in the port, on both
    attention routes (``flash`` runs K7's plain version in decode): in
    float32 one function, 1e-5. In bfloat16 the forward rounds x * dt and
    the model form's parts to bf16 and decode does not, so the logits
    differ by about 0.06 of their largest magnitude here, as the reference's
    own decode and forward do on the same weights; their softmax is held to
    the bound of ``tests/test_decode_consistency.py``."""
    (_, pcfg), _, pp = _model(dtype)
    _, prt = _runtimes(dtype)
    prt = PRuntime(**{**prt.__dict__, "attn_impl": attn_impl})
    tokens = _tokens(1, 40, pcfg.vocab, seed=5)
    par = p_forward(pp, pcfg, prt, tokens=torch.from_numpy(tokens))
    counts.reset()
    dec, _ = _teacher_force(lambda c, t: p_decode(pp, pcfg, prt, c, t),
                            p_init_cache(pcfg, prt, 1, 40, device="cpu"), tokens,
                            torch.from_numpy)
    groups = pcfg.n_layers // pcfg.attn_every
    assert counts.PLAIN_CALLS["flash_decode"] == (40 * groups if attn_impl == "flash" else 0)
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
    counts.reset()
    PEngine(pp, pcfg, prt, batch_size=4, max_len=32, seed=3).generate(preqs)
    assert counts.PLAIN_CALLS["mamba2_ssd"] == 0 and counts.PLAIN_CALLS["rmsnorm_fwd"] > 0
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert all(r.done for r in preqs)


def test_serve_launcher_runs_zamba2_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--prompt-len", "4",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("generated 3 tokens") == 2 and "zamba2-2.7b (reduced)" in out


def test_hybrid_cache_is_updated_in_place():
    (_, pcfg), _, pp = _model("float32")
    _, prt = _runtimes("float32")
    cache = p_init_cache(pcfg, prt, 2, 8, device="cpu")
    held = {k: cache[k] for k in ("ssm", "conv", "attn_k", "attn_v")}
    _, out = p_decode(pp, pcfg, prt, cache, torch.from_numpy(_tokens(2, 1, pcfg.vocab)))
    for k, t in held.items():
        assert out[k] is t and bool(t.any()), k
    assert out["pos"].tolist() == [1, 1]
