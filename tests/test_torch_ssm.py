"""The SSM serving path of the port (rwkv6-7b, kernel K12) against the JAX
package, on the CPU, where the port runs K12's and K10's plain versions.

The model is ``reduced(get_arch("rwkv6-7b"))`` (4 layers, d_model 128, 4
WKV heads of K = 32, chunk 32, d_ff 256, vocab 512). Weights and inputs are
drawn by numpy from a seed and fed to both packages, the port's through
``convert.lm_params_from_numpy``. The init rules set ``u_bonus`` and the
token-shift mixes to zero; the tests draw them too, so that the bonus term
and per-channel mixes are exercised. The reference's WKV kernel runs in
Pallas interpret mode, as ``tests/test_kernels.py`` runs it.

Tolerances, each with its reason:

- K12's Pallas-form plain version (every product float32) against
  ``wkv_fwd_pallas`` and the sequential ``wkv_ref``: 3e-5 absolute and 1e-4
  relative, the bound of ``tests/test_kernels.py``.
- The model form (the reference model's ``_wkv_chunked``, which rounds r_f,
  k_f, att and v to bfloat16 before its two intra-chunk products) computes
  a function that jumps by one bf16 step wherever the two packages' float32
  intermediates fall on either side of a rounding boundary, and they differ
  at the ulp level: XLA's cumsum associates otherwise than torch's, and the
  exponent arguments reach about 64, so one ulp there is tens of ulps of
  exp. So in float32 at least ``FRAC`` of the elements must agree within
  1e-5 of the output's scale, and every element within one bf16 step of it
  (2**-7); the float32-products form of the same inputs fails the first
  test, which shows that the gate tells the two functions apart.
- The decode step has no bf16 rounding inside (the recurrence is float32):
  its logits and caches agree within 1e-5 of their scale.
- Everything around the WKV has no bf16 rounding in float32: with both
  packages' ``_wkv_chunked`` in the Pallas kernel's function (float32
  products), ``rwkv6_apply`` and the forward's logits agree within 1e-5 of
  their scale. Through the port's own WKV the forward's logits carry its flips
  through four layers of state: within ``FWD_F32`` of their scale and
  their softmax within ``FWD_SOFTMAX``; in bfloat16 the softmax within
  5e-2, the bound of ``tests/test_decode_consistency.py``.
"""
from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.rwkv6_wkv.kernel import wkv_fwd_pallas
from repro.kernels.rwkv6_wkv.ref import wkv_ref
from repro.models import Runtime as JRuntime
from repro.models import build_param_specs as j_specs
from repro.models import decode_step as j_decode
from repro.models import forward as j_forward
from repro.models import init_cache as j_init_cache
from repro.models import param_bytes as j_param_bytes
from repro.models import rwkv6 as J6
from repro.serving.engine import Request as JRequest
from repro.serving.engine import ServingEngine as JEngine
from repro_torch import configs as PC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import counts
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.models import Runtime as PRuntime
from repro_torch.models import build_param_specs as p_specs
from repro_torch.models import decode_step as p_decode
from repro_torch.models import forward as p_forward
from repro_torch.models import init_cache as p_init_cache
from repro_torch.models import param_bytes as p_param_bytes
from repro_torch.models import rwkv6 as P6
from repro_torch.models.params import tree_leaves
from repro_torch.serving import Request as PRequest
from repro_torch.serving import ServingEngine as PEngine

CPU = torch.device("cpu")
ARCH = "rwkv6-7b"
F32 = 1e-5            # float32 without bf16 roundings: relative to the scale
BF16 = 5e-2           # bfloat16 outputs: relative to their scale
SOFTMAX_BOUND = 5e-2  # bfloat16 logits: max softmax difference
BF16_STEP = 2.0 ** -7
FRAC = 0.95           # model-form float32: share of elements within F32
FWD_F32, FWD_SOFTMAX = 2e-2, 5e-3
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
    """The model form in float32: at least FRAC of the elements within F32
    of the scale, and every element within one bf16 step of it."""
    err = _scaled_err(got, want)
    share = float((err <= F32).mean())
    assert share >= FRAC, f"only {share} of the elements within {F32} of the scale"
    assert float(err.max()) <= BF16_STEP, f"max err {float(err.max())} > one bf16 step"


def _softmax_err(a, b) -> float:
    pa = torch.softmax(torch.from_numpy(_np(a)), dim=-1)
    pb = torch.softmax(torch.from_numpy(_np(b)), dim=-1)
    return float((pa - pb).abs().max())


def _float32_wkv(monkeypatch):
    """Both packages' ``_wkv_chunked`` replaced by the Pallas kernel's
    function (every product float32, no bf16 rounding): the reference's
    ``wkv_fwd_pallas`` in interpret mode and the port's plain version of it,
    which the K12 tests above hold to each other. Without the bf16 roundings
    that flip at ulp-level differences of the inputs, a comparison sees the
    code around the WKV."""
    def ref(r, k, v, w, u, chunk):
        B, S, H, K = r.shape

        def bh(t):
            return t.transpose(0, 2, 1, 3).reshape(B * H, S, K)

        u_bh = jnp.broadcast_to(u[None], (B, H, K)).reshape(B * H, K)
        y, _ = wkv_fwd_pallas(bh(r), bh(k), bh(v), bh(w), u_bh, chunk=chunk, interpret=True)
        return y.reshape(B, H, S, K).transpose(0, 2, 1, 3)

    monkeypatch.setattr(J6, "_wkv_chunked", ref)
    monkeypatch.setattr(P6, "_wkv_chunked",
                        lambda r, k, v, w, u, chunk: wkv_ops._wkv(r, k, v, w, u[None], chunk,
                                                                  False)[0])


def _runtimes(dtype: str):
    kw = dict(remat="none", act_shard=False, param_dtype=dtype, compute_dtype=dtype)
    return JRuntime(**kw), PRuntime(**kw)


def _cfgs():
    return RC.reduced(RC.get_arch(ARCH)), PC.reduced(PC.get_arch(ARCH))


def _np_tree(specs, seed: int):
    """numpy weights for a reference spec tree: ones where the spec says, a
    normal draw elsewhere (zeros-initialised leaves, ``u_bonus`` and the
    mixes, at scale 0.5), times 1/sqrt(fan_in) (``scaled``) or 0.02, cast to
    the spec's dtype."""
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
    """(cfgs, reference params, port params) of the reduced rwkv6; the tests
    read the weights and never write them."""
    jcfg, pcfg = _cfgs()
    jrt, _ = _runtimes(dtype)
    tree = _np_tree(j_specs(jcfg, jrt), seed=0)
    return (jcfg, pcfg), jax.tree.map(jnp.asarray, tree), _port(tree)


def _tokens(B, S, vocab, seed=0):
    return np.random.default_rng(seed).integers(2, vocab, (B, S)).astype(np.int32)


def _wkv_inputs(shape, dtype: str, seed: int, u_shape):
    """r, k, v (scale 0.5), the model's floored log decay w, u (scale 0.3),
    as in the reference's ``test_rwkv6_wkv_sweep``, in ``dtype`` (w too)."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape) * 0.5 for _ in range(3))
    w = np.maximum(-np.logaddexp(rng.standard_normal(shape), 0.0) - 0.1, -2.0)
    u = rng.standard_normal(u_shape) * 0.3
    js = [jnp.asarray(a, JDT[dtype]) for a in (r, k, v, w)] + [jnp.asarray(u, jnp.float32)]
    return js, [_port(a) for a in js]


# ------------------------------------------------------------------- K12

# (S, K, chunk): the reference's sweep, a chunk of 64 at K = 64, and S not a
# multiple of the chunk (48 -> 16, 40 -> 8, 33 -> 1: the reference's halving)
WKV_CASES = [(64, 16, 16), (128, 32, 32), (128, 64, 64), (48, 32, 32), (40, 8, 16), (33, 16, 16)]


@pytest.mark.parametrize("S,K,chunk", WKV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_pallas_form_matches_pallas_kernel_and_ref(S, K, chunk, dtype):
    BH = 3
    (r, k, v, w, u), pt = _wkv_inputs((BH, S, K), dtype, S + K, (BH, K))
    yj, sj = wkv_fwd_pallas(r, k, v, w, u, chunk=chunk, interpret=True)
    counts.reset()
    y, st = wkv_ops.wkv_fwd(*pt, chunk=chunk)
    assert counts.PLAIN_CALLS["rwkv6_wkv"] == 1 and counts.LAUNCHES["rwkv6_wkv"] == 0
    assert y.dtype == TDT[dtype] and st.dtype == torch.float32 and st.shape == (BH, K, K)
    assert torch.equal(wkv_ops.wkv_scan(*pt, chunk=chunk), y)
    if dtype == "float32":
        np.testing.assert_allclose(_np(y), _np(yj), atol=3e-5, rtol=1e-4)
        def one(rr, kx, vx, wx, ux):   # the oracle, one (b, h) row at a time
            yo, so = wkv_ref(rr[None, :, None], kx[None, :, None], vx[None, :, None],
                             wx[None, :, None], ux[None])
            return yo[0, :, 0], so[0, 0]

        yr, sr = jax.vmap(one)(r, k, v, w, u)
        np.testing.assert_allclose(_np(y), _np(yr), atol=3e-5, rtol=1e-4)
        np.testing.assert_allclose(_np(st), _np(sr), atol=3e-5, rtol=1e-4)
    else:   # both compute in float32 from the same bf16 inputs, then round y
        _assert_scaled(y, yj, BF16_STEP)
    np.testing.assert_allclose(_np(st), _np(sj), atol=3e-5, rtol=1e-4)


@pytest.mark.parametrize("S,K,chunk", WKV_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_model_form_matches_reference_wkv_chunked(S, K, chunk, dtype):
    B, H = 2, 3
    js, pt = _wkv_inputs((B, S, H, K), dtype, 7 * S + K, (H, K))
    js[3], pt[3] = js[3].astype(jnp.float32), pt[3].float()   # the model's w is float32
    want = J6._wkv_chunked(*js, chunk)
    counts.reset()
    got, st = wkv_ops.wkv_heads(*pt, chunk=chunk)
    assert counts.PLAIN_CALLS["rwkv6_wkv"] == 1
    assert got.dtype == TDT[dtype] and st.shape == (B, H, K, K)
    assert torch.equal(P6._wkv_chunked(*pt, chunk), got)
    if dtype == "float32":
        _assert_bf16_flips_only(got, want)
    else:   # flips, then y's own rounding to bf16: within two bf16 steps
        _assert_scaled(got, want, 2 * BF16_STEP)


def test_wkv_gate_tells_the_two_forms_apart():
    """The float32-products form differs from the reference model's function
    nearly everywhere, so the model-form gate would refuse it."""
    B, S, H, K = 2, 64, 3, 32
    js, pt = _wkv_inputs((B, S, H, K), "float32", 11, (H, K))
    want = J6._wkv_chunked(*js, 32)
    y32, _ = wkv_ops._wkv(*pt[:4], pt[4][None], 32, False)
    assert _share_within(y32, want) < 0.5
    _assert_bf16_flips_only(wkv_ops.wkv_heads(*pt, chunk=32)[0], want)


def test_cut_chunk_is_the_references_halving():
    for S in range(1, 130):
        for chunk in (1, 16, 32, 64, 128):
            want = min(chunk, S)
            while S % want:
                want //= 2
            assert wkv_ops.cut_chunk(chunk, S) == want


def test_wkv_refuses_what_the_kernel_does_not_take():
    def args(B=1, S=8, H=2, K=16, dtype=torch.float32):
        t = [torch.zeros((B, S, H, K), dtype=dtype) for _ in range(4)]
        return t + [torch.zeros((H, K))]

    with pytest.raises(ValueError, match="K = 65 > 64"):
        wkv_ops.wkv_heads(*args(K=65), chunk=8)
    with pytest.raises(ValueError, match="chunk 128 > 64"):
        wkv_ops.wkv_heads(*args(S=128), chunk=128)
    with pytest.raises(TypeError, match="not supported"):
        wkv_ops.wkv_heads(*args(dtype=torch.float16), chunk=8)
    a = args()
    a[1] = torch.zeros((1, 8, 2, 15))
    with pytest.raises(ValueError, match="shape"):
        wkv_ops.wkv_heads(*a, chunk=8)
    a = args()
    a[2] = torch.zeros((1, 2, 8, 16)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        wkv_ops.wkv_heads(*a, chunk=8)
    a = args()
    a[4] = torch.zeros((3, 16))
    with pytest.raises(ValueError, match="shape"):
        wkv_ops.wkv_heads(*a, chunk=8)
    # an input that needs a gradient gets one: K12b's plain version, which is
    # autograd of the plain forward, bit for bit
    g = torch.Generator().manual_seed(0)
    a = [torch.randn(t.shape, generator=g) * 0.5 for t in args()]
    a[3] = -torch.rand(a[3].shape, generator=g)                  # a log decay
    leaves = [t.clone().requires_grad_(True) for t in a]
    counts.reset()
    wkv_ops.wkv_heads(*leaves, chunk=8)[0].sum().backward()
    assert counts.PLAIN_CALLS["rwkv6_wkv_bwd"] == 1
    ref = [t.clone().requires_grad_(True) for t in a]
    wkv_ops.wkv_plain(*ref[:4], ref[4][None], 8, True)[0].sum().backward()
    for got, want in zip(leaves, ref):
        assert torch.equal(got.grad, want.grad)
    with torch.no_grad():
        wkv_ops.wkv_heads(*a, chunk=8)
    with pytest.raises(ValueError, match=r"\(BH, S, K\)"):
        wkv_ops.wkv_scan(*(t[0] for t in args()[:4]), torch.zeros((2, 16, 1)))
    counts.reset()
    with pytest.raises(ValueError, match="needs tensors on the card"):
        wkv_ops.wkv_cuda(*args()[:4], args()[4][None], 8, True)
    assert counts.LAUNCHES["rwkv6_wkv"] == 0


# ----------------------------------------------------------------- blocks


def _block(dtype: str, seed: int):
    (jcfg, pcfg), jp, pp = _model(dtype)
    x = np.random.default_rng(seed).standard_normal((2, 64, jcfg.d_model))
    xj = jnp.asarray(x, JDT[dtype])
    tm_j = jax.tree.map(lambda a: a[0], jp["blocks"]["tmix"])
    tm_p = {k: v[0] for k, v in pp["blocks"]["tmix"].items()}
    return (jcfg, pcfg), tm_j, tm_p, xj, _port(xj)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_apply_matches_reference(dtype, monkeypatch):
    (jcfg, pcfg), tm_j, tm_p, xj, xp = _block(dtype, 1)
    jrt, prt = _runtimes(dtype)
    want = J6.rwkv6_apply(tm_j, xj, jcfg, jrt)
    got = P6.rwkv6_apply(tm_p, xp, pcfg, prt)
    assert got.dtype == xp.dtype
    if dtype == "float32":
        _assert_bf16_flips_only(got, want)
        # the parts before the WKV carry no bf16 rounding
        shifted = J6._token_shift(xj)
        for a, b in zip(J6._time_mix(tm_j, xj, jcfg, jrt, shifted),
                        P6._time_mix(tm_p, xp, pcfg, prt, P6._token_shift(xp))):
            _assert_scaled(b, a)
        # nor do the parts after it, given one WKV function on both sides
        _float32_wkv(monkeypatch)
        _assert_scaled(P6.rwkv6_apply(tm_p, xp, pcfg, prt), J6.rwkv6_apply(tm_j, xj, jcfg, jrt))
    else:
        _assert_scaled(got, want, BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rwkv6_decode_apply_and_init_state_match_reference(dtype):
    (jcfg, pcfg), tm_j, tm_p, xj, xp = _block(dtype, 2)
    jrt, prt = _runtimes(dtype)
    sj = J6.rwkv6_init_state(jcfg, 2, JDT[dtype])
    sp = P6.rwkv6_init_state(pcfg, 2, TDT[dtype])
    for key in ("wkv", "shift"):
        assert tuple(sp[key].shape) == sj[key].shape and not sp[key].any()
        assert str(sp[key].dtype).split(".")[-1] == jnp.dtype(sj[key].dtype).name
    outs_j, outs_p = [], []
    for t in range(6):   # a few steps, so the carried state is not zero
        oj, sj = J6.rwkv6_decode_apply(tm_j, xj[:, t:t + 1], sj, jcfg, jrt)
        op, sp = P6.rwkv6_decode_apply(tm_p, xp[:, t:t + 1], sp, pcfg, prt)
        outs_j.append(_np(oj))
        outs_p.append(_np(op))
    tol = F32 if dtype == "float32" else BF16
    _assert_scaled(np.stack(outs_p), np.stack(outs_j), tol)
    _assert_scaled(sp["wkv"], sj["wkv"], tol)
    assert sp["wkv"].dtype == torch.float32
    np.testing.assert_array_equal(_np(sp["shift"]), _np(sj["shift"]))


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
    # per layer: time mix 6 d^2 (r, k, v, g, decay, o) + channel mix 2 d d_ff + d^2, in
    # bf16, plus u_bonus in float32, the mixes and three gains; embed and the untied head
    d, f, L, V = 4096, 14336, 32, 65536
    per_layer = 2 * (7 * d * d + 2 * d * f + 5 * d + 2 * d + 3 * d) + 4 * d
    assert n == L * per_layer + 2 * (2 * V * d + d)
    assert ps["blocks"]["tmix"]["u_bonus"].dtype == torch.float32


def test_convert_carries_the_ssm_tree():
    _, jp, pp = _model("bfloat16")
    tm = pp["blocks"]["tmix"]
    assert tm["u_bonus"].dtype == torch.float32 and tm["w_r"].dtype == torch.bfloat16
    np.testing.assert_array_equal(tm["u_bonus"].numpy(), np.asarray(jp["blocks"]["tmix"]["u_bonus"]))
    for k in ("w_decay", "mix"):
        want = np.asarray(jp["blocks"]["tmix"][k]).view(np.int16)
        np.testing.assert_array_equal(tm[k].view(torch.int16).numpy(), want)
    assert set(pp["blocks"]) == {"tmix", "cmix", "ln1", "ln2"}


@pytest.mark.parametrize("S", [64, 48])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_logits_match_reference(S, dtype, monkeypatch):
    """S = 64 is two chunks of 32; S = 48 halves the chunk to 16."""
    (jcfg, pcfg), jp, pp = _model(dtype)
    jrt, prt = _runtimes(dtype)
    tokens = _tokens(2, S, jcfg.vocab, seed=S)
    want = j_forward(jp, jcfg, jrt, tokens=jnp.asarray(tokens))
    counts.reset()
    got = p_forward(pp, pcfg, prt, tokens=torch.from_numpy(tokens))
    L = pcfg.n_layers
    assert counts.PLAIN_CALLS["rwkv6_wkv"] == L
    assert counts.PLAIN_CALLS["rmsnorm_fwd"] == 3 * L + 1
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (2, S, pcfg.vocab)
    if dtype == "float32":
        _assert_scaled(got, want, FWD_F32)
        assert _softmax_err(got, want) < FWD_SOFTMAX
        # given one WKV function on both sides, the rest of the forward holds 1e-5
        _float32_wkv(monkeypatch)
        _assert_scaled(p_forward(pp, pcfg, prt, tokens=torch.from_numpy(tokens)),
                       j_forward(jp, jcfg, jrt, tokens=jnp.asarray(tokens)))
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
    assert set(pc0) == set(jc0) == {"wkv", "shift1", "shift2", "pos"}
    for key in jc0:
        assert tuple(pc0[key].shape) == jc0[key].shape
        assert str(pc0[key].dtype).split(".")[-1] == jnp.dtype(jc0[key].dtype).name
    jstep = jax.jit(lambda c, t: j_decode(jp, jcfg, jrt, c, t))
    want, jc = _teacher_force(jstep, jc0, tokens, jnp.asarray)
    counts.reset()
    got, pc = _teacher_force(lambda c, t: p_decode(pp, pcfg, prt, c, t), pc0, tokens,
                             torch.from_numpy)
    assert counts.PLAIN_CALLS["rmsnorm_fwd"] == (3 * pcfg.n_layers + 1) * 10
    assert counts.PLAIN_CALLS["rwkv6_wkv"] == 0
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
    if dtype == "float32":
        _assert_scaled(got, want)
        for key in ("wkv", "shift1", "shift2"):
            _assert_scaled(pc[key], jc[key])
    else:
        assert _softmax_err(got, want) < SOFTMAX_BOUND
        for key in ("wkv", "shift1", "shift2"):
            _assert_scaled(pc[key], jc[key], BF16)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_port_decode_matches_port_forward(dtype):
    """The chunked form (bf16 intra-chunk operands) against the float32
    recurrence, both in the port: two functions that differ by those
    roundings, held to the bound ``chip_smoke.py`` starts from on the card,
    5e-2 of the scale, and their softmax as the forward's."""
    (_, pcfg), _, pp = _model(dtype)
    _, prt = _runtimes(dtype)
    tokens = _tokens(1, 40, pcfg.vocab, seed=5)
    par = p_forward(pp, pcfg, prt, tokens=torch.from_numpy(tokens))
    dec, _ = _teacher_force(lambda c, t: p_decode(pp, pcfg, prt, c, t),
                            p_init_cache(pcfg, prt, 1, 40, device="cpu"), tokens,
                            torch.from_numpy)
    _assert_scaled(dec, par, BF16)
    assert _softmax_err(dec, par) < (FWD_SOFTMAX if dtype == "float32" else SOFTMAX_BOUND)


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
    assert counts.PLAIN_CALLS["rwkv6_wkv"] == 0 and counts.PLAIN_CALLS["rmsnorm_fwd"] > 0
    assert [r.generated for r in preqs] == [r.generated for r in jreqs]
    assert all(r.done for r in preqs)


def test_serve_launcher_runs_rwkv6_on_the_cpu(capsys):
    from repro_torch.launch import serve

    serve.main(["--arch", ARCH, "--device", "cpu", "--requests", "2", "--prompt-len", "4",
                "--max-new", "3"])
    out = capsys.readouterr().out
    assert out.count("generated 3 tokens") == 2 and "rwkv6-7b (reduced)" in out


def test_ssm_cache_is_updated_in_place():
    (_, pcfg), _, pp = _model("float32")
    _, prt = _runtimes("float32")
    cache = p_init_cache(pcfg, prt, 2, 8, device="cpu")
    wkv = cache["wkv"]
    _, out = p_decode(pp, pcfg, prt, cache, torch.from_numpy(_tokens(2, 1, pcfg.vocab)))
    assert out["wkv"] is wkv and bool(wkv.any()) and out["pos"].tolist() == [1, 1]
