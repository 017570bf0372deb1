"""Gradient compression of the port against the JAX package, on the CPU.

``int8_roundtrip``, ``topk_mask``, ``compress_grads`` and ``ErrorFeedback``
(``repro_torch.distributed.compression``) against the reference's
``repro.distributed.compression`` on seeded float32 and bfloat16 arrays,
bit for bit: both compute in float32 with IEEE divisions, round half to
even and take the k-th largest magnitude, which no tie-breaking changes.
Then one ``make_train_step`` under each scheme against the reference's, on
the reduced llama3-8b in float32: the loss and the new parameters within
1e-5 of their scale (``tests/test_torch_train.py``'s float32 bound), and
the AdamW moments too, but that under int8 a gradient element that sits
within float32 rounding of a quantisation boundary may take the
neighbouring level in one package (one element in 65536 at this draw).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.distributed import compression as JC
from repro.models import Runtime as JRuntime
from repro.models import build_param_specs as j_specs
from repro.models import init_params as j_init_params
from repro.optim import adamw_init as j_adamw_init
from repro.train.step import make_train_step as j_make_train_step
from repro_torch import configs as PC
from repro_torch.convert import adamw_state_from_numpy, lm_params_from_numpy
from repro_torch.distributed import compression as PCMP
from repro_torch.models import Runtime as PRuntime
from repro_torch.models.params import tree_leaves
from repro_torch.train import make_train_step as p_make_train_step

CPU = torch.device("cpu")
F32 = 1e-5
DTYPES = {"float32": (np.float32, jnp.float32, torch.float32),
          "bfloat16": (np.float32, jnp.bfloat16, torch.bfloat16)}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """The same values in both packages: float32 numpy rounded to ``dtype``."""
    j = jnp.asarray(a, DTYPES[dtype][1])
    return j, torch.from_numpy(np.array(jnp.asarray(j, jnp.float32))).to(DTYPES[dtype][2])


def _bits_equal(got: torch.Tensor, want) -> None:
    assert str(got.dtype)[6:] == jnp.dtype(want.dtype).name
    w = np.asarray(want)
    g = got.view(torch.int16).numpy() if got.dtype == torch.bfloat16 else got.numpy()
    np.testing.assert_array_equal(g.view(np.uint16 if got.dtype == torch.bfloat16
                                         else np.uint32),
                                  w.view(np.uint16 if w.dtype.itemsize == 2 else np.uint32))


def _cases():
    rng = np.random.default_rng(0)
    ties = np.repeat(np.array([3.0, -3.0, 1.0, -1.0, 0.5], np.float32), 20)
    rng.shuffle(ties)
    return {
        "normal": rng.standard_normal((37, 29)).astype(np.float32),
        "wide": (rng.standard_normal((4, 8, 33)) * np.exp(rng.uniform(-12, 4, (4, 8, 33))))
        .astype(np.float32),
        "zeros": np.zeros((5, 7), np.float32),
        "ties": ties.reshape(10, 10),
        "halves": (np.arange(-300, 301, dtype=np.float32) * 0.5),
        "one": np.array([[-2.5]], np.float32),
    }


CASES = sorted(_cases())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_int8_roundtrip_is_the_reference(case, dtype):
    j, p = _pair(_cases()[case], dtype)
    got = PCMP.int8_roundtrip(p)
    _bits_equal(got, JC.int8_roundtrip(j))
    if case == "zeros":
        assert not bool(got.any())      # scale 1.0: zeros stay zeros


@pytest.mark.parametrize("frac", [0.1, 0.37, 1e-9, 1.0])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES)
def test_topk_mask_is_the_reference(case, dtype, frac):
    j, p = _pair(_cases()[case], dtype)
    got = PCMP.topk_mask(p, frac)
    _bits_equal(got, JC.topk_mask(j, frac))
    # what is kept: every element whose magnitude reaches the k-th largest,
    # ties included (zeros stay zeros)
    mag = np.sort(np.abs(_np(p)).reshape(-1))[::-1]
    k = max(int(mag.size * frac), 1)
    want_kept = int(((np.abs(_np(p)) >= mag[k - 1]) & (_np(p) != 0)).sum())
    assert int((got != 0).sum()) == want_kept >= min(k, int((mag != 0).sum()))
    if case == "ties" and frac == 0.1:
        assert want_kept == 40   # k = 10 of 100: the threshold 3.0 is held by 40 elements


@pytest.mark.parametrize("scheme", ["int8", "topk", "none"])
def test_compress_grads_is_the_reference(scheme):
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((6, 9)).astype(np.float32),
            "b": {"c": rng.standard_normal(50).astype(np.float32),
                  "d": np.zeros((3, 3), np.float32)},
            "e": rng.standard_normal((2, 3, 4)).astype(np.float32)}
    jt = {"a": _pair(tree["a"], "float32")[0],
          "b": {"c": _pair(tree["b"]["c"], "bfloat16")[0],
                "d": _pair(tree["b"]["d"], "bfloat16")[0]},
          "e": _pair(tree["e"], "float32")[0]}
    pt = {"a": _pair(tree["a"], "float32")[1],
          "b": {"c": _pair(tree["b"]["c"], "bfloat16")[1],
                "d": _pair(tree["b"]["d"], "bfloat16")[1]},
          "e": _pair(tree["e"], "float32")[1]}
    got, want = PCMP.compress_grads(pt, scheme), JC.compress_grads(jt, scheme)
    assert len(tree_leaves(got)) == 4
    for g, w in zip(tree_leaves(got), jax.tree.leaves(want)):
        _bits_equal(g, w)


@pytest.mark.parametrize("frac", [0.1, 0.5])
def test_error_feedback_is_the_reference(frac):
    rng = np.random.default_rng(2)
    tree = {"w": rng.standard_normal((8, 16)).astype(np.float32),
            "b": rng.standard_normal(33).astype(np.float32)}
    jt = {"w": _pair(tree["w"], "bfloat16")[0], "b": _pair(tree["b"], "float32")[0]}
    pt = {"w": _pair(tree["w"], "bfloat16")[1], "b": _pair(tree["b"], "float32")[1]}
    jef, pef = JC.ErrorFeedback(), PCMP.ErrorFeedback()
    jr, pr = jef.init(jt), pef.init(pt)
    for leaf in tree_leaves(pr):
        assert leaf.dtype == torch.float32 and not bool(leaf.any())
    for step in range(3):
        # later steps add a new gradient to what the residual carries
        jk, jr = jef.compress(jt, jr, frac)
        pk, pr = pef.compress(pt, pr, frac)
        for g, w in zip(tree_leaves(pk) + tree_leaves(pr),
                        jax.tree.leaves(jk) + jax.tree.leaves(jr)):
            _bits_equal(g, w)


# ------------------------------------------------------------- train step


def _train_inputs():
    jcfg, pcfg = RC.reduced(RC.get_arch("llama3-8b")), PC.reduced(PC.get_arch("llama3-8b"))
    jp = j_init_params(j_specs(jcfg, JRuntime(param_dtype="float32", compute_dtype="float32")),
                       jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(2, jcfg.vocab, (2, 17)).astype(np.int32)
    return jcfg, pcfg, jp, toks[:, :-1], toks[:, 1:]


@pytest.mark.parametrize("scheme", ["int8", "topk"])
def test_train_step_with_compression_matches_reference(scheme):
    jcfg, pcfg, jp, toks, labels = _train_inputs()
    kw = dict(param_dtype="float32", compute_dtype="float32", remat="none", attn_chunk=16,
              act_shard=False, grad_compression=scheme)
    jopt = j_adamw_init(jp)
    jnew, jopt2, jm = jax.jit(j_make_train_step(jcfg, JRuntime(**kw), lr=1e-3))(
        jp, jopt, {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)})
    pp = lm_params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    popt = adamw_state_from_numpy(jopt.step, jax.tree.map(np.asarray, jopt.m),
                                  jax.tree.map(np.asarray, jopt.v), CPU)
    pnew, popt2, pm = p_make_train_step(pcfg, PRuntime(**kw), lr=1e-3)(
        pp, popt, {"tokens": torch.from_numpy(toks), "labels": torch.from_numpy(labels)})
    assert abs(float(pm["loss"]) - float(jm["loss"])) <= F32 * float(jm["loss"])
    for got, want in zip(tree_leaves(pnew), jax.tree.leaves(jnew)):
        _assert_step(got, want, 0.0)
    # int8: a gradient element within float32 rounding of a quantisation
    # boundary may round to the neighbouring level in one package, which
    # moves m by one level (1/127 of its scale) and v by up to two
    flip = 2.0 / 127 if scheme == "int8" else 0.0
    for got, want in zip(tree_leaves(popt2.m) + tree_leaves(popt2.v),
                         jax.tree.leaves(jopt2.m) + jax.tree.leaves(jopt2.v)):
        _assert_step(got, want, flip)


def _assert_step(got, want, flip: float) -> None:
    """Every element within 1e-5 of the result's scale, or, where ``flip``
    allows quantisation flips, within ``flip`` of it for under 0.1 % of the
    elements."""
    got, want = _np(got), _np(want)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = np.abs(got - want)
    off = err > F32 * scale
    assert float(off.mean()) <= (1e-3 if flip else 0.0), float(off.mean())
    assert float(err.max()) <= max(F32, flip) * scale
