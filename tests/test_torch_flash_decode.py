"""Split-KV decode attention of the port (kernel K7) against the JAX package,
on the CPU, where the port runs K7's plain version.

Inputs are drawn by numpy from a seed and fed to both packages. The
reference's Pallas kernel runs in interpret mode, as ``tests/test_kernels.py``
runs it.

Tolerances, each with its reason:

- K7's plain version against ``flash_decode_pallas`` and the oracle
  ``decode_ref``: in float32 2e-5 absolute and relative, the bound of
  ``tests/test_kernels.py``; with bfloat16 inputs both compute in float32
  from the same inputs and round o once, so within one bf16 step (2**-7) of
  o's largest magnitude.
- The port's ``attention_decode_apply`` on the ``flash`` route (K7) against
  the reference's (its inline softmax): in float32 1e-5 of the output's
  scale; in bfloat16 5e-2, the bound of ``tests/test_decode_consistency.py``
  (the reference rounds the scores and the probabilities to bf16, K7 does
  not).
"""
from __future__ import annotations

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as RC
from repro.kernels.flash_decode.kernel import flash_decode_pallas
from repro.kernels.flash_decode.ref import decode_ref
from repro.models import Runtime as JRuntime
from repro.models import attention as JA
from repro_torch import configs as PC
from repro_torch.convert import lm_params_from_numpy
from repro_torch.kernels import counts
from repro_torch.kernels.flash_decode import ops as fd_ops
from repro_torch.kernels.flash_decode import ref as fd_ref
from repro_torch.models import Runtime as PRuntime
from repro_torch.models import attention as PA

CPU = torch.device("cpu")
BF16_STEP = 2.0 ** -7
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _port(a):
    return lm_params_from_numpy({"a": np.asarray(a)}, CPU)["a"]


def _close(got, want, dtype: str):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    if dtype == "float32":
        np.testing.assert_allclose(got, want, atol=2e-5, rtol=2e-5)
    else:
        err = float(np.abs(got - want).max() / np.abs(want).max())
        assert err <= BF16_STEP, f"max err {err} of the scale > one bf16 step"


def _inputs(B, Hkv, G, D, S, dtype: str, seed: int):
    """q (B, Hkv, G, D), k, v (B, S, Hkv, D) and the lengths: 0, S // 3, S
    and a partial length, cycled over the batch rows."""
    rng = np.random.default_rng(seed)
    q, k, v = (jnp.asarray(rng.standard_normal(s), JDT[dtype])
               for s in ((B, Hkv, G, D), (B, S, Hkv, D), (B, S, Hkv, D)))
    lens = np.array([(0, S // 3, S, S - 5)[i % 4] for i in range(B)], np.int32)
    return (q, k, v, jnp.asarray(lens)), (_port(q), _port(k), _port(v), torch.from_numpy(lens))


# (S, kv_splits, G, D): every split count over each S, the head dims 32, 80
# (zamba2-2.7b) and 128 (llama3-8b, mixtral) and groups 1 and 4 in turn; and
# starcoder2-7b's 9 query heads a KV head at 128
CASES = [(S, sp, (1, 4)[i % 2], (32, 80, 128)[i % 3])
         for i, (S, sp) in enumerate((S, sp) for S in (96, 128, 256) for sp in (1, 2, 3, 4))]
CASES.append((128, 2, 9, 128))


@pytest.mark.parametrize("S,splits,G,D", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_pallas_kernel_and_oracle(S, splits, G, D, dtype):
    B, Hkv = 4, 2
    (q, k, v, lens), (pq, pk, pv, plens) = _inputs(B, Hkv, G, D, S, dtype, seed=S + 7 * D + G)
    # the Pallas kernel's layout: (B * Hkv, G, D) and (B * Hkv, S, D)
    bh = lambda t: t.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D)
    want = flash_decode_pallas(q.reshape(B * Hkv, G, D), bh(k), bh(v), jnp.repeat(lens, Hkv),
                               kv_splits=splits, kv_block=32, interpret=True)
    counts.reset()
    got = fd_ops.decode_attention(pq, pk, pv, plens, kv_splits=splits, kv_block=32)
    assert counts.PLAIN_CALLS["flash_decode"] == 1 and counts.LAUNCHES["flash_decode"] == 0
    assert got.dtype == TDT[dtype] and tuple(got.shape) == (B, Hkv, G, D)
    _close(got.reshape(B * Hkv, G, D), want, dtype)
    _close(got, decode_ref(q, k, v, lens), dtype)
    _close(fd_ref.decode_ref(pq, pk, pv, plens), decode_ref(q, k, v, lens), dtype)
    # the row of length 0 is the mean of V over the whole cache
    _close(got[0], _np(pv).mean(axis=1)[0][:, None, :].repeat(G, axis=1), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_matches_oracle_over_the_grid(dtype):
    """Every (S, splits, G, D) of the grid against the port's copy of the
    oracle, which the test above holds to the reference's."""
    for S in (96, 128, 256):
        for splits in (1, 2, 3, 4):
            for G in (1, 4, 8, 9):
                for D in (32, 80, 128):
                    _, ps = _inputs(3, 2, G, D, S, dtype, seed=S * splits + G + D)
                    got = fd_ops.decode_attention(*ps, kv_splits=splits, kv_block=32)
                    _close(got, fd_ref.decode_ref(*ps), dtype)


def test_split_plan_is_the_references():
    for S in range(1, 300, 7):
        for kv_splits in (1, 2, 3, 4, 8):
            for kv_block in (16, 32, 128):
                want_splits, want_block = kv_splits, kv_block
                while S % (want_splits * want_block) and want_splits > 1:
                    want_splits -= 1
                want_block = min(want_block, S // want_splits)
                while (S // want_splits) % want_block:
                    want_block //= 2
                assert fd_ops.split_plan(S, kv_splits, kv_block) == (want_splits, want_block)


def test_refuses_what_the_kernel_does_not_take():
    def args(B=2, S=32, Hkv=2, G=2, D=16, dtype=torch.float32):
        return [torch.zeros((B, Hkv, G, D), dtype=dtype), torch.zeros((B, S, Hkv, D), dtype=dtype),
                torch.zeros((B, S, Hkv, D), dtype=dtype), torch.full((B,), 3, dtype=torch.int32)]

    with pytest.raises(ValueError, match="D = 160"):
        fd_ops.decode_attention(*args(D=160))
    with pytest.raises(TypeError, match="not supported"):
        fd_ops.decode_attention(*args(dtype=torch.float16))
    a = args()
    a[3] = a[3].long()
    with pytest.raises(TypeError, match="lengths"):
        fd_ops.decode_attention(*a)
    a = args()
    a[1] = torch.zeros((2, 2, 32, 16)).transpose(1, 2)
    with pytest.raises(ValueError, match="contiguous"):
        fd_ops.decode_attention(*a)
    counts.reset()
    with pytest.raises(ValueError, match="needs tensors on the card"):
        fd_ops.decode_cuda(*args(), 2)
    assert counts.LAUNCHES["flash_decode"] == 0


# ------------------------------------------------- the model's decode step


def _attn_case(dtype: str, window):
    jcfg = RC.reduced(RC.get_arch("llama3-8b"))
    pcfg = PC.reduced(PC.get_arch("llama3-8b"))
    if window is not None:
        jcfg, pcfg = (dataclasses.replace(c, window=window) for c in (jcfg, pcfg))
    rng = np.random.default_rng(11)
    d, hq, hkv, hd = jcfg.d_model, jcfg.n_heads, jcfg.n_kv_heads, jcfg.head_dim
    w = {name: jnp.asarray(rng.standard_normal(shape) / np.sqrt(d), JDT[dtype])
         for name, shape in (("wq", (d, hq, hd)), ("wk", (d, hkv, hd)), ("wv", (d, hkv, hd)),
                             ("wo", (hq, hd, d)))}
    return jcfg, pcfg, w, lm_params_from_numpy(jax.tree.map(np.asarray, w), CPU)


@pytest.mark.parametrize("window", [None, 16], ids=["linear", "ring"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_attention_decode_flash_route_matches_reference(dtype, window):
    """Teacher-forced steps over a cache of 16 slots: past the end of the
    linear cache (its last slot rewritten) and round the ring buffer."""
    jcfg, pcfg, jw, pw = _attn_case(dtype, window)
    kw = dict(remat="none", act_shard=False, param_dtype=dtype, compute_dtype=dtype)
    jrt, prt = JRuntime(**kw), PRuntime(attn_impl="flash", **kw)
    B, S, hkv, hd = 3, 16, jcfg.n_kv_heads, jcfg.head_dim
    xs = np.random.default_rng(5).standard_normal((B, 24, jcfg.d_model))
    jc = {"k": jnp.zeros((B, S, hkv, hd), JDT[dtype]), "v": jnp.zeros((B, S, hkv, hd), JDT[dtype]),
          "pos": jnp.asarray([0, 3, 7], jnp.int32)}
    pc = {"k": torch.zeros((B, S, hkv, hd), dtype=TDT[dtype]),
          "v": torch.zeros((B, S, hkv, hd), dtype=TDT[dtype]),
          "pos": torch.tensor([0, 3, 7], dtype=torch.int32)}
    counts.reset()
    for t in range(xs.shape[1]):
        xj = jnp.asarray(xs[:, t:t + 1], JDT[dtype])
        oj, jc = JA.attention_decode_apply(jw, xj, jc, jcfg, jrt)
        op, pc = PA.attention_decode_apply(pw, _port(xj), pc, pcfg, prt)
        scale = float(np.abs(_np(oj)).max())
        err = float(np.abs(_np(op) - _np(oj)).max()) / scale
        assert err <= (1e-5 if dtype == "float32" else 5e-2), (t, err)
    assert counts.PLAIN_CALLS["flash_decode"] == xs.shape[1]
    _close(pc["k"], jc["k"], "float32" if dtype == "float32" else "bfloat16")
    np.testing.assert_array_equal(pc["pos"].numpy(), np.asarray(jc["pos"]))
