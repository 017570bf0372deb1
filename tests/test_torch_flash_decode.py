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
import math
import re
from pathlib import Path

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



# --------------------------------------------- the ring route's split plan

CSRC = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "csrc"


def _constexpr(name: str) -> int:
    m = re.search(rf"\b{name} = (\d+)", (CSRC / "flash_decode.cu").read_text())
    assert m, name
    return int(m.group(1))


def test_ring_constants_and_entry_points_are_the_kernels():
    assert fd_ops.RING_TILE == _constexpr("RTK") and fd_ops.RING_ROWS == _constexpr("RGB")
    text = (CSRC / "flash_decode.cu").read_text()
    for prefix in fd_ops.ROUTES.values():
        for dt in ("f32", "bf16"):
            assert f'extern "C" int {prefix}_{dt}(' in text


@pytest.mark.parametrize("D,aligned,want", [(128, True, "ring"), (80, True, "ring"),
                                            (64, True, "ring"), (8, True, "ring"),
                                            (20, True, "scalar"), (128, False, "scalar"),
                                            (100, True, "scalar")])
def test_decode_route_by_head_dim_and_alignment(D, aligned, want):
    assert fd_ops.decode_route(D, aligned) == want


@pytest.mark.parametrize("G,rows", [(1, 1), (2, 2), (3, 4), (4, 4), (5, 8), (6, 8), (8, 8),
                                    (9, 8), (16, 8)])
def test_ring_rows_take_every_group(G, rows):
    assert fd_ops.ring_rows(G) == rows


# the paths' shapes on 132 SMs: llama3-8b and zamba2-2.7b at 4 x 4096 keys
# (32 and 128 (b, h) pairs), the hybrid engine's 128-key cache, mixtral's
# window at one slot; then a cache of 200 keys (a masked last split of 8),
# llama3-8b's on a card of 78 SMs, and one key past 4096 (a last split of 1)
@pytest.mark.parametrize("S,pairs,sms,want", [
    (4096, 32, 132, (8, 512)), (4096, 128, 132, (2, 2048)), (128, 128, 132, (2, 64)),
    (4096, 8, 132, (32, 128)), (1, 1, 132, (1, 32)), (200, 10, 132, (7, 32)),
    (4096, 32, 78, (4, 1024)), (4097, 32, 132, (5, 1024))])
def test_ring_plan_at_the_paths_shapes(S, pairs, sms, want):
    assert fd_ops.ring_plan(S, pairs, sms) == want


def test_ring_plan_is_a_pure_plan_that_covers_the_cache():
    """Deterministic; whole tiles; every split but the last full and the
    last ending at S (so the splits divide S where split_len does); a block
    an SM where the cache has the tiles for it, with the longest splits that
    still give that."""
    plan = fd_ops.ring_plan.__wrapped__
    tile = fd_ops.RING_TILE
    for S in list(range(1, 300, 13)) + [4095, 4096, 4097, 32768]:
        for pairs in (1, 3, 32, 128, 512):
            for sms in (78, 132):
                splits, split_len = plan(S, pairs, sms)
                assert (splits, split_len) == plan(S, pairs, sms) == fd_ops.ring_plan(S, pairs, sms)
                tps = split_len // tile
                assert split_len % tile == 0 and tps & (tps - 1) == 0
                assert (splits - 1) * split_len < S <= splits * split_len
                if S % split_len == 0:
                    assert splits * split_len == S
                tiles = -(-S // tile)
                target = fd_ops.RING_BLOCKS_PER_SM * sms
                if pairs * tiles >= target:
                    assert pairs * splits >= target
                if 2 * tps <= tiles:
                    assert pairs * -(-tiles // (2 * tps)) < target
    with pytest.raises(ValueError):
        plan(0, 1, 132)
    with pytest.raises(ValueError):
        plan(64, 0, 132)



# shapes whose ring plan divides S: the plain version at the plan's splits
# against the Pallas kernel at the same plan (interpret mode) and the oracle
@pytest.mark.parametrize("B,Hkv,G,D,S,sms", [(2, 2, 4, 32, 256, 8), (4, 2, 1, 80, 512, 16),
                                             (3, 2, 9, 128, 128, 64), (2, 1, 6, 64, 384, 8)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_at_the_ring_plan_matches_pallas_kernel_and_oracle(B, Hkv, G, D, S, sms, dtype):
    pairs = B * Hkv * -(-G // fd_ops.ring_rows(G))
    splits, split_len = fd_ops.ring_plan(S, pairs, sms)
    assert S % split_len == 0 and splits > 1
    block = fd_ops.RING_TILE
    (q, k, v, lens), (pq, pk, pv, plens) = _inputs(B, Hkv, G, D, S, dtype, seed=S + G)
    bh = lambda t: t.transpose(0, 2, 1, 3).reshape(B * Hkv, S, D)
    want = flash_decode_pallas(q.reshape(B * Hkv, G, D), bh(k), bh(v), jnp.repeat(lens, Hkv),
                               kv_splits=splits, kv_block=block, interpret=True)
    got = fd_ref.decode_plain(pq, pk, pv, plens, splits, block)
    _close(got.reshape(B * Hkv, G, D), want, dtype)
    _close(got, decode_ref(q, k, v, lens), dtype)


def _ring_model(q, k, v, lengths, split_len: int):
    """The ring route's algebra in float32: splits of split_len keys, the
    last cut at S; a split walks only keys below the row's end (len, or S
    for len <= 0), those at or past len scoring -1e30; (m, l, o) per split,
    merged by the log-sum-exp algebra."""
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    qs = q.float() * (1.0 / math.sqrt(D))
    out = torch.zeros((B, Hkv, G, D))
    for b in range(B):
        n = int(lengths[b])
        end = min(n, S) if n > 0 else S
        ms, ls, os_ = [], [], []
        for a in range(0, S, split_len):
            keys = torch.arange(a, max(a, min(a + split_len, end)))
            m = torch.full((Hkv, G), fd_ref.NEG_INF)
            l = torch.zeros((Hkv, G))
            o = torch.zeros((Hkv, G, D))
            if len(keys):
                s = torch.einsum("hgd,khd->hgk", qs[b], k[b, keys].float())
                s = torch.where((keys < n)[None, None, :], s, fd_ref.NEG_INF)
                m = s.amax(-1)
                p = torch.exp(s - m[..., None])
                l = p.sum(-1)
                o = torch.einsum("hgk,khd->hgd", p, v[b, keys].float())
            ms.append(m), ls.append(l), os_.append(o)
        m, l, o = torch.stack(ms), torch.stack(ls), torch.stack(os_)
        corr = torch.exp(m - m.amax(0))
        out[b] = (o * corr[..., None]).sum(0) / torch.clamp((l * corr).sum(0), min=1e-30)[..., None]
    return out.to(q.dtype)


@pytest.mark.parametrize("S,split_len", [(200, 96), (100, 32), (4097, 1024), (96, 64)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_masked_last_split_matches_the_oracle(S, split_len, dtype):
    """Where the plan's splits do not divide S, the last split is cut at S;
    rows of length 0 (the mean of V over all S keys), 1, a partial tile and
    S still get the oracle's answer."""
    B, Hkv, G, D = 4, 2, 4, 32
    (q, k, v, _), (pq, pk, pv, _) = _inputs(B, Hkv, G, D, S, dtype, seed=S)
    lens = np.array([0, 1, 17, S], np.int32)
    got = _ring_model(pq, pk, pv, torch.from_numpy(lens), split_len)
    _close(got, decode_ref(q, k, v, jnp.asarray(lens)), dtype)

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


def _bad_args(which):
    """q, k, v, lengths for a (2, 2, 4, 64) query over 96 keys, one of them
    wrong as ``which`` says."""
    q = torch.zeros((2, 2, 4, 64), dtype=torch.bfloat16)
    k = torch.zeros((2, 96, 2, 64), dtype=torch.bfloat16)
    v = torch.zeros((2, 96, 2, 64), dtype=torch.bfloat16)
    lens = torch.zeros((2,), dtype=torch.int32)
    if which == "k dtype":
        k = k.float()
    elif which == "v shape":
        v = v[:, :64].contiguous()
    elif which == "k layout":
        k = k.transpose(1, 2).contiguous().transpose(1, 2)
    elif which == "lengths dtype":
        lens = lens.long()
    elif which == "lengths type":
        lens = [0, 0]
    return q, k, v, lens


# each wrong argument is refused, and the message names it
@pytest.mark.parametrize("which,err,match", [
    ("k dtype", TypeError, "k has dtype"), ("v shape", ValueError, "v has shape"),
    ("k layout", ValueError, "k must be contiguous"),
    ("lengths dtype", TypeError, "lengths has dtype"),
    ("lengths type", TypeError, "lengths must be a tensor")])
def test_decode_arguments_are_checked_and_named(which, err, match):
    with pytest.raises(err, match=match):
        fd_ops.decode_attention(*_bad_args(which))


def test_decode_check_passes_the_right_arguments():
    assert fd_ops._check(*_bad_args(None)) == (2, 2, 4, 64, 96)
