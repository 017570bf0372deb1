"""Which second-stage operands K5's and K6's bf16 routes split into two bf16
halves, on the CPU.

K5 and K6 (``csrc/flash_attn_bwd.cu``) run their second-stage products on
the tensor cores, which take bf16 operands and sum in float32: dq += ds . k
(K5), dv += p^T . do and dk += ds^T . q (K6). The reference feeds p and ds
to these products in float32 (``repro/kernels/flash_attn/kernel.py``
``_dq_kernel`` and ``_dkv_kernel`` upcast every operand), and
``chip_smoke.py`` holds the kernels to the plain versions under its
unchanged bf16 gate: every output within 1e-3 of its largest magnitude plus
8e-3 relative (``BWD_TOL``). The plain versions' ``ds_parts`` and
``p_parts`` state the kernels' arithmetic:

- one bf16 ds (2**-9 relative) breaks the gate for dq or dk on seeded
  causal cases (llama3-8b's G = 4 at head dim 128, the same inputs x 3,
  zamba2-2.7b's G = 1 at head dim 80);
- one bf16 p breaks it for dv on seeded cases without a mask, where no
  key gathers the probability of every row and so the largest dv no
  longer dwarfs the rest;
- hi = bf16(x) and lo = bf16(x - hi) of both meet it everywhere.

So both kernels split both: K5 runs four products (q.k, do.v, ds.k twice)
and K6 six (q.k, do.v, p.do twice, ds.q twice). Inputs are drawn by numpy
from a seed and rounded to bf16, as the model's activations are; lse and
delta come from the forward the kernels follow. The float32 function they
are held to is first held to the JAX package's Pallas kernels in interpret
mode at 2e-5, the float32 bound of the reference's ``tests/test_kernels.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.kernel import flash_dkv_pallas, flash_dq_pallas
from repro_torch.kernels.flash_attn.ref import flash_dkv_plain, flash_dq_plain, flash_fwd_plain

BWD_TOL = (1e-3, 8e-3)     # chip_smoke.py's BWD_TOL["bfloat16"]

# (BH, S, G, D, input scale, causal, what one bf16 part breaks): "ds" when
# one bf16 ds puts dq or dk outside the gate, "p" when one bf16 p puts dv
# outside it
CASES = [
    (2, 1024, 4, 128, 1.0, True, "ds"),
    (2, 1024, 4, 128, 3.0, True, "ds"),
    (2, 256, 1, 80, 1.0, True, "ds"),
    (2, 1024, 4, 128, 1.0, False, "p"),
    (2, 256, 1, 80, 1.0, False, "p"),
]


def _inputs(BH, S, G, D, scale, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, S, G, D), dtype=np.float32) * scale
    k = rng.standard_normal((BH, S, D), dtype=np.float32) * scale
    v = rng.standard_normal((BH, S, D), dtype=np.float32) * scale
    do = rng.standard_normal((BH, S, G, D), dtype=np.float32)
    return tuple(torch.from_numpy(t).bfloat16() for t in (q, k, v, do))


def _grad_inputs(q, k, v, do, causal):
    """lse from the forward of K4's bf16 route, delta = sum(do * o)."""
    o, lse = flash_fwd_plain(q, k, v, causal=causal, p_parts=2)
    return lse, (do.float() * o.float()).sum(-1)


def _outside_gate(got, want) -> int:
    atol, rtol = BWD_TOL
    scale = float(want.float().abs().max())
    return int((~torch.isclose(got.float(), want.float(), atol=atol * scale, rtol=rtol)).sum())


def _grads(args, kw, parts=None):
    """(dq, dk, dv) with p and ds fed as ``parts`` bf16 parts (None: float32)."""
    dq = flash_dq_plain(*args, ds_parts=parts, **kw)
    dk, dv = flash_dkv_plain(*args, p_parts=parts, ds_parts=parts, **kw)
    return dq, dk, dv


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_one_bf16_part_breaks_the_gate_and_hi_lo_meets_it(case):
    BH, S, G, D, scale, causal, breaks = case
    q, k, v, do = _inputs(BH, S, G, D, scale)
    args = (q, k, v, do, *_grad_inputs(q, k, v, do, causal))
    kw = dict(causal=causal, q_block=128, kv_block=128)
    want = _grads(args, kw)
    one = dict(zip(("dq", "dk", "dv"), (_outside_gate(g, w) for g, w in
                                        zip(_grads(args, kw, 1), want))))
    two = [_outside_gate(g, w) for g, w in zip(_grads(args, kw, 2), want)]
    assert two == [0, 0, 0]
    if breaks == "ds":
        assert one["dq"] + one["dk"] > 0, one
    else:
        assert one["dv"] > 0, one


def test_only_the_split_operand_moves_its_output():
    # p enters only dv and ds only dq and dk: splitting one leaves the other
    # outputs bit for bit as the float32 products give them
    q, k, v, do = _inputs(1, 256, 4, 64, 1.0, seed=2)
    args = (q, k, v, do, *_grad_inputs(q, k, v, do, True))
    kw = dict(causal=True, q_block=64, kv_block=64)
    dk, dv = flash_dkv_plain(*args, **kw)
    dk_p, dv_p = flash_dkv_plain(*args, p_parts=1, **kw)
    dk_ds, dv_ds = flash_dkv_plain(*args, ds_parts=1, **kw)
    assert torch.equal(dk_p, dk) and torch.equal(dv_ds, dv)
    assert not torch.equal(dv_p, dv) and not torch.equal(dk_ds, dk)


@pytest.mark.parametrize("causal", [True, False])
def test_the_gate_reference_is_the_pallas_kernels(causal):
    q, k, v, do = (t.float() for t in _inputs(1, 256, 4, 128, 1.0, seed=1))
    lse, delta = _grad_inputs(q, k, v, do, causal)
    kw = dict(causal=causal, q_block=128, kv_block=128)
    args = [jnp.asarray(t.numpy()) for t in (q, k, v, do, lse, delta)]
    want = (flash_dq_pallas(*args, interpret=True, **kw),
            *flash_dkv_pallas(*args, interpret=True, **kw))
    for got, ref in zip(_grads((q, k, v, do, lse, delta), kw), want):
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-5, rtol=2e-5)
