"""Why K4's bf16 route splits P into two bf16 halves, on the CPU.

K4's bf16 route (``csrc/flash_attn_fwd.cu``) feeds the tensor cores' P . V
product bf16 operands with float32 sums. The reference computes P . V in
float32 (``repro/kernels/flash_attn/kernel.py`` upcasts v and keeps p in
float32), and ``chip_smoke.py`` holds the kernel to the plain version under
its unchanged bf16 gate: o within 1e-3 absolute plus 8e-3 relative. The
plain version's ``p_parts`` states the kernel's P . V arithmetic:

- one bf16 P (2**-9 relative) breaks the gate on seeded causal cases, in
  rows whose output cancels to near 0, where 2**-9 |v| exceeds 1e-3;
- hi = bf16(p) and lo = bf16(p - hi), two products into one float32 sum,
  keep about 16 bits of p and meet it.

Inputs are drawn by numpy from a seed and rounded to bf16, as the model's
activations are. The float32 function they are held to is first held to the
JAX package's oracle ``attention_ref`` at 2e-5, the float32 bound of the
reference's ``tests/test_kernels.py``.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attn.ref import attention_ref as j_attention_ref
from repro_torch.kernels import build
from repro_torch.kernels.flash_attn.ref import bf16_parts, flash_fwd_plain

O_TOL = (1e-3, 8e-3)       # chip_smoke.py's K4_O_TOL["bfloat16"]
LSE_ATOL = 1e-3            # chip_smoke.py's K4_LSE_ATOL

# (BH, S, G, D, input scale): llama3-8b's grouping and head dim, the same
# inputs x 3 (larger scores, more rows that cancel), zamba2-2.7b's G = 1 at
# head dim 80
CASES = [(2, 1024, 4, 128, 1.0), (2, 1024, 4, 128, 3.0), (2, 256, 1, 80, 1.0)]


def _inputs(BH, S, G, D, scale, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((BH, S, G, D), dtype=np.float32) * scale
    k = rng.standard_normal((BH, S, D), dtype=np.float32) * scale
    v = rng.standard_normal((BH, S, D), dtype=np.float32) * scale
    return tuple(torch.from_numpy(t).bfloat16() for t in (q, k, v))


def _outside_gate(o, ref) -> int:
    atol, rtol = O_TOL
    return int((~torch.isclose(o.float(), ref.float(), atol=atol, rtol=rtol)).sum())


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_one_bf16_p_breaks_the_gate_and_hi_lo_meets_it(case):
    q, k, v = _inputs(*case)
    kw = dict(causal=True, kv_block=128)
    ref, ref_lse = flash_fwd_plain(q, k, v, **kw)
    one, one_lse = flash_fwd_plain(q, k, v, p_parts=1, **kw)
    two, two_lse = flash_fwd_plain(q, k, v, p_parts=2, **kw)
    # lse is the same float32 recurrence in all three
    assert float((one_lse - ref_lse).abs().max()) <= LSE_ATOL
    assert float((two_lse - ref_lse).abs().max()) <= LSE_ATOL
    assert _outside_gate(one, ref) > 0
    assert _outside_gate(two, ref) == 0


def test_the_gate_reference_is_the_jax_oracle():
    q, k, v = (t.float() for t in _inputs(1, 256, 4, 128, 1.0))
    o, _ = flash_fwd_plain(q, k, v, causal=True, kv_block=128)
    # the oracle's grouped layout: (B, S, Hkv, G, D), (B, S, Hkv, D)
    want = j_attention_ref(jnp.asarray(q.numpy()[:, :, None]), jnp.asarray(k.numpy()[:, :, None]),
                           jnp.asarray(v.numpy()[:, :, None]), causal=True)
    np.testing.assert_allclose(o.numpy(), np.asarray(want)[:, :, 0], atol=2e-5, rtol=2e-5)


def test_hi_lo_keep_sixteen_bits_of_p():
    rng = np.random.default_rng(1)
    p = torch.from_numpy(np.exp(-rng.exponential(4.0, 100000)).astype(np.float32))
    hi, lo = bf16_parts(p, 2)
    (one,) = bf16_parts(p, 1)
    assert torch.equal(one, hi)
    assert bool(((hi + lo - p).abs() <= p * 2.0 ** -16).all())
    assert float(((one - p).abs() / p).max()) > 2.0 ** -10
    with pytest.raises(ValueError):
        bf16_parts(p, 3)


def test_library_name_covers_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "common.cuh"\nint x;\n')
    (tmp_path / "common.cuh").write_text("// v1\n")
    monkeypatch.setattr(build, "_CSRC", tmp_path)
    first = build._lib_path("k")
    assert build._lib_path("k") == first
    (tmp_path / "common.cuh").write_text("// v2\n")
    assert build._lib_path("k") != first
