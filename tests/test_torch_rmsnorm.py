"""The fused RMSNorm of the port (kernels K10 and K11) against the JAX
package, on the CPU, where the port runs the kernels' plain versions.

K10's plain version is held to ``rmsnorm_fwd_pallas`` and K11's to
``rmsnorm_bwd_pallas``, both in Pallas interpret mode as
``tests/test_kernels.py`` runs them, with N not a multiple of 128 and D up
to 6144. The port's ``rmsnorm`` (the autograd function that the models
call) is held to ``jax.grad`` of the reference's ``blocks.rmsnorm``.
Inputs are drawn by numpy from a seed and fed to both packages.

Tolerances: float32 outputs 1e-6 of their scale and rstd 1e-6 relative
(the two packages sum the squares in another order); gradients 1e-5 of
their scale (dw sums over up to 200 rows in another grouping); bfloat16
outputs and dx within one bf16 step (2**-7 relative to the largest
magnitude: both compute in float32 from the same inputs, then round), dw
in bfloat16 within one bf16 step of its largest magnitude.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rmsnorm.kernel import rmsnorm_bwd_pallas, rmsnorm_fwd_pallas
from repro.models import blocks as JB
from repro_torch.kernels import counts
from repro_torch.kernels.rmsnorm import ops
from repro_torch.kernels.rmsnorm.ref import ROWS
from repro_torch.models import blocks as PB

JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
BF16_STEP = 2.0 ** -7


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _pair(a: np.ndarray, dtype: str):
    """(jax array, torch tensor) holding the same values in ``dtype``."""
    j = jnp.asarray(a, JDT[dtype])
    return j, torch.from_numpy(np.array(j.astype(jnp.float32))).to(TDT[dtype])


def _close(got, want, dtype: str, f32_tol: float = 1e-6):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-30)
    tol = f32_tol if dtype == "float32" else BF16_STEP
    err = float(np.abs(got - want).max())
    assert err <= tol * scale, f"max abs err {err} > {tol} x scale {scale}"


SHAPES = [(32, 64), (200, 96), (130, 256), (7, 6144), (256, 48)]


@pytest.mark.parametrize("N,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_fwd_plain_matches_pallas_kernel(N, D, dtype):
    rng = np.random.default_rng(N + D)
    xj, xt = _pair(rng.standard_normal((N, D)) * 2, dtype)
    wj, wt = _pair(rng.standard_normal(D), dtype)
    oj, rj = rmsnorm_fwd_pallas(xj, wj, eps=1e-5, interpret=True)
    counts.reset()
    ot, rt = ops.rmsnorm_fwd(xt, wt, 1e-5)
    assert counts.PLAIN_CALLS["rmsnorm_fwd"] == 1 and counts.LAUNCHES["rmsnorm_fwd"] == 0
    assert ot.dtype == TDT[dtype] and rt.dtype == torch.float32 and rt.shape == (N,)
    _close(ot, oj, dtype)
    np.testing.assert_allclose(_np(rt), _np(rj), rtol=1e-6, atol=0)


@pytest.mark.parametrize("N,D", SHAPES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_bwd_plain_matches_pallas_kernel(N, D, dtype):
    rng = np.random.default_rng(3 * N + D)
    xj, xt = _pair(rng.standard_normal((N, D)), dtype)
    wj, wt = _pair(rng.standard_normal(D), dtype)
    dj, dt = _pair(rng.standard_normal((N, D)), dtype)
    _, rstd_j = rmsnorm_fwd_pallas(xj, wj, interpret=True)
    rstd_t = torch.from_numpy(np.array(rstd_j))
    dxj, dwj = rmsnorm_bwd_pallas(xj, wj, rstd_j, dj, interpret=True)
    counts.reset()
    dxt, parts = ops.rmsnorm_bwd(xt, wt, rstd_t, dt)
    assert counts.PLAIN_CALLS["rmsnorm_bwd"] == 1
    assert dxt.dtype == TDT[dtype]
    assert parts.dtype == torch.float32 and parts.shape == (-(-N // ROWS), D)
    _close(dxt, dxj, dtype, 1e-5)
    # the reference sums its partials and casts to w's dtype
    _close(parts.sum(0).to(TDT[dtype]), dwj, dtype, 1e-5)


def test_bwd_partials_are_per_tile_of_128_rows():
    rng = np.random.default_rng(0)
    N, D = 300, 16
    x = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(D).astype(np.float32))
    do = torch.from_numpy(rng.standard_normal((N, D)).astype(np.float32))
    _, rstd = ops.rmsnorm_fwd(x, w)
    _, parts = ops.rmsnorm_bwd(x, w, rstd, do)
    xhat = x * rstd[:, None]
    for t, (a, b) in enumerate([(0, 128), (128, 256), (256, 300)]):
        torch.testing.assert_close(parts[t], (do[a:b] * xhat[a:b]).sum(0), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(2, 5, 64), (3, 70, 96), (200, 6144)])
def test_port_rmsnorm_and_its_gradients_match_reference(dtype, shape):
    """Forward and ``jax.grad`` of the reference's ``blocks.rmsnorm`` (a jnp
    norm differentiated by JAX) against the port's autograd function, whose
    backward is K11's plain version here."""
    rng = np.random.default_rng(sum(shape))
    D = shape[-1]
    xj, xt = _pair(rng.standard_normal(shape) * 3, dtype)
    wj, wt = _pair(rng.standard_normal(D), dtype)
    cj, ct = _pair(rng.standard_normal(shape), dtype)   # a cotangent

    def loss(x, w):
        return (JB.rmsnorm(x, w, 1e-5).astype(jnp.float32) * cj.astype(jnp.float32)).sum()

    want = JB.rmsnorm(xj, wj, 1e-5)
    gxj, gwj = jax.grad(loss, (0, 1))(xj, wj)
    xt.requires_grad_(True)
    wt.requires_grad_(True)
    counts.reset()
    got = PB.rmsnorm(xt, wt, 1e-5)
    (got.float() * ct.float()).sum().backward()
    assert counts.PLAIN_CALLS["rmsnorm_fwd"] == 1 and counts.PLAIN_CALLS["rmsnorm_bwd"] == 1
    assert got.dtype == xt.dtype and xt.grad.dtype == xt.dtype and wt.grad.dtype == wt.dtype
    _close(got, want, dtype)
    _close(xt.grad, gxj, dtype, 1e-5)
    _close(wt.grad, gwj, dtype, 1e-5)


def test_rmsnorm_takes_mixed_dtypes_and_any_layout():
    """A bfloat16 input with a float32 gain (a float32-parameter model in
    bfloat16 compute), and an input that is not contiguous."""
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.standard_normal((4, 6, 32)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal(32).astype(np.float32))
    got = PB.rmsnorm(x.to(torch.bfloat16), w)
    want = JB.rmsnorm(jnp.asarray(x.numpy(), jnp.bfloat16), jnp.asarray(w.numpy()))
    assert got.dtype == torch.bfloat16
    _close(got, want, "bfloat16")
    xt = x.transpose(0, 1)
    _close(PB.rmsnorm(xt, w), JB.rmsnorm(jnp.asarray(xt.numpy()), jnp.asarray(w.numpy())),
           "float32")


def test_cuda_wrappers_refuse_host_tensors_and_bad_arguments():
    x, w = torch.ones((4, 8)), torch.ones(8)
    counts.reset()
    with pytest.raises(ValueError, match="needs tensors on the card"):
        ops.rmsnorm_fwd_cuda(x, w)
    with pytest.raises(ValueError, match="needs tensors on the card"):
        ops.rmsnorm_bwd_cuda(x, w, torch.ones(4), x)
    assert counts.LAUNCHES["rmsnorm_fwd"] == counts.LAUNCHES["rmsnorm_bwd"] == 0
    # the CPU route refuses what the kernels refuse
    with pytest.raises(TypeError, match="not supported"):
        ops.rmsnorm_fwd(x.half(), w.half())
    with pytest.raises(ValueError, match="shape"):
        ops.rmsnorm_fwd(x, torch.ones(9))
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm_fwd(torch.ones((8, 4)).t(), torch.ones(8))
    with pytest.raises(ValueError, match=r"\(N, D\)"):
        ops.rmsnorm_fwd(torch.ones(8), w)
    with pytest.raises(TypeError, match="float32"):
        ops.rmsnorm_bwd(x, w, torch.ones(4, dtype=torch.float64), x)
    with pytest.raises(TypeError, match="dtype"):
        ops.rmsnorm_bwd(x, w, torch.ones(4), x.to(torch.bfloat16))
