"""The port's bf16 activations against the reference's ``jax.nn`` ones, on
the CPU.

XLA rounds every step of a bf16 ``jax.nn.silu``, ``jax.nn.sigmoid`` and
``jax.nn.gelu`` (tanh form, constants rounded to x's dtype) to bf16; one
fused torch call (``F.silu``, ``torch.sigmoid``, ``F.gelu``) rounds once
and differs by a bf16 step on about a third of the elements.
``models/blocks.py`` replays the reference step by step. Each replay gets
the same bf16 pre-activation as its ``jax.nn`` function, so no product's
rounding enters, and must be bit-identical. The FFNs that use them are held
against the reference at the slices' bf16 tolerance, 5e-2 of the output's
scale (``tests/test_torch_lm.py``, ``tests/test_torch_moe.py``).
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.models import blocks as JB
from repro_torch.models import blocks as PB

BF16 = 5e-2  # bf16 FFN outputs, relative to their scale

ACTS = {
    "silu": (PB.silu, jax.nn.silu, F.silu),
    "sigmoid": (PB.sigmoid, jax.nn.sigmoid, torch.sigmoid),
    "gelu_tanh": (PB.gelu_tanh, jax.nn.gelu, lambda t: F.gelu(t, approximate="tanh")),
}


def _pre_activation(seed: int, n: int = 65536) -> np.ndarray:
    """n bf16 values drawn as N(0, 16), as float32."""
    x = np.random.default_rng(seed).standard_normal(n).astype(np.float32) * 4
    return np.array(jnp.asarray(x, jnp.bfloat16).astype(jnp.float32))


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("name", sorted(ACTS))
def test_bf16_replay_is_bit_identical_to_jax(name):
    port, ref, fused = ACTS[name]
    x = _pre_activation(seed=len(name))
    got = port(torch.from_numpy(x).to(torch.bfloat16))
    want = ref(jnp.asarray(x, jnp.bfloat16))
    assert got.dtype == torch.bfloat16 and want.dtype == jnp.bfloat16
    np.testing.assert_array_equal(_np(got), _np(want))
    # the fused call it replaces differs: the test tells the two apart
    assert float((_np(fused(torch.from_numpy(x).to(torch.bfloat16))) != _np(want)).mean()) > 0.1


# (dtype, |x| reached, tolerance of the gradients): past |x| = 88.7 in
# float32 and bfloat16 and 709.8 in float64, exp(-x) overflows, where a
# sigmoid differentiated as written gives NaN. In float64 and float32 the
# gradient is held to the fused call's; in bfloat16 the replay rounds where
# the fused call does not, so it is held to ``jax.grad`` of the reference's
# activation, within two bf16 steps of gradients near 1
GRAD_CASES = {
    "float64": (torch.float64, 800.0, dict(atol=1e-12, rtol=1e-12)),
    "float32": (torch.float32, 120.0, dict(atol=1e-5, rtol=1.3e-6)),
    "bfloat16": (torch.bfloat16, 120.0, dict(atol=2 ** -6, rtol=0.0)),
}


@pytest.mark.parametrize("dtype", sorted(GRAD_CASES))
@pytest.mark.parametrize("name", sorted(ACTS))
def test_replay_is_differentiable(name, dtype):
    """The replay's gradient is finite everywhere, exp(-x)'s overflow
    included, and equals the fused call's (the reference's in bf16)."""
    port, ref, fused = ACTS[name]
    dt, edge, tol = GRAD_CASES[dtype]
    xs = np.concatenate([np.linspace(-edge, edge, 257), np.linspace(-6, 6, 257)])
    x = torch.from_numpy(xs).to(dt).requires_grad_(True)
    (g,) = torch.autograd.grad(port(x).sum(), x)
    assert bool(torch.isfinite(g).all())
    if dt == torch.bfloat16:
        xj = jnp.asarray(x.detach().float().numpy(), jnp.bfloat16)
        want = torch.from_numpy(_np(jax.grad(lambda t: ref(t).sum())(xj)))
        g = g.float()
    else:
        xf = x.detach().requires_grad_(True)
        (want,) = torch.autograd.grad(fused(xf).sum(), xf)
    torch.testing.assert_close(g, want, **tol)


def _ffn_weights(act: str, d: int = 64, f: int = 96, seed: int = 3):
    rng = np.random.default_rng(seed)
    specs = JB.ffn_specs(d, f, act)
    w = {k: np.array(jnp.asarray(rng.standard_normal(s.shape) / 8, jnp.bfloat16)
                     .astype(jnp.float32)) for k, s in specs.items()}
    x = np.array(jnp.asarray(rng.standard_normal((2, 5, d)), jnp.bfloat16).astype(jnp.float32))
    return w, x


def _assert_scaled(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    scale = float(np.abs(want).max())
    assert float(np.abs(got - want).max()) <= tol * scale


@pytest.mark.parametrize("act", ["swiglu", "gelu"])
def test_bf16_ffn_apply_matches_reference(act):
    w, x = _ffn_weights(act)
    got = PB.ffn_apply({k: torch.from_numpy(v).to(torch.bfloat16) for k, v in w.items()},
                       torch.from_numpy(x).to(torch.bfloat16), act)
    want = JB.ffn_apply({k: jnp.asarray(v, jnp.bfloat16) for k, v in w.items()},
                        jnp.asarray(x, jnp.bfloat16), act)
    assert got.dtype == torch.bfloat16
    _assert_scaled(got, want, BF16)


def test_bf16_ffn_hidden_activation_matches_reference_on_the_same_products():
    """swiglu's hidden product from the same bf16 matmul outputs: the port's
    replay and the reference's ``jax.nn.silu`` give the same bits."""
    w, x = _ffn_weights("swiglu", seed=5)
    gate = np.array(jnp.asarray(x, jnp.bfloat16) @ jnp.asarray(w["w_gate"], jnp.bfloat16))
    up = np.array(jnp.asarray(x, jnp.bfloat16) @ jnp.asarray(w["w_up"], jnp.bfloat16))
    got = PB.silu(torch.from_numpy(gate.astype(np.float32)).to(torch.bfloat16)) * \
        torch.from_numpy(up.astype(np.float32)).to(torch.bfloat16)
    want = jax.nn.silu(jnp.asarray(gate)) * jnp.asarray(up)
    np.testing.assert_array_equal(_np(got), _np(want))


def test_bf16_moe_expert_ffn_matches_reference():
    """MoE's expert FFN, silu(x . w_gate) * (x . w_up) . w_down per expert:
    the port through K9's plain version, the reference through its einsums."""
    from repro_torch.kernels.moe_gmm.ops import grouped_matmul
    from repro_torch.models.moe import silu

    rng = np.random.default_rng(9)
    E, C, D, Fw = 3, 12, 48, 64

    def bf16(shape, scale):
        return np.array(jnp.asarray(rng.standard_normal(shape) * scale, jnp.bfloat16)
                        .astype(jnp.float32))

    x, wg, wu, wd = (bf16((E, C, D), 1.0), bf16((E, D, Fw), D ** -0.5),
                     bf16((E, D, Fw), D ** -0.5), bf16((E, Fw, D), Fw ** -0.5))
    t = {k: torch.from_numpy(v).to(torch.bfloat16) for k, v in
         dict(x=x, wg=wg, wu=wu, wd=wd).items()}
    h = silu(grouped_matmul(t["x"], t["wg"])) * grouped_matmul(t["x"], t["wu"])
    got = grouped_matmul(h, t["wd"])
    j = {k: jnp.asarray(v, jnp.bfloat16) for k, v in dict(x=x, wg=wg, wu=wu, wd=wd).items()}
    hj = jax.nn.silu(jnp.einsum("ecd,edf->ecf", j["x"], j["wg"])) * jnp.einsum(
        "ecd,edf->ecf", j["x"], j["wu"])
    want = jnp.einsum("ecf,efd->ecd", hj, j["wd"])
    _assert_scaled(got, want, BF16)
