"""The backward of the port's two chunked scans against the JAX package, on
the CPU: K12b (the RWKV6 WKV) and K8b (the Mamba2 SSD), here through their
plain versions (autograd of the forward's plain version, as the
reference's backward is ``jax.vjp`` of its oracle), and the kernels'
algorithms by route against the plain backward: ``serial``
(``ref.wkv_bwd_chunks``, ``ref.ssd_bwd_chunks``: a forward walk for the
chunks' starting states, then the closed-form gradients chunk by chunk) and
``chunked`` (``ref.wkv_bwd_chunked``, ``ref.ssd_bwd_chunked``: every chunk's
two increments, a forward and a reverse state pass, every chunk's
gradients), whose chunk states are the serial model's, and the chunked
model against the reference model's backward too. Inputs are drawn by numpy from a seed and
fed to both packages; the reference's scan kernels run in Pallas interpret
mode, as ``tests/test_kernels.py`` runs them. ``tests/test_torch_train_ssm.py``
trains the two families.

Tolerances, each relative to the largest magnitude of the reference's
result, with its reason:

- The Pallas form (``wkv_scan``, ``ssd_scan``; every product float32): the
  reference's backward is ``jax.vjp`` of its sequential oracle, the port's
  autograd of its chunked plain version; the same function in another
  order: 2e-5, the float32 tolerance of ``tests/test_kernels.py``.
- The model form of the SSD (``_ssd_chunked``) rounds nothing in float32:
  1e-5. In bfloat16 it rounds at the same places in both packages, after
  float32 sums taken in other orders, and the gradients cross those
  roundings (JAX's transpose of a cast rounds the cotangent, and so does
  torch's): 5e-2 (``BF16_GRAD`` of ``tests/test_torch_train.py``).
- The model form of the WKV (``_wkv_chunked``) rounds its intra-chunk
  operands to bfloat16 even in float32, and its gradients cross those
  roundings, so where the two packages' float32 intermediates differ at the
  ulp level (XLA's and torch's cumsum and exp) a gradient element moves by
  one bf16 step of its cotangent: in float32 at least 95 % of each gradient's
  elements within 1e-5 of its scale and all within one bf16 step (2**-7), the
  gate of the forward's model form (``tests/test_torch_ssm.py``); 5e-2 in
  bfloat16.
- The kernels' algorithms against the plain backward: 1e-6 without bf16
  roundings; one bf16 step with them, where the two sum in other orders.
  The two routes' models take their increments and per-chunk gradients
  from the same functions, so their chunk states are equal, bit for bit.
  The chunked model against ``jax.vjp`` of the reference model: the gates
  of the port's model form above.
"""
from __future__ import annotations


import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_ssd.ops import ssd_scan as j_ssd_scan
from repro.kernels.rwkv6_wkv.ops import wkv_scan as j_wkv_scan
from repro.models import mamba2 as JM
from repro.models import rwkv6 as J6
from repro_torch.kernels import counts
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.mamba2_ssd.ref import (ssd_bwd_chunked, ssd_bwd_chunks, ssd_bwd_plain,
                                                 ssd_bwd_states)
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv.ref import (wkv_bwd_chunked, wkv_bwd_chunks, wkv_bwd_plain,
                                                wkv_bwd_states)
from repro_torch.models import mamba2 as PM
from repro_torch.models import rwkv6 as P6

F32 = 1e-5
KERNEL_F32 = 2e-5
BF16_GRAD = 5e-2
BF16_STEP = 2.0 ** -7
FRAC = 0.95
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _scaled_err(got, want) -> np.ndarray:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return np.abs(got - want) / max(float(np.abs(want).max()), 1e-30)


def _assert_scaled(got, want, tol):
    err = float(_scaled_err(got, want).max())
    assert err <= tol, f"max err {err} of the scale > {tol}"


def _assert_bf16_flips_only(got, want):
    err = _scaled_err(got, want)
    share = float((err <= F32).mean())
    assert share >= FRAC, f"only {share} of the elements within {F32} of the scale"
    assert float(err.max()) <= BF16_STEP, f"max err {float(err.max())} > one bf16 step"


# ------------------------------------------------------- the scans' backward


def _wkv_draw(shape, u_shape, seed):
    """r, k, v (scale 0.5), the model's floored log decay, u (scale 0.3) and
    dy, as the reference's ``test_rwkv6_wkv_sweep`` draws its inputs."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal(shape) * 0.5 for _ in range(3))
    w = np.maximum(-np.logaddexp(rng.standard_normal(shape), 0.0) - 0.1, -2.0)
    u = rng.standard_normal(u_shape) * 0.3
    return [r, k, v, w, u], rng.standard_normal(shape)


def _ssd_draw(x_shape, n_shape, a_shape, seed):
    """x, B, C (scale 0.5), the log decay -softplus(normal), and dy, as the
    reference's ``test_mamba2_ssd_sweep`` draws its inputs."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(x_shape) * 0.5
    Bm, Cm = (rng.standard_normal(n_shape) * 0.5 for _ in range(2))
    a = -np.logaddexp(rng.standard_normal(a_shape), 0.0)
    return [x, Bm, Cm, a], rng.standard_normal(x_shape)


def _port_grads(fn, arrays, dy, dtypes):
    leaves = [torch.tensor(np.asarray(a, np.float32)).to(d).requires_grad_(True)
              for a, d in zip(arrays, dtypes)]
    fn(*leaves).backward(torch.tensor(np.asarray(dy, np.float32)).to(dtypes[0]))
    return [t.grad for t in leaves]


@pytest.mark.parametrize("S,K,chunk", [(64, 16, 16), (48, 16, 32)])
def test_wkv_scan_grads_match_reference_vjp(S, K, chunk):
    """K12b's Pallas form: ``wkv_scan`` through autograd against ``jax.vjp``
    of the reference's ``wkv_scan`` (a custom_vjp whose backward is the vjp
    of ``wkv_ref``), u one row per (b, h); S = 48 halves the chunk to 16."""
    BH = 2
    arrays, dy = _wkv_draw((BH, S, K), (BH, K), S + K)
    js = [jnp.asarray(a, jnp.float32) for a in arrays]
    _, vjp = jax.vjp(lambda *a: j_wkv_scan(*a, chunk=chunk, interpret=True), *js)
    want = vjp(jnp.asarray(dy, jnp.float32))
    counts.reset()
    got = _port_grads(lambda *a: wkv_ops.wkv_scan(*a, chunk=chunk), arrays, dy,
                      [torch.float32] * 5)
    assert counts.PLAIN_CALLS["rwkv6_wkv"] == counts.PLAIN_CALLS["rwkv6_wkv_bwd"] == 1
    for g, w in zip(got, want):
        _assert_scaled(g, w, KERNEL_F32)


@pytest.mark.parametrize("S,P,N,chunk", [(64, 8, 4, 16), (48, 8, 4, 32)])
def test_ssd_scan_grads_match_reference_vjp(S, P, N, chunk):
    """K8b's Pallas form: ``ssd_scan`` through autograd against ``jax.vjp``
    of the reference's ``ssd_scan`` (the vjp of ``ssd_ref``)."""
    BH = 2
    arrays, dy = _ssd_draw((BH, S, P), (BH, S, N), (BH, S), S + P)
    js = [jnp.asarray(a, jnp.float32) for a in arrays]
    _, vjp = jax.vjp(lambda *a: j_ssd_scan(*a, chunk=chunk, interpret=True), *js)
    want = vjp(jnp.asarray(dy, jnp.float32))
    counts.reset()
    got = _port_grads(lambda *a: ssd_ops.ssd_scan(*a, chunk=chunk), arrays, dy,
                      [torch.float32] * 4)
    assert counts.PLAIN_CALLS["mamba2_ssd"] == counts.PLAIN_CALLS["mamba2_ssd_bwd"] == 1
    for g, w in zip(got, want):
        _assert_scaled(g, w, KERNEL_F32)


@pytest.mark.parametrize("S,chunk", [(64, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_chunked_grads_match_reference(S, chunk, dtype):
    """K12b's model form: the port's ``rwkv6._wkv_chunked`` through autograd
    against ``jax.vjp`` of the reference's, u shared over the batch."""
    B, H, K = 2, 3, 16
    arrays, dy = _wkv_draw((B, S, H, K), (H, K), 7 * S)
    js = ([jnp.asarray(a, JDT[dtype]) for a in arrays[:3]]
          + [jnp.asarray(a, jnp.float32) for a in arrays[3:]])
    _, vjp = jax.vjp(lambda *a: J6._wkv_chunked(*a, chunk), *js)
    want = vjp(jnp.asarray(dy, JDT[dtype]))
    rounded = [np.asarray(jnp.asarray(a, jnp.float32)) for a in js]
    dyr = np.asarray(jnp.asarray(jnp.asarray(dy, JDT[dtype]), jnp.float32))
    got = _port_grads(lambda *a: P6._wkv_chunked(*a, chunk), rounded, dyr,
                      [TDT[dtype]] * 3 + [torch.float32] * 2)
    assert [g.dtype for g in got] == [TDT[dtype]] * 3 + [torch.float32] * 2
    for g, w in zip(got, want):
        if dtype == "float32":
            _assert_bf16_flips_only(g, w)
        else:
            _assert_scaled(g, w, BF16_GRAD)


@pytest.mark.parametrize("S,chunk", [(64, 32)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_grads_match_reference(S, chunk, dtype):
    """K8b's model form: the port's ``mamba2._ssd_chunked`` through autograd
    against ``jax.vjp`` of the reference's."""
    B, H, P, N = 2, 3, 8, 4
    arrays, dy = _ssd_draw((B, S, H, P), (B, S, H, N), (B, S, H), 5 * S)
    js = ([jnp.asarray(a, JDT[dtype]) for a in arrays[:3]]
          + [jnp.asarray(arrays[3], jnp.float32)])
    _, vjp = jax.vjp(lambda *a: JM._ssd_chunked(*a, chunk), *js)
    want = vjp(jnp.asarray(dy, JDT[dtype]))
    rounded = [np.asarray(jnp.asarray(a, jnp.float32)) for a in js]
    dyr = np.asarray(jnp.asarray(jnp.asarray(dy, JDT[dtype]), jnp.float32))
    got = _port_grads(lambda *a: PM._ssd_chunked(*a, chunk), rounded, dyr,
                      [TDT[dtype]] * 3 + [torch.float32])
    for g, w in zip(got, want):
        _assert_scaled(g, w, F32 if dtype == "float32" else BF16_GRAD)


BWD_MODELS = {"wkv": {"serial": wkv_bwd_chunks, "chunked": wkv_bwd_chunked},
              "ssd": {"serial": ssd_bwd_chunks, "chunked": ssd_bwd_chunked}}


# (B, S, H, K, chunk, u rows): several chunks, S that halves the chunk
# (40 -> 8, 33 -> 1), u one row per batch entry
@pytest.mark.parametrize("B,S,H,K,chunk,u_rows", [(2, 64, 3, 16, 16, False),
                                                  (3, 40, 1, 8, 16, True),
                                                  (1, 33, 2, 4, 16, False),
                                                  (2, 128, 2, 64, 64, True)])
@pytest.mark.parametrize("dtype,bf16_intra", [(torch.float32, False), (torch.float32, True),
                                              (torch.bfloat16, True)])
@pytest.mark.parametrize("route", ["serial", "chunked"])
def test_wkv_bwd_kernel_model_matches_plain(B, S, H, K, chunk, u_rows, dtype, bf16_intra, route):
    """K12b's algorithm on the CPU by route (``ref.wkv_bwd_chunks`` for
    ``serial``: a forward walk for the chunks' starting states, then the
    closed-form gradients chunk by chunk; ``ref.wkv_bwd_chunked`` for
    ``chunked``: both increments, both state passes, every chunk's
    gradients), against the plain backward, with the final state's gradient:
    float32 products within 1e-6 of each gradient's scale; with bf16
    intra-chunk operands the roundings of the gradients flip where the two
    sum in other orders, so within one bf16 step."""
    arrays, dy = _wkv_draw((B, S, H, K), (B if u_rows else 1, H, K), S + K)
    ts = [torch.from_numpy(a).to(dtype) for a in arrays[:3]] + [
        torch.from_numpy(a).float() for a in arrays[3:]]
    dyt = torch.from_numpy(dy).to(dtype)
    dstate = torch.from_numpy(np.random.default_rng(1).standard_normal((B, H, K, K))).float()
    c = wkv_ops.cut_chunk(chunk, S)
    got = BWD_MODELS["wkv"][route](*ts, dyt, dstate, c, bf16_intra)
    want = wkv_bwd_plain(*ts, dyt, dstate, c, bf16_intra)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_scaled(g, w, 1e-6 if dtype == torch.float32 and not bf16_intra else BF16_STEP)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [(2, 64, 3, 8, 4, 16), (1, 100, 2, 8, 8, 128),
                                             (2, 256, 2, 16, 8, 128), (1, 33, 1, 4, 4, 16)])
@pytest.mark.parametrize("dtype,model", [(torch.float32, False), (torch.float32, True),
                                         (torch.bfloat16, True)])
@pytest.mark.parametrize("route", ["serial", "chunked"])
def test_ssd_bwd_kernel_model_matches_plain(B, S, H, P, N, chunk, dtype, model, route):
    """K8b's algorithm on the CPU by route (``ref.ssd_bwd_chunks`` for
    ``serial``, ``ref.ssd_bwd_chunked`` for ``chunked``), against the plain
    backward, with the final state's gradient: within 1e-6 of each
    gradient's scale without roundings, one bf16 step with them."""
    arrays, dy = _ssd_draw((B, S, H, P), (B, S, H, N), (B, S, H), S + P)
    ts = [torch.from_numpy(a).to(dtype) for a in arrays[:3]] + [
        torch.from_numpy(arrays[3]).float()]
    dyt = torch.from_numpy(dy).to(dtype)
    dstate = torch.from_numpy(np.random.default_rng(1).standard_normal((B, H, P, N))).float()
    c = ssd_ops.cut_chunk(chunk, S)
    got = BWD_MODELS["ssd"][route](*ts, dyt, dstate, c, model)
    want = ssd_bwd_plain(*ts, dyt, dstate, c, model)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        _assert_scaled(g, w, 1e-6 if dtype == torch.float32 else BF16_STEP)


# (family, shape, chunk): several chunks, one chunk, chunks of 48 rows (a
# ragged row-tile count), a chunk that halves (40 -> 8), no final state's
# gradient
@pytest.mark.parametrize("family,shape,chunk,with_dstate", [
    ("wkv", (2, 64, 3, 16), 16, True), ("wkv", (1, 96, 2, 24), 64, True),
    ("wkv", (3, 40, 1, 8), 16, False), ("ssd", (2, 256, 2, 16, 8), 128, True),
    ("ssd", (1, 144, 2, 20, 12), 96, True), ("ssd", (2, 64, 3, 8, 4), 16, False)])
def test_bwd_models_share_chunk_states(family, shape, chunk, with_dstate):
    """The chunked model's starting states (forward pass over the
    increments) and end states' gradients (reverse pass from the final
    state's gradient) equal the serial model's walks bit for bit, as the
    kernels' two routes' states are."""
    if family == "wkv":
        B, S, H, K = shape
        arrays, dy = _wkv_draw(shape, (1, H, K), S + K)
        ts = [torch.from_numpy(a).float() for a in arrays[:4]]
        dstate = torch.from_numpy(np.random.default_rng(2).standard_normal((B, H, K, K))).float()
        c = wkv_ops.cut_chunk(chunk, S)
        states = [wkv_bwd_states(*ts, torch.from_numpy(dy).float(),
                                 dstate if with_dstate else None, c, chunked)
                  for chunked in (False, True)]
    else:
        B, S, H, P, N = shape
        arrays, dy = _ssd_draw((B, S, H, P), (B, S, H, N), (B, S, H), S + P)
        ts = [torch.from_numpy(a).float() for a in arrays]
        dstate = torch.from_numpy(np.random.default_rng(2).standard_normal((B, H, P, N))).float()
        c = ssd_ops.cut_chunk(chunk, S)
        states = [ssd_bwd_states(*ts, torch.from_numpy(dy).float(),
                                 dstate if with_dstate else None, c, chunked)
                  for chunked in (False, True)]
    (s_starts, s_ends), (c_starts, c_ends) = states
    assert s_starts.shape[2] == S // c and bool(s_ends.abs().sum() > 0)
    assert torch.equal(c_starts, s_starts) and torch.equal(c_ends, s_ends)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_chunked_model_matches_reference_vjp(dtype):
    """``ref.wkv_bwd_chunked`` (the model's function, u shared over the
    batch) against ``jax.vjp`` of the reference model's ``_wkv_chunked`` on
    the inputs rounded to the activations' dtype, at the small shape of
    ``test_wkv_chunked_grads_match_reference``, with its gates."""
    B, S, H, K, chunk = 2, 64, 3, 16, 32
    arrays, dy = _wkv_draw((B, S, H, K), (H, K), 7 * S)
    js = ([jnp.asarray(a, JDT[dtype]) for a in arrays[:3]]
          + [jnp.asarray(a, jnp.float32) for a in arrays[3:]])
    _, vjp = jax.vjp(lambda *a: J6._wkv_chunked(*a, chunk), *js)
    want = vjp(jnp.asarray(dy, JDT[dtype]))
    ts = ([torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(TDT[dtype])
           for a in js[:3]] + [torch.from_numpy(np.array(js[3]))])
    u = torch.from_numpy(np.array(js[4]))[None]
    dyt = torch.from_numpy(np.array(jnp.asarray(jnp.asarray(dy, JDT[dtype]), jnp.float32)))
    got = wkv_bwd_chunked(*ts, u, dyt.to(TDT[dtype]), None, chunk, True)
    got = list(got[:4]) + [got[4][0]]
    for g, w in zip(got, want):
        if dtype == "float32":
            _assert_bf16_flips_only(g, w)
        else:
            _assert_scaled(g, w, BF16_GRAD)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_model_matches_reference_vjp(dtype):
    """``ref.ssd_bwd_chunked`` (the model's function) against ``jax.vjp``
    of the reference model's ``_ssd_chunked`` at the small shape of
    ``test_ssd_chunked_grads_match_reference``, with its gates."""
    B, S, H, P, N, chunk = 2, 64, 3, 8, 4, 32
    arrays, dy = _ssd_draw((B, S, H, P), (B, S, H, N), (B, S, H), 5 * S)
    js = ([jnp.asarray(a, JDT[dtype]) for a in arrays[:3]]
          + [jnp.asarray(arrays[3], jnp.float32)])
    _, vjp = jax.vjp(lambda *a: JM._ssd_chunked(*a, chunk), *js)
    want = vjp(jnp.asarray(dy, JDT[dtype]))
    ts = ([torch.from_numpy(np.array(jnp.asarray(a, jnp.float32))).to(TDT[dtype])
           for a in js[:3]] + [torch.from_numpy(np.array(js[3]))])
    dyt = torch.from_numpy(np.array(jnp.asarray(jnp.asarray(dy, JDT[dtype]), jnp.float32)))
    got = ssd_bwd_chunked(*ts, dyt.to(TDT[dtype]), None, chunk, True)
    for g, w in zip(got, want):
        _assert_scaled(g, w, F32 if dtype == "float32" else BF16_GRAD)
