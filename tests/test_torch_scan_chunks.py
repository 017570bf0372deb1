"""The chunk-parallel form of K8 (Mamba2 SSD) and K12 (RWKV6 WKV) on the
CPU: the plain PyTorch emulations of the ``chunked`` route's three launches
(``ref.ssd_chunked``, ``ref.wkv_chunked``: every chunk's state increment,
the sequential state pass, every chunk's y from its starting state) against
the plain versions (``ssd_plain``, ``wkv_plain``), the reference model's
``_ssd_chunked`` and ``_wkv_chunked`` (jax on the CPU) and the Pallas
kernels in interpret mode, and the routes' planning.

Tolerances, each with its reason:

- Final states: the emulations compute each increment with the ops the
  plain versions use and pass the state with their multiply and add, so
  the states are equal; where a BLAS blocking could sum a batched einsum
  otherwise, within 1e-6 of the largest magnitude.
- y against the plain versions: the gates of the card's tests, within one
  bf16 step of the largest magnitude in bfloat16 and 2e-5 in float32.
- y against the reference: as ``tests/test_torch_hybrid.py`` and
  ``tests/test_torch_ssm.py`` hold the plain versions. K8's float32
  function within 1e-5 of the scale and its bf16 model function 95 %
  within 1e-5 and all within one bf16 step; K12's model function rounds to
  bf16 inside even in float32: 95 % within 1e-5 and all within one bf16
  step there, two bf16 steps in bfloat16; the Pallas forms within 2e-5
  (3e-5 for K12) absolute and 1e-4 relative in float32, one bf16 step of
  the scale in bfloat16.
"""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.mamba2_ssd.kernel import ssd_fwd_pallas
from repro.kernels.rwkv6_wkv.kernel import wkv_fwd_pallas
from repro.models import mamba2 as JM
from repro.models import rwkv6 as J6
from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
from repro_torch.kernels.mamba2_ssd import ref as ssd_ref
from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
from repro_torch.kernels.rwkv6_wkv import ref as wkv_ref

F32 = 1e-5
BF16_STEP = 2.0 ** -7
FRAC = 0.95
JDT = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TDT = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# (S, chunk): several chunks; one chunk (S = c); a chunk of 100 rows (S =
# 100, no multiple of 16: the serial route on the card); c = 1 (odd S); a
# chunk that halves (96 -> 32)
CASES = [(128, 32), (64, 64), (100, 128), (7, 64), (96, 64)]


def _np(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.array(jnp.asarray(x, jnp.float32))


def _scaled_err(got, want) -> np.ndarray:
    got, want = _np(got), _np(want)
    assert got.shape == want.shape
    return np.abs(got - want) / max(float(np.abs(want).max()), 1e-30)


def _assert_state(got, want):
    if not torch.equal(got, want):
        assert float(_scaled_err(got, want).max()) <= 1e-6


def _assert_y(got, want, flips: bool, steps: int = 1):
    """Within one bf16 step (bfloat16 y) or F32 (float32 y) of the scale;
    where ``flips`` (a bf16 rounding inside), FRAC of y within F32 and all
    within ``steps`` bf16 steps."""
    err = _scaled_err(got, want)
    if flips:
        assert float((err <= F32).mean()) >= FRAC
        assert float(err.max()) <= steps * BF16_STEP, float(err.max())
    else:
        tol = BF16_STEP if got.dtype == torch.bfloat16 else 2e-5
        assert float(err.max()) <= tol, float(err.max())


# ---------------------------------------------------------------------- K8


def _ssd_inputs(B, S, H, P, N, dtype: str, seed: int):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((B, S, H, P)) * 0.5
    Bm, Cm = (rng.standard_normal((B, S, H, N)) * 0.5 for _ in range(2))
    a = -np.logaddexp(rng.standard_normal((B, S, H)), 0.0)
    js = [jnp.asarray(t, JDT[dtype]) for t in (x, Bm, Cm)] + [jnp.asarray(a, jnp.float32)]
    return js, [torch.from_numpy(np.array(t.astype(jnp.float32))).to(TDT[str(t.dtype)])
                for t in js]


@pytest.mark.parametrize("S,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("model", [True, False])
def test_ssd_chunked_matches_plain(S, chunk, dtype, model):
    js, (x, Bm, Cm, a) = _ssd_inputs(2, S, 3, 16, 8, dtype, S + chunk)
    c = ssd_ops.cut_chunk(chunk, S)
    y, st = ssd_ref.ssd_chunked(x, Bm, Cm, a, c, model)
    py, pst = ssd_ref.ssd_plain(x, Bm, Cm, a, c, model)
    assert y.dtype == TDT[dtype] and st.shape == (2, 3, 16, 8)
    _assert_state(st, pst)
    _assert_y(y, py, False)


@pytest.mark.parametrize("S,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ssd_chunked_matches_reference(S, chunk, dtype):
    """The model function against ``_ssd_chunked``; the Pallas function
    against ``ssd_fwd_pallas`` in interpret mode."""
    js, (x, Bm, Cm, a) = _ssd_inputs(2, S, 3, 16, 8, dtype, 3 * S + chunk)
    c = ssd_ops.cut_chunk(chunk, S)
    y, _ = ssd_ref.ssd_chunked(x, Bm, Cm, a, c, True)
    want = JM._ssd_chunked(*js, chunk)
    if dtype == "float32":
        assert float(_scaled_err(y, want).max()) <= F32
    else:
        _assert_y(y, want, True)
    rows = [t[:, :, 0] for t in js[:3]]
    yj, hj = ssd_fwd_pallas(*rows, js[3][:, :, 0], chunk=chunk, interpret=True)
    yp, hp = ssd_ref.ssd_chunked(*(t[:, :, :1] for t in (x, Bm, Cm, a)), c, False)
    np.testing.assert_allclose(_np(hp[:, 0]), _np(hj), atol=2e-5, rtol=1e-4)
    if dtype == "float32":
        np.testing.assert_allclose(_np(yp[:, :, 0]), _np(yj), atol=2e-5, rtol=1e-4)
    else:
        assert float(_scaled_err(yp[:, :, 0], yj).max()) <= BF16_STEP


def test_ssd_steps_compose():
    """Step 2 leaves each chunk's starting state: chunk j's is the plain
    version's final state over the first j chunks."""
    _, (x, Bm, Cm, a) = _ssd_inputs(1, 96, 2, 8, 4, "float32", 5)
    inc, decay = ssd_ref.ssd_chunk_states(x, Bm, a, 32)
    assert inc.shape == (1, 2, 3, 8, 4) and decay.shape == (1, 2, 3)
    starts, final = ssd_ref.ssd_state_pass(inc, decay)
    assert bool((starts[:, :, 0] == 0).all())
    for j in (1, 2):
        _, st = ssd_ref.ssd_plain(x[:, :32 * j], Bm[:, :32 * j], Cm[:, :32 * j], a[:, :32 * j],
                                  32, True)
        _assert_state(starts[:, :, j], st)
    y = ssd_ref.ssd_chunk_outputs(x, Bm, Cm, a, starts, 32, True)
    assert torch.equal(y, ssd_ref.ssd_chunked(x, Bm, Cm, a, 32, True)[0])


@pytest.mark.parametrize("model", [True, False])
def test_ssd_empty_sequence_returns_what_the_serial_form_returns(model):
    _, (x, Bm, Cm, a) = _ssd_inputs(2, 0, 3, 16, 8, "bfloat16", 0)
    c = ssd_ops.cut_chunk(64, 0)
    y, st = ssd_ref.ssd_chunked(x, Bm, Cm, a, c, model)
    py, pst = ssd_ref.ssd_plain(x, Bm, Cm, a, c, model)
    assert y.shape == py.shape == (2, 0, 3, 16) and y.dtype == py.dtype
    assert torch.equal(st, pst) and not bool(st.any())
    assert ssd_ops.ssd_route(0, c, 16, 8) == "serial"


# --------------------------------------------------------------------- K12


def _wkv_inputs(B, S, H, K, dtype: str, seed: int, u_shape):
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((B, S, H, K)) * 0.5 for _ in range(3))
    w = np.maximum(-np.logaddexp(rng.standard_normal((B, S, H, K)), 0.0) - 0.1, -2.0)
    u = rng.standard_normal(u_shape) * 0.3
    js = [jnp.asarray(t, JDT[dtype]) for t in (r, k, v)] + [jnp.asarray(w, jnp.float32),
                                                           jnp.asarray(u, jnp.float32)]
    return js, [torch.from_numpy(np.array(t.astype(jnp.float32))).to(TDT[str(t.dtype)])
                for t in js]


@pytest.mark.parametrize("S,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("bf16_intra", [True, False])
def test_wkv_chunked_matches_plain(S, chunk, dtype, bf16_intra):
    _, (r, k, v, w, u) = _wkv_inputs(2, S, 3, 16, dtype, S + chunk, (1, 3, 16))
    c = wkv_ops.cut_chunk(min(chunk, 64), S)
    y, st = wkv_ref.wkv_chunked(r, k, v, w, u, c, bf16_intra)
    py, pst = wkv_ref.wkv_plain(r, k, v, w, u, c, bf16_intra)
    assert y.dtype == TDT[dtype] and st.shape == (2, 3, 16, 16)
    _assert_state(st, pst)
    _assert_y(y, py, False)


@pytest.mark.parametrize("S,chunk", CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_wkv_chunked_matches_reference(S, chunk, dtype):
    """The model function against ``_wkv_chunked``; the Pallas function
    against ``wkv_fwd_pallas`` in interpret mode."""
    chunk = min(chunk, 64)
    js, (r, k, v, w, u) = _wkv_inputs(2, S, 3, 16, dtype, 5 * S + chunk, (3, 16))
    c = wkv_ops.cut_chunk(chunk, S)
    y, _ = wkv_ref.wkv_chunked(r, k, v, w, u[None], c, True)
    want = J6._wkv_chunked(*js, chunk)
    _assert_y(y, want, True, steps=1 if dtype == "float32" else 2)
    rows = [t[:, :, 0] for t in js[:4]]
    uj = jnp.broadcast_to(js[4][0], (2, 16))
    yj, sj = wkv_fwd_pallas(*rows, uj, chunk=chunk, interpret=True)
    yp, sp = wkv_ref.wkv_chunked(*(t[:, :, :1] for t in (r, k, v, w)),
                                 u[:1].expand(2, 16)[:, None].contiguous(), c, False)
    np.testing.assert_allclose(_np(sp[:, 0]), _np(sj), atol=3e-5, rtol=1e-4)
    if dtype == "float32":
        np.testing.assert_allclose(_np(yp[:, :, 0]), _np(yj), atol=3e-5, rtol=1e-4)
    else:
        assert float(_scaled_err(yp[:, :, 0], yj).max()) <= BF16_STEP


def test_wkv_steps_compose():
    """Step 2 leaves each chunk's starting state: chunk j's is the plain
    version's final state over the first j chunks."""
    _, (r, k, v, w, u) = _wkv_inputs(1, 96, 2, 8, "float32", 7, (1, 2, 8))
    inc, decay = wkv_ref.wkv_chunk_states(k, v, w, 32)
    assert inc.shape == (1, 2, 3, 8, 8) and decay.shape == (1, 2, 3, 8)
    starts, final = wkv_ref.wkv_state_pass(inc, decay)
    assert bool((starts[:, :, 0] == 0).all())
    for j in (1, 2):
        n = 32 * j
        _, st = wkv_ref.wkv_plain(r[:, :n], k[:, :n], v[:, :n], w[:, :n], u, 32, True)
        _assert_state(starts[:, :, j], st)
    y = wkv_ref.wkv_chunk_outputs(r, k, v, w, u, starts, 32, True)
    assert torch.equal(y, wkv_ref.wkv_chunked(r, k, v, w, u, 32, True)[0])


@pytest.mark.parametrize("bf16_intra", [True, False])
def test_wkv_empty_sequence_returns_what_the_serial_form_returns(bf16_intra):
    _, (r, k, v, w, u) = _wkv_inputs(2, 0, 3, 16, "bfloat16", 0, (1, 3, 16))
    c = wkv_ops.cut_chunk(64, 0)
    y, st = wkv_ref.wkv_chunked(r, k, v, w, u, c, bf16_intra)
    py, pst = wkv_ref.wkv_plain(r, k, v, w, u, c, bf16_intra)
    assert y.shape == py.shape == (2, 0, 3, 16) and y.dtype == py.dtype
    assert torch.equal(st, pst) and not bool(st.any())
    assert wkv_ops.wkv_route(0, c, 16) == "serial"


# ---------------------------------------------------------------- planning


@pytest.mark.parametrize("route_fn,cut,widths", [
    (ssd_ops.ssd_route, ssd_ops.cut_chunk, ((64, 64), (5, 5))),
    (wkv_ops.wkv_route, wkv_ops.cut_chunk, ((64,), (6,)))])
def test_routes_follow_the_cut_chunk(route_fn, cut, widths):
    """The chunked route where the cut chunk is a multiple of 16 rows (the
    prefills: zamba2's 128 at 4096 tokens, rwkv6's 64) and the state moves
    as float4, the serial route otherwise (c = 100 at S = 100, c = 1 at odd
    S, c = 8 at S = 40, a state of P N or K not a multiple of 4) and for an
    empty sequence."""
    w, odd = widths
    assert route_fn(4096, cut(128, 4096), *w) == "chunked"
    assert route_fn(4096, cut(64, 4096), *w) == "chunked"
    assert route_fn(96, cut(64, 96), *w) == "chunked"      # 32
    assert route_fn(4096, cut(64, 4096), *odd) == "serial"
    assert route_fn(100, cut(128, 100), *w) == "serial"    # 100
    assert route_fn(33, cut(64, 33), *w) == "serial"       # 1
    assert route_fn(40, cut(16, 40), *w) == "serial"       # 8
    assert route_fn(0, cut(64, 0), *w) == "serial"


@pytest.mark.parametrize("split_fn,per_sm", [(ssd_ops.ssd_split, 2), (wkv_ops.wkv_split, 4)])
def test_output_step_splits_columns_only_where_the_grid_is_short(split_fn, per_sm):
    assert split_fn(5120, 64, 132) == 1          # zamba2's prefill: 2 x 80 heads x 32 chunks
    assert split_fn(8192, 64, 132) == 1          # rwkv6's: 2 x 64 heads x 64 chunks
    assert split_fn(80, 64, 132) == 4            # one chunk of 80 heads
    assert split_fn(per_sm * 132 // 2, 64, 132) == 2
    assert split_fn(10, 16, 132) == 2            # two 8-column tiles: at most two shares
    assert split_fn(10, 8, 132) == 1


def test_wrappers_check_routes_before_the_card():
    """An unknown route is refused, and so is the chunked route where the
    shape does not take it, by the forwards and the backwards (K12b, K8b);
    the CPU takes the plain version."""
    _, (x, Bm, Cm, a) = _ssd_inputs(1, 32, 2, 8, 4, "float32", 1)
    with pytest.raises(ValueError, match="unknown route"):
        ssd_ops.ssd_cuda(x, Bm, Cm, a, 32, True, route="ring")
    with pytest.raises(ValueError, match="unknown route"):
        ssd_ops.ssd_bwd_cuda(x, Bm, Cm, a, x, None, 32, True, route="ring")
    with pytest.raises(ValueError, match="chunked route takes"):
        ssd_ops.ssd_bwd_cuda(x, Bm, Cm, a, x, None, 8, True, route="chunked")
    _, (r, k, v, w, u) = _wkv_inputs(1, 32, 2, 8, "float32", 1, (1, 2, 8))
    with pytest.raises(ValueError, match="unknown route"):
        wkv_ops.wkv_cuda(r, k, v, w, u, 32, True, route="ring")
    with pytest.raises(ValueError, match="unknown route"):
        wkv_ops.wkv_bwd_cuda(r, k, v, w, u, r, None, 32, True, route="ring")
    with pytest.raises(ValueError, match="chunked route takes"):
        wkv_ops.wkv_bwd_cuda(r, k, v, w, u, r, None, 8, True, route="chunked")
