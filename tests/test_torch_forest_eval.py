"""K1 (packed-forest descent) in the port against the JAX package.

The plain torch version of the descent must route every (tree, candidate)
lane to the same leaf as the reference's numpy ``packed_descend`` and its
Pallas kernel (``forest_eval_pallas`` in interpret mode), so leaf (mean,
var) agree exactly; ``ForestPlane.predict`` and ``PackedForest.combine``
must then reproduce the reference's numpy backend bit for bit.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import surrogate as RS
from repro.kernels.forest_eval.kernel import forest_eval_pallas
from repro_torch.convert import packed_forest_from_numpy
from repro_torch.core import surrogate as PS
from repro_torch.kernels import counts
from repro_torch.kernels.forest_eval import ops

CPU = torch.device("cpu")


def _data(seed, n=60, d=7):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d))
    y = np.sin(3 * X[:, 0]) + X[:, 1] ** 2 + 0.1 * rng.standard_normal(n)
    return X, y


def _forests(seed, n_trees=6, n=60, d=7):
    X, y = _data(seed, n, d)
    ref = RS.make_forest(seed=seed, n_trees=n_trees).fit(X, y)
    port = PS.make_forest(seed=seed, n_trees=n_trees, device="cpu").fit(X, y)
    return ref, port


def _arena_t(pf):
    return [torch.from_numpy(np.asarray(a, dtype=np.int64 if a.dtype.kind == "i" else np.float64))
            for a in (pf.feat, pf.thr, pf.child, pf.mean, pf.var, pf.roots)]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_port_fit_packs_the_reference_arena(seed):
    ref, port = _forests(seed)
    r, p = ref.pack(), port.pack().host_arrays()
    for k in ("feat", "thr", "child", "mean", "var", "roots"):
        np.testing.assert_array_equal(p[k], getattr(r, k))
    assert port.pack().depth == r.depth
    assert (port.pack().y_mean, port.pack().y_std) == (r.y_mean, r.y_std)


@pytest.mark.parametrize("seed", [0, 3])
def test_plain_descent_matches_packed_descend(seed):
    ref, _ = _forests(seed)
    pf = ref.pack()
    Xq = np.random.default_rng(seed + 10).random((257, 7))
    nid = RS.packed_descend(pf.feat, pf.thr, pf.child, pf.roots, Xq, pf.depth)
    m, v = ops.forest_eval(*_arena_t(pf), torch.from_numpy(Xq), pf.depth)
    np.testing.assert_array_equal(m.numpy(), pf.mean[nid])
    np.testing.assert_array_equal(v.numpy(), pf.var[nid])


def test_plain_descent_matches_pallas_interpret():
    ref, _ = _forests(4, n_trees=4, n=40)
    pf = ref.pack()
    Xq = np.random.default_rng(5).random((64, 7))
    # exact ties x == thr go left in every implementation
    internal = np.flatnonzero(np.isfinite(pf.thr))[:16]
    Xq[np.arange(len(internal)), pf.feat[internal]] = pf.thr[internal]
    with jax.enable_x64(True):
        jm, jv = forest_eval_pallas(
            *[jax.numpy.asarray(a) for a in (pf.feat.astype(np.int64), pf.thr,
                                             pf.child.astype(np.int64), pf.mean, pf.var,
                                             pf.roots.astype(np.int64), Xq)],
            pf.depth, block_n=32, interpret=True,
        )
        jm, jv = np.asarray(jm), np.asarray(jv)
    m, v = ops.forest_eval(*_arena_t(pf), torch.from_numpy(Xq), pf.depth)
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_array_equal(v.numpy(), jv)


@pytest.mark.parametrize("n_points", [1, 2, 300])
def test_prf_predict_matches_reference(n_points):
    ref, port = _forests(6, n_trees=10)
    Xq = np.random.default_rng(7).random((n_points, 7))
    rm, rv = ref.predict(Xq)
    pm, pv = port.predict(Xq)
    np.testing.assert_array_equal(pm, rm)
    np.testing.assert_array_equal(pv, rv)


@pytest.mark.parametrize("n_points", [1, 3, 200])
def test_forest_plane_matches_reference_numpy_backend(n_points):
    refs, ports = zip(*[_forests(s, n_trees=5 + (s % 2) * 0) for s in range(4)])
    Xq = np.random.default_rng(11).random((n_points, 7))
    rm, rv = RS.ForestPlane([r.pack() for r in refs]).predict(Xq, backend="numpy")
    plane = PS.ForestPlane([p.pack() for p in ports])
    counts.reset()
    pm, pv = plane.predict(Xq)
    assert counts.PLAIN_CALLS["forest_eval"] == 1
    np.testing.assert_array_equal(pm.numpy(), rm)
    np.testing.assert_array_equal(pv.numpy(), rv)


def test_forest_plane_mixed_tree_counts():
    refs, ports = zip(*[_forests(s, n_trees=3 + s) for s in range(3)])
    Xq = np.random.default_rng(12).random((50, 7))
    rm, rv = RS.ForestPlane([r.pack() for r in refs]).predict(Xq, backend="numpy")
    pm, pv = PS.ForestPlane([p.pack() for p in ports]).predict(Xq)
    np.testing.assert_array_equal(pm.numpy(), rm)
    np.testing.assert_array_equal(pv.numpy(), rv)


def test_combine_replays_numpy_var_and_mean():
    rng = np.random.default_rng(3)
    for T, N in [(10, 1), (10, 5), (7, 1), (16, 33), (1, 4)]:
        m_t = rng.standard_normal((T, N)) * np.exp(rng.standard_normal((T, N)) * 4)
        v_t = np.abs(rng.standard_normal((T, N)))
        pf = RS.PackedForest(*[np.zeros(1)] * 6, depth=0, y_mean=0.37, y_std=1.9)
        want = pf.combine(m_t, v_t)
        got = PS.combine(torch.from_numpy(m_t), torch.from_numpy(v_t), 0.37, 1.9, 1.9**2)
        np.testing.assert_array_equal(got[0].numpy(), want[0])
        np.testing.assert_array_equal(got[1].numpy(), want[1])


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    X, y = _data(0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PS.make_forest(seed=0)
    ref = RS.make_forest(seed=0).fit(X, y)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        packed_forest_from_numpy(ref.pack())


def test_cuda_wrapper_rejects_host_tensors():
    ref, _ = _forests(0)
    pf = ref.pack()
    with pytest.raises(ValueError, match="needs tensors on the card"):
        ops.forest_eval_cuda(*_arena_t(pf), torch.zeros(3, 7, dtype=torch.float64), pf.depth)
