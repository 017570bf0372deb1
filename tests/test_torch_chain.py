"""K3 (Shapley-chain ordinals) and the Shapley plane in the port against
the JAX package.

The plain torch walk must give exactly the exit-leaf ordinals of the
reference's numpy walk ``ChainPlan._leaf_ordinals`` (to which the Pallas
kernel ``chain_ordinals_pallas`` is pinned), for one-word trees (<= 64
leaves) and two-word trees (65..128 leaves, bit 63 included). Chain values
and ``shapley_values_batch`` must then match the reference bit for bit.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import shapley as RSh
from repro.core.surrogate import make_forest as r_make_forest
from repro.kernels.forest_eval import chain as RC
from repro_torch.core import shapley as PSh
from repro_torch.core.surrogate import make_forest as p_make_forest
from repro_torch.kernels import counts
from repro_torch.kernels.forest_eval import chain as PC


def _pair(d, seed, n, noise_only=False):
    rng = np.random.default_rng(seed)
    X = rng.random((n, d))
    y = rng.normal(size=n) if noise_only else (
        3 * X[:, 0] - X[:, 1 % d] ** 2 + 0.1 * rng.normal(size=n))
    return (r_make_forest(seed=seed).fit(X, y),
            p_make_forest(seed=seed, device="cpu").fit(X, y))


def _plans(d, seed, n, noise_only=False):
    ref, port = _pair(d, seed, n, noise_only)
    rp, reason = RC.build_chain_plan_ex(ref, d)
    pp, preason = PC.build_chain_plan_ex(port, d)
    assert rp is not None and pp is not None, (reason, preason)
    return ref, port, rp, pp


def _chain_inputs(rp, d, n_chains, nb, seed):
    rng = np.random.default_rng(seed)
    X, bg = rng.random((3, d)), rng.random((nb, d))
    perms = np.stack([rng.permutation(d) for _ in range(n_chains)])
    x_of_chain = rng.integers(0, 3, n_chains)
    return X, bg, perms, x_of_chain


@pytest.mark.parametrize(
    "d,seed,n,noise,words",
    [(6, 0, 48, False, 1), (9, 2, 60, False, 1), (5, 1, 220, True, 2)],
)
def test_plain_ordinals_match_numpy_walk(d, seed, n, noise, words):
    _, _, rp, pp = _plans(d, seed, n, noise)
    assert rp.n_words == pp.n_words == words
    X, bg, perms, xoc = _chain_inputs(rp, d, 11, 7, seed)
    wx, wb = rp.row_words(X)[xoc], rp.row_words(bg)
    np.testing.assert_array_equal(pp.row_words(X)[xoc], wx)
    want = rp._leaf_ordinals(wx, wb, perms)
    counts.reset()
    got = PC.chain_ordinals(PC.words_tensor(wx, torch.device("cpu")),
                            PC.words_tensor(wb, torch.device("cpu")),
                            torch.from_numpy(perms.astype(np.int32)))
    assert counts.PLAIN_CALLS["chain_ordinals"] == 1
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_plain_ordinals_on_random_nonzero_words_both_widths():
    """Bit 63 and word-1 exits: random words with one guaranteed bit."""
    rng = np.random.default_rng(4)
    for W in (1, 2):
        C, d, T, nb = 5, 6, 3, 4
        wx = rng.integers(0, 2**63, size=(C, d, T, W), dtype=np.uint64) | (
            rng.integers(0, 2, size=(C, d, T, W), dtype=np.uint64) << np.uint64(63))
        wb = rng.integers(0, 2**63, size=(nb, d, T, W), dtype=np.uint64)
        wx[..., -1] |= np.uint64(1) << np.uint64(63)  # keeps every AND nonzero
        wb[..., -1] |= np.uint64(1) << np.uint64(63)
        if W == 2:
            wx[..., 0] &= rng.integers(0, 2, size=(C, d, T), dtype=np.uint64) * np.uint64(2**62)
        perms = np.stack([rng.permutation(d) for _ in range(C)])
        plan = RC.ChainPlan(None, d, [], [], np.zeros(1), np.zeros(T, np.intp), n_words=W)
        want = plan._leaf_ordinals(wx if W == 2 else wx[..., 0],
                                   wb if W == 2 else wb[..., 0], perms)
        got = PC.chain_ordinals_plain(torch.from_numpy(wx.view(np.int64)),
                                      torch.from_numpy(wb.view(np.int64)),
                                      torch.from_numpy(perms.astype(np.int32)))
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("d,seed,n,noise", [(6, 0, 48, False), (5, 1, 220, True)])
def test_eval_chains_matches_reference(d, seed, n, noise):
    _, _, rp, pp = _plans(d, seed, n, noise)
    X, bg, perms, xoc = _chain_inputs(rp, d, 9, 13, seed + 1)
    want = rp.eval_chains(X, bg, perms, xoc)
    got = pp.eval_chains(X, bg, perms, xoc)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("d,n_perm,nb,n_cfg", [(6, 8, 12, 3), (9, 5, 16, 4), (24, 16, 16, 2)])
def test_shapley_values_batch_matches_reference(d, n_perm, nb, n_cfg):
    ref, port = _pair(d, 2, 64)
    rng = np.random.default_rng(d + nb)
    X, bg = rng.random((n_cfg, d)), rng.random((nb, d))
    want = RSh.shapley_values_batch(ref.predict_mean, X, bg, n_permutations=n_perm,
                                    rng=np.random.default_rng(7), model=ref)
    counts.reset()
    got = PSh.shapley_values_batch(port.predict_mean, X, bg, n_permutations=n_perm,
                                   rng=np.random.default_rng(7), model=port)
    assert counts.PLAIN_CALLS["chain_ordinals"] >= 1
    np.testing.assert_array_equal(got, want)


def test_shapley_two_word_forest_matches_reference():
    ref, port = _pair(5, 1, 220, noise_only=True)
    rng = np.random.default_rng(3)
    X, bg = rng.random((2, 5)), rng.random((6, 5))
    want = RSh.shapley_values_batch(ref.predict_mean, X, bg, n_permutations=6,
                                    rng=np.random.default_rng(1), model=ref)
    got = PSh.shapley_values_batch(port.predict_mean, X, bg, n_permutations=6,
                                   rng=np.random.default_rng(1), model=port)
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("pass_model", [True, False])
def test_shapley_composite_path_matches_reference(pass_model):
    # a forest with > 128 leaves per tree declines the chain plan, and no
    # model at all skips it: both take the composite tensor through f
    ref, port = _pair(6, 0, 600, noise_only=True)
    rng = np.random.default_rng(5)
    X, bg = rng.random((3, 6)), rng.random((7, 6))
    want = RSh.shapley_values_batch(ref.predict_mean, X, bg, n_permutations=5,
                                    rng=np.random.default_rng(2),
                                    model=ref if pass_model else None)
    counts.reset()
    got = PSh.shapley_values_batch(port.predict_mean, X, bg, n_permutations=5,
                                   rng=np.random.default_rng(2),
                                   model=port if pass_model else None)
    assert counts.PLAIN_CALLS["chain_ordinals"] == 0
    np.testing.assert_array_equal(got, want)


def test_chain_plan_declines_like_reference():
    ref, port = _pair(6, 0, 600, noise_only=True)
    assert RC.build_chain_plan_ex(ref, 6)[0] is None
    assert PC.build_chain_plan_ex(port, 6)[0] is None
    assert PC.build_chain_plan_ex(port, 70)[0] is None
    assert PC.build_chain_plan_ex(object(), 5)[0] is None
    _, port = _pair(6, 0, 48)
    assert PC.build_chain_plan_ex(port, 6)[0] is PC.build_chain_plan_ex(port, 6)[0]
