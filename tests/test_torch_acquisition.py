"""EI and the fused acquisition in the port against the JAX package.

The port's EI instantiates the reference's portable Cephes expression tree
in torch float64 ops; it must be bit-identical to the reference's numpy
``expected_improvement`` everywhere, including var = 0 (the variance
floor), |z| > 38 (the erfc tail and the exp underflow) and results that
underflow to subnormals (flushed to zero by the shared contract).
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from repro.core import acquisition as RA
from repro.core.surrogate import make_forest as r_make_forest
from repro_torch.core import acquisition as PA
from repro_torch.core.surrogate import make_forest as p_make_forest


def _ei_cases(seed):
    rng = np.random.default_rng(seed)
    n = 4000
    mean = rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
    var = np.exp(rng.uniform(-60, 10, n))
    best = rng.standard_normal(n) * np.exp(rng.uniform(-8, 8, n))
    var[::13] = 0.0                       # floored at EI_VAR_FLOOR
    mean[::17] = best[::17] + 40 * np.sqrt(np.maximum(var[::17], 1e-12))   # z ~ -40
    mean[::19] = best[::19] - 39 * np.sqrt(np.maximum(var[::19], 1e-12))   # z ~ +39
    mean[::23] = best[::23]               # z = 0
    mean[::29] = best[::29] + 1e-300      # tiny diff: underflow in the EI terms
    var[::29] = 1e-20
    return mean, var, best


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ei_bit_identical(seed):
    mean, var, best = _ei_cases(seed)
    want = RA.expected_improvement(mean, var, best)
    got = PA.expected_improvement(torch.from_numpy(mean), torch.from_numpy(var),
                                  torch.from_numpy(best)).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want == 0).any() and (want > 0).any()


def test_ei_scalar_best_and_extremes():
    z = np.concatenate([np.linspace(-45, 45, 901), [-1e6, 1e6, -38.5, 38.5, 0.0]])
    mean, var = -z, np.ones_like(z)
    for best in (0.0, 1e-310, -3.25):
        want = RA.expected_improvement(mean + best, var, best)
        got = PA.expected_improvement(torch.from_numpy(mean + best), torch.from_numpy(var),
                                      best).numpy()
        np.testing.assert_array_equal(got, want)


def test_normal_cdf_bit_identical():
    z = np.concatenate([np.linspace(-40, 40, 4001), [0.0, -0.0, 1e-300, -1e-300]])
    np.testing.assert_array_equal(PA.normal_cdf(torch.from_numpy(z)).numpy(),
                                  RA.normal_cdf(z))


def test_ei_matrix_rows():
    rng = np.random.default_rng(5)
    means, vars_ = rng.standard_normal((4, 50)), np.abs(rng.standard_normal((4, 50)))
    bests = rng.standard_normal(4)
    want = RA.ei_matrix(means, vars_, bests)
    got = PA.ei_matrix(torch.from_numpy(means), torch.from_numpy(vars_), bests).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n_sources,n", [(1, 64), (3, 1), (4, 257)])
def test_score_sources_and_aggregate_match_reference(n_sources, n):
    rng = np.random.default_rng(n_sources * 7 + n)
    refs, ports, incs = [], [], []
    for s in range(n_sources):
        X = rng.random((30 + 5 * s, 6))
        y = X[:, 0] * (s + 1) - X[:, 2] ** 2 + 0.05 * rng.standard_normal(len(X))
        refs.append(r_make_forest(seed=s).fit(X, y))
        ports.append(p_make_forest(seed=s, device="cpu").fit(X, y))
        incs.append(float(y.min()))
    pool = rng.random((n, 6))
    want = RA.score_sources(refs, pool, incs)
    got = PA.score_sources(ports, torch.from_numpy(pool), incs)
    np.testing.assert_array_equal(got.numpy(), want)
    w = rng.dirichlet(np.ones(n_sources))
    np.testing.assert_array_equal(PA.aggregate_ranks(got, w).numpy(),
                                  RA.aggregate_ranks(want, w))


def test_ei_scores_matches_reference():
    rng = np.random.default_rng(9)
    X = rng.random((25, 5))
    y = X.sum(1) + 0.1 * rng.standard_normal(25)
    pool = rng.random((192, 5))
    want = RA.ei_scores(r_make_forest(seed=3).fit(X, y), pool, float(y.min()))
    got = PA.ei_scores(p_make_forest(seed=3, device="cpu").fit(X, y), pool, float(y.min()))
    np.testing.assert_array_equal(got, want)
