"""Each CUDA kernel of the port against its plain version on the card.

Needs an NVIDIA GPU with nvcc; skipped elsewhere. On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Small shapes and the tuner's real shapes; every comparison is exact.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


def _arena(seed, n_sources, n_obs, d, device):
    from repro_torch.core.surrogate import ForestPlane, make_forest

    rng = np.random.default_rng(seed)
    forests = []
    for s in range(n_sources):
        X = rng.random((n_obs, d))
        y = np.sin(4 * X[:, s % d]) + X[:, (s + 1) % d] + 0.1 * rng.standard_normal(n_obs)
        forests.append(make_forest(seed=s, device=device).fit(X, y))
    return forests, ForestPlane([f.pack() for f in forests])


@pytest.mark.parametrize("n_sources,n_obs,d,n", [(1, 20, 5, 7), (3, 40, 9, 1000),
                                                  (12, 50, 60, 131072)])
def test_forest_eval_matches_plain(cuda, n_sources, n_obs, d, n):
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import ops

    _, plane = _arena(n_sources, n_sources, n_obs, d, cuda)
    X = torch.rand((n, d), dtype=torch.float64, device=cuda)
    args = (plane.feat, plane.thr, plane.child, plane.mean, plane.var, plane.roots, X,
            plane.depth)
    before = counts.LAUNCHES["forest_eval"]
    got = ops.forest_eval(*args)
    assert counts.LAUNCHES["forest_eval"] == before + 1
    want = ops.forest_eval_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("S,N", [(1, 1), (3, 1023), (2, 1025), (12, 131072)])
def test_radix_rank_matches_plain(cuda, S, N):
    from repro_torch.kernels.forest_eval import rank

    g = torch.Generator(device="cpu").manual_seed(S * N)
    scores = torch.randn((S, N), generator=g, dtype=torch.float64)
    scores[:, ::3] = 0.0
    scores[:, 1::7] = -0.0
    scores[:, 2::11] = float("inf")
    keys = rank.monotone_keys(scores.to(cuda))
    got = rank.radix_rank(keys)
    torch.cuda.synchronize()
    assert torch.equal(got, rank.radix_rank_plain(keys))
    assert torch.equal(got.cpu(), rank.rank_rows(scores))


@pytest.mark.parametrize("n_obs,d,n_chains,nb", [(40, 6, 5, 3), (220, 5, 64, 16),
                                                 (50, 60, 268, 16)])
def test_chain_ordinals_matches_plain(cuda, n_obs, d, n_chains, nb):
    from repro_torch.kernels.forest_eval import chain

    forests, _ = _arena(7, 1, n_obs, d, cuda)
    plan, reason = chain.build_chain_plan_ex(forests[0], d)
    assert plan is not None, reason
    rng = np.random.default_rng(3)
    X, bg = rng.random((4, d)), rng.random((nb, d))
    perms = np.stack([rng.permutation(d) for _ in range(n_chains)]).astype(np.int32)
    xoc = rng.integers(0, 4, n_chains)
    wx = chain.words_tensor(plan.row_words(X)[xoc], cuda)
    wb = chain.words_tensor(plan.row_words(bg), cuda)
    pt = torch.from_numpy(perms).to(cuda)
    got = chain.chain_ordinals(wx, wb, pt)
    torch.cuda.synchronize()
    assert torch.equal(got, chain.chain_ordinals_plain(wx, wb, pt))
    assert torch.equal(got.cpu(), chain.chain_ordinals_plain(wx.cpu(), wb.cpu(), pt.cpu()))


def test_ei_and_scores_match_host(cuda):
    from repro_torch.core.acquisition import aggregate_ranks, score_sources

    forests, _ = _arena(5, 4, 50, 60, cuda)
    host = [f for f in _arena(5, 4, 50, 60, "cpu")[0]]
    X = np.random.default_rng(1).random((4096, 60))
    incs = [0.1, 0.2, -0.3, 0.0]
    got = score_sources(forests, torch.from_numpy(X).to(cuda), incs)
    want = score_sources(host, torch.from_numpy(X), incs)
    assert torch.equal(got.cpu(), want)
    w = [0.4, 0.3, 0.2, 0.1]
    assert torch.equal(aggregate_ranks(got, w).cpu(), aggregate_ranks(want, w))
