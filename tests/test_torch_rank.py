"""K2 (radix rank) in the port against the JAX package.

The plain torch version of the radix rank must give exactly the ranks of
the reference's ``rank_rows_reference`` (the pinned stable argsort) and of
its Pallas kernel ``radix_rank_pallas`` (interpret mode), on the IEEE edge
cases of ``tests/test_rank_kernel.py``: signed zeros, subnormals,
infinities and fully tied rows. ``aggregate_ranks`` must reproduce the
reference's weighted sum bit for bit.
"""
from __future__ import annotations

import jax
import numpy as np
import pytest
import torch

from repro.core import acquisition as RA
from repro.kernels.forest_eval import rank as RR
from repro_torch.core import acquisition as PA
from repro_torch.kernels import counts
from repro_torch.kernels.forest_eval import rank as PR

SPECIALS = np.array(
    [0.0, -0.0, 5e-324, -5e-324, 1e-310, -1e-310,
     np.finfo(np.float64).tiny, -np.finfo(np.float64).tiny,
     np.inf, -np.inf, np.finfo(np.float64).max, -np.finfo(np.float64).max,
     1.0, -1.0, 3.5, -3.5],
    dtype=np.float64,
)


def _special_rows(seed: int = 0, n_rows: int = 6, n: int = 64) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = SPECIALS[rng.integers(0, len(SPECIALS), size=(n_rows, n))]
    mask = rng.random((n_rows, n)) < 0.5
    rows = np.where(mask, rng.standard_normal((n_rows, n)), rows)
    return np.ascontiguousarray(rows)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_monotone_keys_bits_match_reference(seed):
    s = _special_rows(seed)
    want = RR.monotone_keys(s).view(np.int64)
    got = PR.monotone_keys(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed,n", [(0, 64), (1, 97), (2, 1), (3, 1500)])
def test_plain_radix_rank_matches_reference(seed, n):
    s = _special_rows(seed, n_rows=4, n=n)
    got = PR.rank_rows(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, RR.rank_rows_reference(s))


def test_plain_radix_rank_matches_pallas_interpret():
    s = _special_rows(5, n_rows=3, n=256)
    with jax.enable_x64(True):
        keys = RR.monotone_keys_traced(jax.numpy.asarray(s))
        want = np.asarray(RR.radix_rank_pallas(keys, interpret=True))
    got = PR.radix_rank(PR.monotone_keys(torch.from_numpy(s))).numpy()
    np.testing.assert_array_equal(got, want)


def test_rank_all_tied_rows_keep_index_order():
    s = np.zeros((3, 33))
    s[1] = -0.0
    s[2, ::2] = -0.0
    got = PR.rank_rows(torch.from_numpy(s)).numpy()
    np.testing.assert_array_equal(got, np.broadcast_to(np.arange(33.0), (3, 33)))


def test_rank_dispatch_counts_plain_calls():
    counts.reset()
    PR.radix_rank(torch.zeros((2, 5), dtype=torch.int64))
    assert counts.PLAIN_CALLS["radix_rank"] == 1 and counts.LAUNCHES["radix_rank"] == 0
    with pytest.raises(ValueError, match="needs tensors on the card"):
        PR.radix_rank_cuda(torch.zeros((2, 5), dtype=torch.int64))


@pytest.mark.parametrize("S,N", [(1, 1), (1, 40), (4, 1), (5, 300), (12, 2048)])
def test_aggregate_ranks_matches_reference(S, N):
    rng = np.random.default_rng(S * 1000 + N)
    scores = np.abs(rng.standard_normal((S, N)))
    scores[:, ::7] = 0.0  # EI ties at zero
    w = rng.dirichlet(np.ones(S)) * 0.999
    want = RA.aggregate_ranks(scores, w)
    got = PA.aggregate_ranks(torch.from_numpy(scores), w).numpy()
    np.testing.assert_array_equal(got, want)
