"""K3 (Shapley-chain ordinals) and the Shapley plane in the port against
the JAX package.

The plain torch walk must give exactly the exit-leaf ordinals of the
reference's numpy walk ``ChainPlan._leaf_ordinals`` (to which the Pallas
kernel ``chain_ordinals_pallas`` is pinned), for one-word trees (<= 64
leaves) and two-word trees (65..128 leaves, bit 63 included). Chain values
and ``shapley_values_batch`` must then match the reference bit for bit.

The CPU models of the card's routes (``ref.chain_ordinals_staged_model``,
``ref.chain_values_model``) replay each route's staging, tree tiling and
order of operations; they must equal the plain versions and the
reference's numpy walk and ``eval_chains`` bit for bit, under the card's
plans and under tree tiles that do not divide T.
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
from repro_torch.kernels.forest_eval import ref as PR


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


# ------------------------------------------------------- the card's routes


def _random_words(rng, C, nb, d, T, W):
    """Random leaf words whose every AND keeps bit 63 of the last word (so
    an exit leaf exists); with two words, word 0 is often zero."""
    def draw(*shape):
        return rng.integers(0, 2**63, size=shape, dtype=np.uint64) | (
            rng.integers(0, 2, size=shape, dtype=np.uint64) << np.uint64(63))
    wx, wb = draw(C, d, T, W), draw(nb, d, T, W)
    wx[..., -1] |= np.uint64(1) << np.uint64(63)
    wb[..., -1] |= np.uint64(1) << np.uint64(63)
    if W == 2:
        wx[..., 0] &= rng.integers(0, 2, size=(C, d, T), dtype=np.uint64) * np.uint64(2**62)
    perms = np.stack([rng.permutation(d) for _ in range(C)])
    return wx, wb, perms


def _bits(t):
    return t.contiguous().view(torch.int64)


@pytest.mark.parametrize("W", [1, 2])
@pytest.mark.parametrize("d", [5, 60, 64])
@pytest.mark.parametrize("T", [1, 10, 120])
def test_staged_model_matches_plain_and_numpy_walk(W, d, T):
    rng = np.random.default_rng(d * T + W)
    C, nb = 7, 3
    wx, wb, perms = _random_words(rng, C, nb, d, T, W)
    plan_r = RC.ChainPlan(None, d, [], [], np.zeros(1), np.zeros(T, np.intp), n_words=W)
    want = plan_r._leaf_ordinals(wx if W == 2 else wx[..., 0], wb if W == 2 else wb[..., 0],
                                 perms)
    twx, twb = torch.from_numpy(wx.view(np.int64)), torch.from_numpy(wb.view(np.int64))
    tp = torch.from_numpy(perms.astype(np.int32))
    plain = PC.chain_ordinals_plain(twx, twb, tp)
    np.testing.assert_array_equal(plain.numpy(), want)
    plan = PC.staged_plan(C, d, nb, T, W, n_sms=2)
    assert plan.route == "staged"
    # the card's plan, then tiles of ceil(T / 3) + 1 trees (3 does not divide
    # 10 or 120: the last tile is short) and 3 groups for 7 chains
    odd = plan._replace(trees=T // 3 + 1, groups=3)
    for p in (plan, odd):
        assert torch.equal(PR.chain_ordinals_staged_model(twx, twb, tp, p), plain), p


def test_staged_plan_tiles_trees():
    p = PC.ordinals_plan(268, 60, 16, 10, 1, n_sms=132)
    assert (p.route, p.trees, p.tiles, p.groups) == ("staged", 10, 1, 268)
    p = PC.staged_plan(268, 60, 16, 120, 2, n_sms=132)
    assert p.route == "staged" and p.tiles > 1 and p.smem <= PC.SMEM_BLOCK
    assert p.trees * p.tiles >= 120 > p.trees * (p.tiles - 1)
    # tiled: tiles two blocks an SM hold, one wave of them
    t = PC.staged_plan(268, 60, 16, 120, 1, n_sms=132)
    assert 2 * (t.smem + 1024) <= PC.SMEM_SM and t.groups * t.tiles <= 2 * 132
    # the crossover: tiled at 20 chains, the first design at 268
    assert PC.ordinals_plan(20, 60, 16, 120, 1, n_sms=132).route == "staged"
    assert PC.ordinals_plan(268, 60, 16, 120, 1, n_sms=132).route == "per_chain"
    # one tree's background words past a block: the first design
    assert PC.staged_plan(8, 64, 300, 10, 2, n_sms=132) is None
    assert PC.ordinals_plan(8, 64, 300, 10, 2, n_sms=132).route == "per_chain"
    # the values route at the tuner's shape, two blocks an SM
    v = PC.values_plan(268, 60, 16, 10, 1, 640, n_sms=132)
    assert (v.route, v.groups) == ("values", 268) and 2 * (v.smem + 1024) <= PC.SMEM_SM
    assert PC.ordinals_plan(512, 60, 16, 10, 1, n_sms=132).groups == 512
    assert PC.values_plan(268, 60, 16, 120, 1, 6400, n_sms=132).route == "per_chain"
    assert PC.values_plan(20, 6, PC.VALUES_MAX_NB + 1, 10, 1, 640, n_sms=132).route == "staged"
    with pytest.raises(ValueError, match="chain groups"):
        wx = torch.zeros((2, 3, 2, 1), dtype=torch.int64)
        PR.chain_ordinals_staged_model(wx, wx[:1], torch.zeros((2, 3), dtype=torch.int32),
                                       p._replace(trees=1, groups=3))


def _value_inputs(d, seed, n, noise, nb, C=7):
    _, _, rp, pp = _plans(d, seed, n, noise)
    rp.leaf_mean[::7] = -0.0
    pp.leaf_mean[::7] = -0.0
    rng = np.random.default_rng(seed + nb)
    X, bg = rng.random((3, d)), rng.random((nb, d))
    perms = np.stack([rng.permutation(d) for _ in range(C)])
    xoc = rng.integers(0, 3, C)
    cpu = torch.device("cpu")
    args = (PC.words_tensor(pp.row_words(X), cpu), torch.from_numpy(xoc.astype(np.int32)),
            PC.words_tensor(pp.row_words(bg), cpu), torch.from_numpy(perms.astype(np.int32)),
            pp.leaf_mean, pp.leaf_offs, pp.forest.y_std, pp.forest.y_mean)
    return rp, pp, (X, bg, perms, xoc), args


@pytest.mark.parametrize("nb", [1, 3, 7, 8, 9, 12, 16, 17, 130])
@pytest.mark.parametrize("d,seed,n,noise", [(6, 0, 48, False), (5, 1, 220, True)])
def test_values_model_matches_plain_and_reference(nb, d, seed, n, noise):
    rp, pp, ref_in, args = _value_inputs(d, seed, n, noise, nb)
    assert (pp.leaf_mean < 0).any() and (pp.leaf_mean > 0).any()
    plan = PC.values_plan(7, d, nb, pp.n_trees, pp.n_words, pp.leaf_mean.numel(), n_sms=2)
    assert plan.route == "values"
    plain = PC.chain_values_plain(*args)
    for p in (plan, plan._replace(groups=3)):   # and 3 groups for 7 chains
        assert torch.equal(_bits(PR.chain_values_model(*args, p)), _bits(plain))
    want = torch.from_numpy(rp.eval_chains(*ref_in))
    assert torch.equal(_bits(plain), _bits(want))


def test_values_model_keeps_signed_zeros_as_the_tail_does():
    """Leaf means of -0.0 and y_mean = -0.0: the tree sum starts from
    x[0] + 0.0, the row sum ends in + 0.0."""
    rng = np.random.default_rng(11)
    C, nb, d, T = 5, 9, 6, 3
    wx, wb, perms = _random_words(rng, C, nb, d, T, 1)
    words = torch.from_numpy(wx.view(np.int64))
    lm = torch.from_numpy(rng.normal(size=64 * T))
    lm[64:128] = -0.0                      # every leaf of tree 1
    lm[::2] = -0.0
    args = (words, torch.arange(C, dtype=torch.int32), torch.from_numpy(wb.view(np.int64)),
            torch.from_numpy(perms.astype(np.int32)), lm, torch.arange(T) * 64, 1.0, -0.0)
    plan = PC.values_plan(C, d, nb, T, 1, lm.numel(), n_sms=1)
    assert torch.equal(_bits(PR.chain_values_model(*args, plan)),
                       _bits(PC.chain_values_plain(*args)))


def test_x_of_chain_form_matches_duplicated_words():
    rp, pp, _, args = _value_inputs(6, 0, 48, False, 12, C=11)
    words, xoc, wb, perms = args[:4]
    wx = words[xoc.long()].contiguous()
    plan = PC.staged_plan(11, 6, 12, pp.n_trees, 1, n_sms=2)
    dup = PR.chain_ordinals_staged_model(wx, wb, perms, plan)
    assert torch.equal(PR.chain_ordinals_staged_model(words, wb, perms, plan, x_of_chain=xoc),
                       dup)
    assert torch.equal(dup, PC.chain_ordinals_plain(wx, wb, perms))
    assert torch.equal(_bits(PC.chain_values_plain(*args)),
                       _bits(PC.chain_tail(dup, *args[4:])))


def test_eval_chains_on_the_cpu_takes_the_plain_values():
    _, pp, ref_in, args = _value_inputs(6, 0, 48, False, 8)
    counts.reset()
    got = pp.eval_chains(*ref_in)
    assert counts.PLAIN_CALLS["chain_ordinals"] == 1 and not counts.ROUTE_LAUNCHES
    np.testing.assert_array_equal(got.view(np.int64),
                                  PC.chain_values_plain(*args).numpy().view(np.int64))
