"""Each CUDA kernel of the port against its plain version on the card.

Needs an NVIDIA GPU with nvcc; skipped elsewhere. On the GPU machine:

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

Small shapes and the tuner's real shapes; every comparison of K1-K3 is
exact. Each route of K1 (``tiled``, ``gather``) and of K2 (``count``,
``onesweep``, ``block``) is held to its plain version at N in 1, 255, 256,
257, 2048, 4097 and 131072 over 1, 12 and 34 sources or rows, on planes of
random forests and of forests fitted to simulated Spark histories, with
the route taken asserted from the launch counts per route; K2's path runs
under ``torch.cuda.set_sync_debug_mode("error")`` (no host sync), and the
onesweep workspace is reused across calls, shapes and streams. Each
route of K3 (``per_chain``, ``staged``, ``values``) is held to its plain
version bit for bit at the tuner run's six shapes, for a two-word forest,
120 trees (the staged route tiles them), 64 features and 512 chains, with
no host sync (``set_sync_debug_mode("error")``); the values route over
background sizes that take every branch of its pairwise sum. K4 (flash-attention forward) is held to the float32 and bfloat16
tolerances of the reference's ``tests/test_kernels.py`` (2e-5, 2e-2), at
small shapes with every mask variant and at the llama3-8b prefill's shape;
its bfloat16 route (wgmma and TMA, 128-row and 128-key tiles) is also held
to the smoke's K4 gate (o within 1e-3 + 8e-3 relative, lse within 1e-3) at
every head dim over ragged rows and keys, split query groups, windows with
offsets and rows that see no key; the model's flash route is held to its
plain blocked route on the card.
K5 and K6 (the backward) are held to the same tolerances over the same
grid, head dim 80 included, relative to the largest magnitude of each
gradient where that exceeds 1 (a gradient sums over up to Sk keys or Sq * G
rows); their bfloat16 route (wgmma and TMA, p and ds as hi + lo bf16
halves) is also held to the smoke's K5/K6 gate (every output within 1e-3
of its largest magnitude plus 8e-3 relative) at every head dim over K4's
tiling cases, every mask on ragged rows and keys, rows that see no key, and
at the llama3-8b training shape beside the CUDA-core design
(``flash_attn_dq_bf16_simt``, ``flash_attn_dkv_bf16_simt``), which must
meet the same gate; the flash autograd function and a reduced ``Trainer``
step on the card are held to the same on the CPU. K9 (the grouped expert matmul) is held to its plain
version within one bf16 step of the largest magnitude in bfloat16 and
2e-5 in float32, at small and ragged shapes, at mixtral-8x22b's decode and
prefill shapes and with group sizes; the reduced mixtral on the card is
held to the CPU; each of its four routes (wgmma at prefill, wgmma_decode,
mma.sync, the float32 CUDA cores) is held to it, the route taken asserted
from the launch counts per route, with NaN in every row past a group size.
K10 and K11 (RMSNorm) are held to their plain versions
within one bf16 step of the largest magnitude in bfloat16 and 1e-6/1e-5 in
float32 (rstd within 2e-6 relative), over ragged shapes and mixed gain
types, through autograd on the card against the CPU, K10 on both its
layouts (rows held in registers, and the first two-pass design, which odd
widths and unaligned rows take) at one, 4, 8192 and ragged rows of the
models' widths, K11 on both its layouts (a cluster over each tile's
columns, and one block a tile), and in a reduced dense training step whose every
gradient leaf must match the CPU's. K7 (split-KV decode attention) is held
to its plain version within one bf16 step of the largest magnitude (2e-5
in float32) on both routes (the cp.async ring, with its splits merged in
the launch, and the first design), rows of length 0, 1, a partial tile, S
and past S over a cache that is no whole number of tiles, G in 1, 4, 8, 9
and D in 64, 80, 128, at the smoke's 4 x 4096-key caches, and over calls
in a row (the ring's merge counters reset). K12 (the WKV scan) is held to its
plain version in both its functions: the state within 2e-5 of its largest
magnitude, y within one bf16 step (2e-5 in float32), and, with the
model's bf16 intra-chunk operands, where ulp-level differences flip a
rounding, 95 % of y within that and all within one more step; the reduced
rwkv6 on the card is held to the CPU. The fused propose step's Q1 (the
merged QuickScorer descent) and Q2 (combine + EI) are held to their plain
versions bit for bit at 12 sources x 10 trees over the tuner's 60 knobs,
pools of 1 to 131072, a two-word forest and root-leaf trees (Q1 also to
K1's leaf stats), Q2 with no host sync; the engine's graphs to the CPU
engine and the staged path over pools, planes and source counts (no host
sync before the result's copy, each replay's launches counted), and its
device pool to fresh draws a replay and the same draws from one seed.
"""
from __future__ import annotations

import dataclasses

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


# ------------------------------------------------------ K1 and K2 routes

ROUTE_N = [1, 255, 256, 257, 2048, 4097, 131072]


def _tuner_pool(n, d, seed):
    """A pool of n candidates with NaN, +-inf and copies of thresholds."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    X = torch.rand((n, d), generator=g, dtype=torch.float64)
    X[0, :] = float("nan")
    if n > 2:
        X[1, :] = float("inf")
        X[2, :] = -float("inf")
    return X


@pytest.mark.parametrize("route", ["tiled", "gather"])
@pytest.mark.parametrize("n_sources", [1, 12, 34])
@pytest.mark.parametrize("n", ROUTE_N)
def test_forest_eval_each_route_matches_plain(cuda, route, n_sources, n):
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import ops

    _, plane = _arena(n_sources, n_sources, 50, 60, cuda)
    X = _tuner_pool(n, 60, n).to(cuda)
    nodes = plane.node_table()
    branching = torch.isfinite(plane.thr).nonzero()[:, 0][: min(n, 64)].cpu()
    X[torch.arange(len(branching)).to(cuda) + min(3, n - 1), plane.feat[branching.to(cuda)]] = (
        plane.thr[branching.to(cuda)])   # x == thr goes left on every route
    args = (plane.feat, plane.thr, plane.child, plane.mean, plane.var, plane.roots, X,
            plane.depth)
    counts.reset()
    got = ops.forest_eval_cuda(*args, nodes=nodes, route=route)
    assert counts.ROUTE_LAUNCHES == {f"forest_eval/{route}": 1}
    want = ops.forest_eval_plain(*args)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("n", [256, 131072])
def test_forest_eval_routes_on_a_tuner_plane(cuda, n):
    """A plane of forests fitted to simulated Spark histories, as the tuner
    fits them, over a pool drawn from the tuner's space."""
    from repro_torch.core import make_forest
    from repro_torch.core.surrogate import ForestPlane
    from repro_torch.kernels.forest_eval import ops
    from repro_torch.sparksim import SparkWorkload, all_task_specs, generate_history

    space = SparkWorkload("tpch", 100, "A").space
    forests = []
    for i, spec in enumerate(all_task_specs()[:6]):
        obs = generate_history(spec.workload(), n_obs=50, seed=i, device=cuda).successful()
        X = space.encode_many([o.config for o in obs])
        forests.append(make_forest(seed=i, device=cuda).fit(
            X, np.array([o.performance for o in obs])))
    plane = ForestPlane([f.pack() for f in forests])
    pool = space.sample(np.random.default_rng(7), n).unit_tensor(cuda)
    args = (plane.feat, plane.thr, plane.child, plane.mean, plane.var, plane.roots, pool,
            plane.depth)
    want = ops.forest_eval_plain(*args)
    for route in ops.ROUTES:
        got = ops.forest_eval_cuda(*args, nodes=plane.node_table(), route=route)
        torch.cuda.synchronize()
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1]), route


def test_plane_predict_on_the_card_ignores_delta_and_launches_k1(cuda):
    """``ForestPlane.predict(X, delta=...)`` on the card is ``predict(X)``
    bit for bit through K1 (the device route ignores the chain-delta
    provenance, as the reference's accelerated backends do), and equals the
    host route with the delta plan, which the card takes only when asked."""
    from repro_torch.kernels import counts

    _, plane = _arena(5, 3, 40, 9, cuda)
    rng = np.random.default_rng(0)
    bases = rng.random((4, 9))
    base_of = np.concatenate([np.full(16, -1), rng.integers(0, 4, 48)])
    X = rng.random((64, 9))
    for i in np.flatnonzero(base_of >= 0):
        keep = rng.random(9) < 0.7
        X[i, keep] = bases[base_of[i], keep]
    counts.reset()
    got = plane.predict(X, delta=(bases, base_of))
    assert counts.LAUNCHES["forest_eval"] == 1 and counts.PLAIN_CALLS["forest_eval"] == 0
    want = plane.predict(X)
    host = plane.predict(X, "numpy", delta=(bases, base_of))
    torch.cuda.synchronize()
    assert counts.LAUNCHES["forest_eval"] == 2
    for a, b, c in zip(got, want, host):
        assert a.device.type == c.device.type == "cuda"
        assert torch.equal(a, b) and torch.equal(a, c)


def test_forest_eval_builds_its_node_table_and_plans_tiled(cuda):
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import ops

    _, plane = _arena(3, 34, 50, 60, cuda)
    X = _tuner_pool(256, 60, 1).to(cuda)
    args = (plane.feat, plane.thr, plane.child, plane.mean, plane.var, plane.roots, X,
            plane.depth)
    counts.reset()
    got = ops.forest_eval_cuda(*args)
    assert counts.ROUTE_LAUNCHES == {"forest_eval/tiled": 1}
    assert torch.equal(torch.stack(got), torch.stack(ops.forest_eval_plain(*args)))
    counts.reset()
    plane.predict(X)
    assert counts.ROUTE_LAUNCHES == {"forest_eval/tiled": 1}


def test_forest_eval_tiled_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.forest_eval import ops

    _, plane = _arena(3, 2, 50, 60, cuda)
    X = _tuner_pool(64, 8, 2).to(cuda)   # features past X's width
    args = (plane.feat, plane.thr, plane.child, plane.mean, plane.var, plane.roots, X,
            plane.depth)
    with pytest.raises(ValueError, match="tiled route needs"):
        ops.forest_eval_cuda(*args, nodes=plane.node_table(), route="tiled")


def _rank_keys(S, N, seed):
    from repro_torch.kernels.forest_eval import rank

    g = torch.Generator(device="cpu").manual_seed(seed)
    scores = torch.randn((S, N), generator=g, dtype=torch.float64)
    scores[:, ::3] = 0.0
    scores[:, 1::7] = -0.0
    scores[:, 2::11] = float("inf")
    if S > 1:
        scores[0] = 1.5            # a row of one value: every pass trivial
    if S > 2:
        scores[1] = torch.randint(0, 3, (N,), generator=g).to(torch.float64)   # ties
    return rank.monotone_keys(scores)


@pytest.mark.parametrize("route", ["count", "onesweep", "block"])
@pytest.mark.parametrize("S", [1, 12, 34])
@pytest.mark.parametrize("N", ROUTE_N)
def test_radix_rank_each_route_matches_plain(cuda, route, S, N):
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import rank

    keys = _rank_keys(S, N, S * N).to(cuda)
    if route == "count" and N > rank.COUNT_LIMIT:
        with pytest.raises(ValueError, match="count route takes"):
            rank.radix_rank_cuda(keys, route=route)
        return
    counts.reset()
    got = rank.radix_rank_cuda(keys, route=route)
    assert counts.ROUTE_LAUNCHES == {f"radix_rank/{route}": 1}
    torch.cuda.synchronize()
    assert torch.equal(got, rank.radix_rank_plain(keys))


def test_radix_rank_takes_no_host_sync(cuda):
    from repro_torch.kernels.forest_eval import rank

    for S, N in [(34, 256), (12, 131072)]:
        scores = torch.rand((S, N), dtype=torch.float64, device=cuda)
        rank.rank_rows(scores)   # builds the library and the workspace
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            got = rank.rank_rows(scores)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert torch.equal(got.cpu(), rank.rank_rows(scores.cpu()))


def test_radix_rank_workspace_reused_across_calls_and_streams(cuda):
    from repro_torch.kernels.forest_eval import rank

    shapes = [(12, 131072), (3, 5000), (34, 70000), (12, 131072), (1, 2049)]
    side = torch.cuda.Stream()
    for i, (S, N) in enumerate(shapes * 2):
        keys = _rank_keys(S, N, i).to(cuda)
        want = rank.radix_rank_plain(keys)
        stream = side if i % 3 == 1 else torch.cuda.current_stream()
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            got = rank.radix_rank_cuda(keys, route="onesweep")
        torch.cuda.synchronize()
        assert torch.equal(got, want), (S, N)
    assert len(rank._WORKSPACE) >= 2   # one a stream


def test_tuner_shapes_take_the_new_routes(cuda):
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import rank

    assert rank.rank_route(34, 256) == "count" and rank.rank_route(12, 131072) == "onesweep"
    counts.reset()
    rank.rank_rows(torch.rand((34, 256), dtype=torch.float64, device=cuda))
    assert counts.ROUTE_LAUNCHES == {"radix_rank/count": 1}


# ------------------------------------------------------------- K3 routes

# (chains, background rows) of the tuner run's six K3 shapes: d = 60, 10
# trees, one leaf word
K3_TUNER_SHAPES = [(268, 16), (96, 12), (52, 16), (20, 16), (192, 16), (84, 16)]


def _chain_forest(n_obs, d, device, n_trees=10, noise=False, seed=1):
    from repro_torch.core.surrogate import make_forest
    from repro_torch.kernels.forest_eval import chain

    rng = np.random.default_rng(seed)
    X = rng.random((n_obs, d))
    y = rng.normal(size=n_obs) if noise else (
        np.sin(4 * X[:, 0]) + X[:, 1 % d] + 0.1 * rng.standard_normal(n_obs))
    plan, reason = chain.build_chain_plan_ex(
        make_forest(seed=seed, device=device, n_trees=n_trees).fit(X, y), d)
    assert plan is not None, reason
    return plan


def _chain_args(plan, n_chains, nb, device, n_cfg=4, seed=3):
    """chain_values' arguments: word rows of n_cfg configs, each chain's
    config, the background's words, permutations and the plan's leaves."""
    from repro_torch.kernels.forest_eval import chain

    rng = np.random.default_rng(seed)
    d = plan.d
    X, bg = rng.random((n_cfg, d)), rng.random((nb, d))
    perms = np.stack([rng.permutation(d) for _ in range(n_chains)]).astype(np.int32)
    xoc = rng.integers(0, n_cfg, n_chains).astype(np.int32)
    return (chain.words_tensor(plan.row_words(X), device), torch.from_numpy(xoc).to(device),
            chain.words_tensor(plan.row_words(bg), device), torch.from_numpy(perms).to(device),
            plan.leaf_mean, plan.leaf_offs, plan.forest.y_std, plan.forest.y_mean)


def _bits(t):
    return t.contiguous().view(torch.int64)


def _hold_k3(args, values: bool):
    """Every route of K3 on ``args`` against its plain version, bit for bit,
    with no host sync in any wrapper; the route counts asserted (the chain
    values on ``values`` where ``values`` says so, else on the route the
    ordinals' plan gives)."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import chain
    from repro_torch.kernels.launch import n_sms

    words, xoc, wb, perms = args[:4]
    wx = words[xoc.long()].contiguous()
    want = chain.chain_ordinals_plain(wx, wb, perms)
    want_vals = chain.chain_values_plain(*args)
    torch.cuda.synchronize()
    counts.reset()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = {r: chain.chain_ordinals_cuda(wx, wb, perms, route=r) for r in chain.ROUTES}
        got["rows"] = chain.chain_ordinals_cuda(words, wb, perms, route="staged",
                                                x_of_chain=xoc)
        vals = chain.chain_values_cuda(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    for r, g in got.items():
        assert torch.equal(g, want), r
    assert torch.equal(_bits(vals), _bits(want_vals))
    C, d, T, W = wx.shape
    taken = chain.values_plan(C, d, wb.shape[0], T, W, args[4].numel(), n_sms(wx.device)).route
    assert (taken == "values") == values
    want_counts = {"chain_ordinals/per_chain": 1, "chain_ordinals/staged": 2}
    want_counts[f"chain_ordinals/{taken}"] = want_counts.get(f"chain_ordinals/{taken}", 0) + 1
    assert counts.ROUTE_LAUNCHES == want_counts


@pytest.mark.parametrize("C,nb", K3_TUNER_SHAPES)
def test_chain_routes_at_the_tuner_shapes(cuda, C, nb):
    plan = _chain_forest(50, 60, cuda)
    assert plan.n_words == 1 and plan.n_trees == 10
    _hold_k3(_chain_args(plan, C, nb, cuda), values=True)


@pytest.mark.parametrize("case", ["two_words", "trees_120", "d_64", "chains_512"])
def test_chain_routes_beyond_the_tuner(cuda, case):
    """The sizes the tuner does not reach: a two-word forest, 120 trees
    (tiled: the values route declines), 64 features, 512 chains."""
    from repro_torch.kernels.forest_eval import chain

    plan, C, nb = {
        "two_words": lambda: (_chain_forest(220, 5, cuda, noise=True), 48, 6),
        "trees_120": lambda: (_chain_forest(50, 60, cuda, n_trees=120), 268, 16),
        "d_64": lambda: (_chain_forest(50, 64, cuda), 268, 16),
        "chains_512": lambda: (_chain_forest(50, 60, cuda), 512, 16),
    }[case]()
    assert (plan.n_words == 2) == (case == "two_words")
    args = _chain_args(plan, C, nb, cuda)
    tiled = chain.staged_plan(C, plan.d, nb, plan.n_trees, plan.n_words, 132)
    assert (tiled.tiles > 1) == (case == "trees_120")
    _hold_k3(args, values=case != "trees_120")


@pytest.mark.parametrize("nb", [1, 7, 9, 17, 130])
def test_chain_values_route_over_background_sizes(cuda, nb):
    """Every branch of the fused pairwise sum, leaf means of both signs and
    -0.0."""
    from repro_torch.kernels.forest_eval import chain

    plan = _chain_forest(50, 6, cuda)   # 130 rows of 6 features fit a block
    args = list(_chain_args(plan, 37, nb, cuda))
    lm = args[4].clone()
    lm[::5] = -0.0
    args[4] = lm
    want = chain.chain_values_plain(*args)
    got = chain.chain_values_cuda(*args, route="values")
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want))


def test_eval_chains_on_the_card_matches_the_cpu(cuda):
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import chain

    plans = {dev: _chain_forest(50, 60, dev) for dev in (cuda, "cpu")}
    rng = np.random.default_rng(5)
    X, bg = rng.random((4, 60)), rng.random((16, 60))
    perms = np.stack([rng.permutation(60) for _ in range(67)])
    xoc = np.repeat(np.arange(4), 17)[:67]
    counts.reset()
    got = plans[cuda].eval_chains(X, bg, perms, xoc)
    assert counts.ROUTE_LAUNCHES == {"chain_ordinals/values": 1}
    assert np.array_equal(got.view(np.int64), plans["cpu"].eval_chains(X, bg, perms, xoc)
                          .view(np.int64))
    assert counts.PLAIN_CALLS["chain_ordinals"] == 1   # the CPU plan's


# --------------------------------------------------------------------- K4

FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
# (causal, window, q offset): the offset case drops the first half of the
# queries, so Sq < Sk and the rows sit at positions Sk - Sq ...
FLASH_MASKS = [(True, None, False), (False, None, False), (True, 32, False),
               (False, 32, False), (True, None, True)]


def _flash_inputs(BH, Sq, Sk, G, D, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((BH, Sq, G, D), generator=g).to(device=device, dtype=dtype)
    k = torch.randn((BH, Sk, D), generator=g).to(device=device, dtype=dtype)
    v = torch.randn((BH, Sk, D), generator=g).to(device=device, dtype=dtype)
    return q, k, v


def _close(got, want, tol):
    torch.testing.assert_close(got.float(), want.float(), atol=tol, rtol=tol)


@pytest.mark.parametrize("BH,Sq,Sk,G,D", [(2, 64, 64, 1, 16), (4, 128, 128, 2, 32),
                                          (3, 48, 80, 3, 64), (2, 64, 192, 4, 128),
                                          (1, 32, 96, 2, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,offset", FLASH_MASKS)
def test_flash_fwd_matches_plain(cuda, BH, Sq, Sk, G, D, dtype, causal, window, offset):
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops

    q, k, v = _flash_inputs(BH, Sq, Sk, G, D, dtype, cuda)
    q_offset = 0
    if offset:
        q = q[:, Sq // 2:].contiguous()
        q_offset = Sk - q.shape[1]
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=8, kv_block=16)
    before = counts.LAUNCHES["flash_attn_fwd"]
    o, lse = ops.flash_fwd(q, k, v, **kw)
    assert counts.LAUNCHES["flash_attn_fwd"] == before + 1
    o_ref, lse_ref = ops.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == dtype and lse.dtype == torch.float32
    _close(o, o_ref, FLASH_TOL[dtype])
    _close(lse, lse_ref, FLASH_TOL[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_fwd_rows_with_no_visible_key_match_plain(cuda, dtype, causal):
    from repro_torch.kernels.flash_attn import ops

    # positions 96..223 over 64 keys with a window of 32: the rows from
    # position 95 + 32 = 127 on see no key, and the reference gives them
    # the mean of every V row with lse -1e30
    q, k, v = _flash_inputs(2, 128, 64, 2, 64, dtype, cuda, seed=3)
    kw = dict(causal=causal, window=32, q_offset=96, q_block=8, kv_block=16)
    o, lse = ops.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = ops.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert bool((lse_ref[:, 32:] == -1e30).all())
    _close(o, o_ref, FLASH_TOL[dtype])
    _close(lse, lse_ref, FLASH_TOL[dtype])


def test_flash_attention_matches_oracle(cuda):
    from repro_torch.kernels.flash_attn import ops, ref

    B, S, Hkv, G, D = 2, 96, 2, 3, 64
    g = torch.Generator(device="cpu").manual_seed(1)
    q = torch.randn((B, S, Hkv, G, D), generator=g).to(cuda)
    k = torch.randn((B, S, Hkv, D), generator=g).to(cuda)
    v = torch.randn((B, S, Hkv, D), generator=g).to(cuda)
    for causal, window in [(True, None), (False, None), (True, 32)]:
        o = ops.flash_attention(q, k, v, causal=causal, window=window, q_block=32, kv_block=32)
        _close(o, ref.attention_ref(q, k, v, causal=causal, window=window), 2e-5)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_fwd_at_llama3_prefill_shape(cuda, dtype):
    from repro_torch.kernels.flash_attn import ops

    # llama3-8b prefill of 2 x 4096 tokens: B*Hkv = 16, G = 4, head dim 128
    q, k, v = _flash_inputs(16, 4096, 4096, 4, 128, dtype, cuda, seed=2)
    kw = dict(causal=True, q_block=512, kv_block=1024)
    o, lse = ops.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = ops.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(o, o_ref, FLASH_TOL[dtype])
    _close(lse, lse_ref, FLASH_TOL[dtype])


# the bf16 route's gate, that of chip_smoke.py's K4_O_TOL and K4_LSE_ATOL:
# P enters P . V as two bf16 halves, so o keeps about 16 bits of p
K4_BF16_O_TOL = (1e-3, 8e-3)
K4_LSE_ATOL = 1e-3
# (BH, Sq, Sk, G, causal, window, q_offset, input scale): 128-row q tiles
# that end inside the rows (Sq * G = 150, 240, 64, 192, 256, 600) and split
# a position's group (G = 3, 6); keys that end inside a 128-key tile, and
# fewer keys than one tile; windows with offsets; rows past the keys' end
# that see no key (the fifth case, from position 127 on); inputs x 3,
# where more rows cancel to near 0
K4_TILING_CASES = [
    (2, 50, 200, 3, True, None, 150, 3.0),
    (3, 40, 40, 6, True, None, 0, 1.0),
    (2, 64, 300, 1, False, None, 0, 1.0),
    (2, 96, 384, 2, True, 128, 288, 1.0),
    (2, 128, 64, 2, False, 32, 96, 1.0),
    (1, 100, 260, 6, True, 64, 160, 1.0),
]


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("case", K4_TILING_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_fwd_bf16_tiling_meets_the_smoke_gate(cuda, D, case):
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops

    BH, Sq, Sk, G, causal, window, q_offset, scale = case
    q, k, v = (t * scale for t in _flash_inputs(BH, Sq, Sk, G, D, torch.float32, "cpu", seed=D))
    q, k, v = (t.to(device=cuda, dtype=torch.bfloat16) for t in (q, k, v))
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=Sq, kv_block=Sk)
    before = counts.LAUNCHES["flash_attn_fwd"]
    o, lse = ops.flash_fwd(q, k, v, **kw)
    assert counts.LAUNCHES["flash_attn_fwd"] == before + 1
    o_ref, lse_ref = ops.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    assert o.dtype == torch.bfloat16 and bool(torch.isfinite(o.float()).all())
    atol, rtol = K4_BF16_O_TOL
    torch.testing.assert_close(o.float(), o_ref.float(), atol=atol, rtol=rtol)
    assert float((lse - lse_ref).abs().max()) <= K4_LSE_ATOL
    if window is not None and q_offset + Sq > Sk + window:
        assert bool((lse_ref == -1e30).any())   # the case has rows that see no key


def test_flash_fwd_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attn import ops

    for D in (48, 192):
        q, k, v = _flash_inputs(1, 64, 64, 1, D, torch.float32, cuda)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_fwd(q, k, v)
    q, k, v = _flash_inputs(1, 64, 64, 1, 64, torch.float16, cuda)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_fwd(q, k, v)
    q, k, v = _flash_inputs(1, 64, 64, 1, 64, torch.float32, cuda)
    with pytest.raises(ValueError, match="divide"):
        ops.flash_fwd(q, k, v, q_block=48)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_model_flash_route_matches_plain_route(cuda, dtype):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, forward, init_params

    cfg = reduced(get_arch("llama3-8b"))
    rt = Runtime(param_dtype=dtype, compute_dtype=dtype, attn_chunk=16, q_block=32,
                 kv_block=32)
    params = init_params(build_param_specs(cfg, rt),
                         torch.Generator(device=cuda).manual_seed(0), cuda)
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab, (2, 64))).to(cuda)
    counts.reset()
    flash = forward(params, cfg, dataclasses.replace(rt, attn_impl="flash"), tokens=tokens)
    assert counts.LAUNCHES["flash_attn_fwd"] == cfg.n_layers
    assert counts.PLAIN_CALLS["flash_attn_fwd"] == 0
    plain = forward(params, cfg, rt, tokens=tokens)
    err = (torch.softmax(flash.float(), -1) - torch.softmax(plain.float(), -1)).abs().max()
    assert float(err) < (1e-5 if dtype == "float32" else 5e-2), float(err)


# ------------------------------------------------------------------ K5, K6


def _close_scaled(got, want, tol):
    scale = max(1.0, float(want.float().abs().max()))
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=tol)


def _bwd_case(q, k, v, kw, seed=5):
    from repro_torch.kernels.flash_attn import ops

    g = torch.Generator(device="cpu").manual_seed(seed)
    do = torch.randn(q.shape, generator=g).to(device=q.device, dtype=q.dtype)
    o, lse = ops.flash_fwd(q, k, v, **kw)
    delta = (do.float() * o.float()).sum(-1)
    return do, lse, delta


def _check_bwd(q, k, v, kw):
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops

    do, lse, delta = _bwd_case(q, k, v, kw)
    before = dict(counts.LAUNCHES)
    dq = ops.flash_dq(q, k, v, do, lse, delta, **kw)
    dk, dv = ops.flash_dkv(q, k, v, do, lse, delta, **kw)
    assert counts.LAUNCHES["flash_attn_dq"] == before["flash_attn_dq"] + 1
    assert counts.LAUNCHES["flash_attn_dkv"] == before["flash_attn_dkv"] + 1
    want = (ops.flash_dq_plain(q, k, v, do, lse, delta, **kw),
            *ops.flash_dkv_plain(q, k, v, do, lse, delta, **kw))
    torch.cuda.synchronize()
    for got, ref in zip((dq, dk, dv), want):
        assert got.dtype == q.dtype
        _close_scaled(got, ref, FLASH_TOL[q.dtype])


@pytest.mark.parametrize("BH,Sq,Sk,G,D", [(2, 64, 64, 1, 16), (4, 128, 128, 2, 32),
                                          (3, 48, 80, 3, 64), (2, 64, 192, 4, 128),
                                          (1, 32, 96, 2, 64), (2, 64, 96, 1, 80),
                                          (3, 48, 160, 2, 80)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,offset", FLASH_MASKS)
def test_flash_bwd_matches_plain(cuda, BH, Sq, Sk, G, D, dtype, causal, window, offset):
    q, k, v = _flash_inputs(BH, Sq, Sk, G, D, dtype, cuda)
    q_offset = 0
    if offset:
        q = q[:, Sq // 2:].contiguous()
        q_offset = Sk - q.shape[1]
    _check_bwd(q, k, v, dict(causal=causal, window=window, q_offset=q_offset, q_block=8,
                             kv_block=16))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_rows_with_no_visible_key_match_plain(cuda, dtype, causal):
    # as in the forward's test: rows from position 127 on see no key, have
    # lse = -1e30, and give every key p = 1
    q, k, v = _flash_inputs(2, 128, 64, 2, 64, dtype, cuda, seed=3)
    _check_bwd(q, k, v, dict(causal=causal, window=32, q_offset=96, q_block=8, kv_block=16))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_flash_bwd_at_llama3_training_shape(cuda, dtype):
    # the llama3-8b training step of 2 x 4096 tokens: B*Hkv = 16, G = 4
    q, k, v = _flash_inputs(16, 4096, 4096, 4, 128, dtype, cuda, seed=4)
    _check_bwd(q, k, v, dict(causal=True, q_block=512, kv_block=1024))


def test_flash_bwd_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_attn import ops

    lse = torch.zeros((1, 64, 1), device=cuda)
    for D in (48, 192):
        q, k, v = _flash_inputs(1, 64, 64, 1, D, torch.float32, cuda)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_dq(q, k, v, q, lse, lse)
        with pytest.raises(ValueError, match="head dim"):
            ops.flash_dkv(q, k, v, q, lse, lse)
    q, k, v = _flash_inputs(1, 64, 64, 1, 64, torch.float32, cuda)
    with pytest.raises(TypeError, match="dtype"):
        ops.flash_dkv(q, k, v, q, lse.double(), lse)
    with pytest.raises(ValueError, match="divide"):
        ops.flash_dq(q, k, v, q, lse, lse, kv_block=48)


# K5's and K6's bf16 route (wgmma and TMA, p and ds as hi + lo bf16 halves)
# against chip_smoke.py's BWD_TOL["bfloat16"]: every output within 1e-3 of
# its largest magnitude plus 8e-3 relative
BWD_BF16_TOL = (1e-3, 8e-3)


def _smoke_gate(got, want):
    atol, rtol = BWD_BF16_TOL
    scale = float(want.float().abs().max())
    torch.testing.assert_close(got.float(), want.float(), atol=atol * scale, rtol=rtol)


def _bwd_simt(q, k, v, do, lse, delta, causal, window, q_offset):
    """(dq, dk, dv) of the CUDA-core design in bf16, exported as
    ``flash_attn_dq_bf16_simt`` and ``flash_attn_dkv_bf16_simt`` for
    comparisons only (the wrappers never reach it)."""
    from repro_torch.kernels.launch import _fn

    BH, Sq, G, D = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ints = (BH, Sq, k.shape[1], G, D, int(causal), int(window is not None), window or 0,
            q_offset, torch.cuda.current_stream().cuda_stream)
    ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta)]
    assert _fn("flash_attn_bwd", "flash_attn_dq_bf16_simt", 7, 9, 0)(
        *ptrs, dq.data_ptr(), *ints) == 0
    assert _fn("flash_attn_bwd", "flash_attn_dkv_bf16_simt", 8, 9, 0)(
        *ptrs, dk.data_ptr(), dv.data_ptr(), *ints) == 0
    return dq, dk, dv


def _check_bwd_bf16(q, k, v, kw, simt=False):
    """K5 and K6 in bf16 (one launch each) against their plain versions
    under the smoke's gate; with ``simt``, the CUDA-core design too."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops

    do, lse, delta = _bwd_case(q, k, v, kw)
    mask = {n: kw[n] for n in ("causal", "window", "q_offset")}
    before = dict(counts.LAUNCHES)
    got = (ops.flash_dq(q, k, v, do, lse, delta, **kw), *ops.flash_dkv(q, k, v, do, lse, delta, **kw))
    assert counts.LAUNCHES["flash_attn_dq"] == before["flash_attn_dq"] + 1
    assert counts.LAUNCHES["flash_attn_dkv"] == before["flash_attn_dkv"] + 1
    want = (ops.flash_dq_plain(q, k, v, do, lse, delta, **kw),
            *ops.flash_dkv_plain(q, k, v, do, lse, delta, **kw))
    old = _bwd_simt(q, k, v, do, lse, delta, **mask) if simt else want
    torch.cuda.synchronize()
    for g, w, o in zip(got, want, old):
        assert g.dtype == torch.bfloat16 and bool(torch.isfinite(g.float()).all())
        _smoke_gate(g, w)
        _smoke_gate(o, w)
    return lse


@pytest.mark.parametrize("D", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("case", K4_TILING_CASES, ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_bf16_tiling_meets_the_smoke_gate(cuda, D, case):
    # K4's tiling cases: 128-row q tiles and 64-key tiles (K5), 128-key
    # blocks and 64-row q tiles (K6) that end inside the rows and keys,
    # split query groups, windows with offsets, rows that see no key
    BH, Sq, Sk, G, causal, window, q_offset, scale = case
    q, k, v = (t * scale for t in _flash_inputs(BH, Sq, Sk, G, D, torch.float32, "cpu", seed=D))
    q, k, v = (t.to(device=cuda, dtype=torch.bfloat16) for t in (q, k, v))
    lse = _check_bwd_bf16(q, k, v, dict(causal=causal, window=window, q_offset=q_offset,
                                        q_block=Sq, kv_block=Sk))
    if window is not None and q_offset + Sq > Sk + window:
        assert bool((lse == -1e30).any())   # the case has rows that see no key


@pytest.mark.parametrize("D", [64, 80, 128])
@pytest.mark.parametrize("causal,window,offset", FLASH_MASKS)
def test_flash_bwd_bf16_masks_meet_the_smoke_gate(cuda, D, causal, window, offset):
    # ragged: 300 flattened rows (G = 3) and 300 keys fill no tile exactly
    q, k, v = _flash_inputs(2, 100, 300, 3, D, torch.bfloat16, cuda, seed=9)
    q_offset = 0
    if offset:
        q = q[:, 50:].contiguous()
        q_offset = 250
    _check_bwd_bf16(q, k, v, dict(causal=causal, window=window, q_offset=q_offset,
                                  q_block=q.shape[1], kv_block=100))


@pytest.mark.parametrize("causal", [True, False])
def test_flash_bwd_bf16_rows_with_no_visible_key_meet_the_smoke_gate(cuda, causal):
    # positions 96..223 over 64 keys with a window of 32: the rows from
    # position 127 on see no key and give every key p = 1
    q, k, v = _flash_inputs(2, 128, 64, 2, 64, torch.bfloat16, cuda, seed=3)
    lse = _check_bwd_bf16(q, k, v, dict(causal=causal, window=32, q_offset=96, q_block=8,
                                        kv_block=16), simt=True)
    assert bool((lse[:, 32:] == -1e30).all())


def test_flash_bwd_bf16_at_llama3_training_shape_against_the_cuda_core_design(cuda):
    # the llama3-8b training step of 2 x 4096 tokens: B*Hkv = 16, G = 4;
    # the wgmma route and the CUDA-core design both meet the smoke's gate
    q, k, v = _flash_inputs(16, 4096, 4096, 4, 128, torch.bfloat16, cuda, seed=4)
    _check_bwd_bf16(q, k, v, dict(causal=True, window=None, q_offset=0, q_block=512,
                                  kv_block=1024), simt=True)


def test_flash_autograd_on_the_card_matches_the_cpu(cuda):
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops

    B, S, Hkv, G, D = 2, 96, 2, 3, 64
    g = torch.Generator(device="cpu").manual_seed(6)
    host = [torch.randn(s, generator=g) for s in
            ((B, S, Hkv, G, D), (B, S, Hkv, D), (B, S, Hkv, D), (B, S, Hkv, G, D))]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        q, k, v = (t.to(dev).requires_grad_(True) for t in host[:3])
        counts.reset()
        o = ops.flash_attention(q, k, v, causal=True, window=48, q_block=32, kv_block=32)
        o.backward(host[3].to(dev))
        on_card = dev.type == "cuda"
        for name in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
            assert counts.LAUNCHES[name] == int(on_card)
            assert counts.PLAIN_CALLS[name] == int(not on_card)
        grads[dev.type] = [o.detach().cpu()] + [t.grad.cpu() for t in (q, k, v)]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _close_scaled(got, want, 2e-5)


def test_reduced_trainer_step_on_the_card_matches_the_cpu(cuda):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.optim import AdamWState
    from repro_torch.train.trainer import Trainer

    cfg = reduced(get_arch("llama3-8b"))
    rt = Runtime(param_dtype="float32", compute_dtype="float32", attn_impl="flash",
                 q_block=32, kv_block=32)
    kw = dict(seq_len=64, global_batch=2, lr=1e-3, seed=0)
    host = Trainer(cfg, rt, device="cpu", **kw)
    card = Trainer(cfg, rt, device=cuda, **kw)
    card.params = tree_map(lambda t: t.to(cuda), host.params)
    card.opt = AdamWState(host.opt.step.to(cuda), tree_map(lambda t: t.to(cuda), host.opt.m),
                          tree_map(lambda t: t.to(cuda), host.opt.v))
    counts.reset()
    card_losses = card.run(2, log_every=100)
    for name in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
        assert counts.LAUNCHES[name] == 2 * cfg.n_layers and counts.PLAIN_CALLS[name] == 0
    host_losses = host.run(2, log_every=100)
    np.testing.assert_allclose(card_losses, host_losses, rtol=1e-5)
    # Adam divides by sqrt(v): float32 noise in a gradient near eps moves its
    # parameter's update by up to a few hundredths of lr
    for a, b in zip(tree_leaves(card.params), tree_leaves(host.params)):
        torch.testing.assert_close(a.cpu(), b, atol=0.1 * 1e-3 * 2, rtol=0)


# --------------------------------------------------------------------- K9

def _gmm_inputs(E, C, D, F, dtype, device, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    x = torch.randn((E, C, D), generator=g).to(device=device, dtype=dtype)
    w = (torch.randn((E, D, F), generator=g) / D ** 0.5).to(device=device, dtype=dtype)
    return x, w


def _gmm_close(got, want):
    """bfloat16: within one bf16 step (2**-7 relative) of the largest
    magnitude (both sum in float32 from the same inputs, then round);
    float32: within 2e-5 of the largest magnitude and 2e-5 relative (the
    summation order differs)."""
    scale = float(want.float().abs().max())
    frac, rtol = (2.0 ** -7, 0.0) if want.dtype == torch.bfloat16 else (2e-5, 2e-5)
    torch.testing.assert_close(got.float(), want.float(), atol=frac * scale, rtol=rtol)


# (E, C, D, F): small; C, D and F off every tile edge (the scalar load path:
# D and F not multiples of 8); mixtral-8x22b's decode (C = 16 for 4 slots)
GMM_SHAPES = [(2, 32, 48, 24), (3, 130, 96, 200), (2, 77, 50, 30), (8, 16, 6144, 16384)]


@pytest.mark.parametrize("E,C,D,F", GMM_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("masked", [False, True])
def test_gmm_matches_plain(cuda, E, C, D, F, dtype, masked):
    from repro_torch.kernels import counts
    from repro_torch.kernels.moe_gmm import ops

    x, w = _gmm_inputs(E, C, D, F, dtype, cuda)
    gs = (torch.tensor([C] + [C // 2] * (E - 1), dtype=torch.int32, device=cuda)
          if masked else None)
    before, plain = counts.LAUNCHES["moe_gmm"], counts.PLAIN_CALLS["moe_gmm"]
    got = ops.grouped_matmul(x, w, gs)
    assert counts.LAUNCHES["moe_gmm"] == before + 1 and counts.PLAIN_CALLS["moe_gmm"] == plain
    want = ops.gmm_plain(x, w, gs)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (E, C, F)
    _gmm_close(got, want)
    if masked:
        assert not bool(got[1:, C // 2:].any())


def test_gmm_at_mixtral_prefill_shape(cuda):
    from repro_torch.kernels.moe_gmm import ops

    # the first layer's w_gate product of a 1 x 8192 prefill: Cr = 2560
    x, w = _gmm_inputs(8, 2560, 6144, 16384, torch.bfloat16, cuda, seed=1)
    got = ops.grouped_matmul(x, w)
    want = ops.gmm_plain(x, w)
    torch.cuda.synchronize()
    _gmm_close(got, want)


def test_gmm_group_sizes_past_the_ends(cuda):
    from repro_torch.kernels.moe_gmm import ops

    for dtype in (torch.float32, torch.bfloat16):
        x, w = _gmm_inputs(3, 140, 64, 72, dtype, cuda, seed=2)
        x[2, 100:] = float("nan")   # rows past the group size are never read
        gs = torch.tensor([0, 150, 100], dtype=torch.int32)
        got = ops.grouped_matmul(x, w, gs)   # a host tensor is moved to the card
        want = ops.gmm_plain(x, w, gs.to(cuda))
        torch.cuda.synchronize()
        assert not bool(got[0].any()) and not bool(got[2, 100:].any())
        _gmm_close(got, want)


def test_gmm_refuses_inputs_that_need_a_gradient_on_the_card(cuda):
    """K9 writes a fresh tensor and has no backward: ``grouped_matmul``
    refuses an input that needs a gradient rather than drop it, and takes
    it under ``torch.no_grad()``."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.moe_gmm import ops

    x = torch.ones((2, 32, 64), device=cuda, dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones((2, 64, 48), device=cuda, dtype=torch.bfloat16)
    counts.reset()
    with pytest.raises(NotImplementedError, match=r"ROADMAP.md item 10\(c\)"):
        ops.grouped_matmul(x, w)
    assert counts.LAUNCHES["moe_gmm"] == 0
    with torch.no_grad():
        out = ops.grouped_matmul(x, w)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["moe_gmm"] == 1 and not out.requires_grad
    assert bool((out.float() == 64).all())


def test_gmm_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.moe_gmm import ops

    x, w = _gmm_inputs(2, 8, 16, 8, torch.float32, cuda)
    with pytest.raises(TypeError, match="dtype"):
        ops.gmm_cuda(x, w.to(torch.bfloat16))
    with pytest.raises(TypeError, match="not supported"):
        ops.gmm_cuda(x.half(), w.half())
    with pytest.raises(ValueError, match="shape"):
        ops.gmm_cuda(x, w[:, :8].contiguous())
    with pytest.raises(ValueError, match="contiguous"):
        ops.gmm_cuda(x.transpose(1, 2).contiguous().transpose(1, 2), w)
    with pytest.raises(TypeError, match="int32"):
        ops.gmm_cuda(x, w, torch.ones(2, dtype=torch.int64, device=cuda))


# K9's routes (ops.gmm_route): each case on the route it must take, and in
# bf16 on PR 14's mma.sync design too, which takes any shape; the route is
# asserted from the launch counts per route
GMM_ROUTE_CASES = [
    ((2, 32, 48, 24), "wgmma_decode"), ((2, 10, 64, 136), "wgmma_decode"),
    ((2, 40, 64, 72), "wgmma_decode"), ((3, 130, 96, 200), "wgmma"),
    ((2, 300, 520, 264), "wgmma"), ((2, 77, 50, 30), "mma_sync"), ((3, 140, 60, 72), "mma_sync"),
]


def _gmm_on(route, x, w, gs=None):
    from repro_torch.kernels import counts
    from repro_torch.kernels.moe_gmm import ops

    taken = route or ops.route_of(x, w)
    counts.reset()
    got = ops.gmm_cuda(x, w, gs, route=route)
    assert counts.ROUTE_LAUNCHES == {f"moe_gmm/{taken}": 1}
    assert counts.LAUNCHES["moe_gmm"] == 1 and counts.PLAIN_CALLS["moe_gmm"] == 0
    return got


@pytest.mark.parametrize("shape,route", GMM_ROUTE_CASES)
@pytest.mark.parametrize("forced", [None, "mma_sync"])
def test_gmm_each_route_matches_plain(cuda, shape, route, forced):
    from repro_torch.kernels.moe_gmm import ops

    E, C, D, F = shape
    x, w = _gmm_inputs(E, C, D, F, torch.bfloat16, cuda, seed=3)
    assert ops.route_of(x, w) == route
    got = _gmm_on(forced, x, w)
    torch.cuda.synchronize()
    _gmm_close(got, ops.gmm_plain(x, w))


@pytest.mark.parametrize("E,C,D,F", [(8, 16, 6144, 16384), (8, 16, 16384, 6144)])
def test_gmm_wgmma_decode_route_at_mixtral_decode_shapes(cuda, E, C, D, F):
    # a decode step's w_gate (and w_up) and w_down products
    from repro_torch.kernels.moe_gmm import ops

    x, w = _gmm_inputs(E, C, D, F, torch.bfloat16, cuda, seed=4)
    got = _gmm_on("wgmma_decode", x, w)
    torch.cuda.synchronize()
    _gmm_close(got, ops.gmm_plain(x, w))


def test_gmm_wgmma_route_at_mixtral_prefill_shape(cuda):
    from repro_torch.kernels.moe_gmm import ops

    x, w = _gmm_inputs(8, 2560, 6144, 16384, torch.bfloat16, cuda, seed=5)
    got = _gmm_on(None, x, w)
    want = ops.gmm_plain(x, w)
    torch.cuda.synchronize()
    _gmm_close(got, want)


@pytest.mark.parametrize("shape,route",
                         GMM_ROUTE_CASES + [((8, 16, 16384, 6144), "wgmma_decode")])
def test_gmm_routes_with_group_sizes_never_use_rows_past_them(cuda, shape, route):
    """Group sizes of 0, a partial tile and past C, with NaN in every row
    past its group size, on the route the shape takes and on mma.sync."""
    from repro_torch.kernels.moe_gmm import ops

    E, C, D, F = shape
    x, w = _gmm_inputs(E, C, D, F, torch.bfloat16, cuda, seed=6)
    sizes = ([0, C + 7] + [min(C, 129)] * (E - 2))[:E]
    xn = x.clone()
    for e, n in enumerate(sizes):
        xn[e, n:] = float("nan")
    gs = torch.tensor(sizes, dtype=torch.int32, device=cuda)
    want = ops.gmm_plain(x, w, gs)
    for forced in (None, "mma_sync"):
        got = _gmm_on(forced, xn, w, gs)
        torch.cuda.synchronize()
        assert bool(torch.isfinite(got).all()) and not bool(got[0].any())
        _gmm_close(got, want)


def test_gmm_wgmma_routes_refuse_what_tma_cannot_describe(cuda):
    from repro_torch.kernels.moe_gmm import ops

    x, w = _gmm_inputs(2, 77, 50, 30, torch.bfloat16, cuda)
    for route, rows in (("wgmma", 77), ("wgmma_decode", 16)):
        with pytest.raises(RuntimeError, match="launch failed"):
            ops.gmm_cuda(x[:, :rows].contiguous(), w, route=route)
    with pytest.raises(TypeError, match="takes f32"):
        ops.gmm_cuda(x, w, route="cuda_core_f32")
    with pytest.raises(ValueError, match="unknown route"):
        ops.gmm_cuda(x, w, route="bmm")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_mixtral_on_the_card_matches_the_cpu(cuda, dtype):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, decode_step, forward
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.params import tree_map

    cfg = reduced(get_arch("mixtral-8x22b"))
    rt = Runtime(param_dtype=dtype, compute_dtype=dtype, attn_impl="flash", q_block=32,
                 kv_block=32)
    host = init_params(build_param_specs(cfg, rt), torch.Generator().manual_seed(0), "cpu")
    card = tree_map(lambda t: t.to(cuda), host)
    tokens = np.random.default_rng(0).integers(2, cfg.vocab, (2, 64))
    counts.reset()
    got = forward(card, cfg, rt, tokens=torch.from_numpy(tokens).to(cuda))
    assert counts.LAUNCHES["moe_gmm"] == 3 * cfg.n_layers
    cache = init_cache(cfg, rt, 2, 8, device=cuda)
    lg, _ = decode_step(card, cfg, rt, cache, torch.from_numpy(tokens[:, :1]).to(cuda))
    assert counts.LAUNCHES["moe_gmm"] == 6 * cfg.n_layers
    assert counts.PLAIN_CALLS["moe_gmm"] == 0
    want = forward(host, cfg, rt, tokens=torch.from_numpy(tokens))
    err = (torch.softmax(got.float().cpu(), -1) - torch.softmax(want.float(), -1)).abs().max()
    assert float(err) < (1e-5 if dtype == "float32" else 5e-2), float(err)
    host_lg, _ = decode_step(host, cfg, rt, init_cache(cfg, rt, 2, 8, device="cpu"),
                             torch.from_numpy(tokens[:, :1]))
    err = (torch.softmax(lg.float().cpu(), -1) - torch.softmax(host_lg.float(), -1)).abs().max()
    assert float(err) < (1e-5 if dtype == "float32" else 5e-2), float(err)


# ---------------------------------------------------------------- K10, K11

def _bf16_or_f32_close(got, want, f32_tol):
    """bfloat16: within one bf16 step (2**-7) of the largest magnitude (both
    compute in float32 from the same inputs, then round); float32: within
    ``f32_tol`` of it (the summation order differs)."""
    scale = float(want.float().abs().max())
    tol = 2.0 ** -7 if want.dtype == torch.bfloat16 else f32_tol
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=0)


# (N, D): one row; ragged N and a D that is not a multiple of 8 (the scalar
# path); rwkv6-7b's and llama3-8b's width at the prefill; mixtral's width
RMS_SHAPES = [(1, 64), (37, 50), (200, 96), (8192, 4096), (130, 6144)]


@pytest.mark.parametrize("N,D", RMS_SHAPES)
@pytest.mark.parametrize("dtype,wdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32)])
def test_rmsnorm_fwd_and_bwd_match_plain(cuda, N, D, dtype, wdtype):
    from repro_torch.kernels import counts
    from repro_torch.kernels.rmsnorm import ops

    g = torch.Generator(device="cpu").manual_seed(N + D)
    x = (torch.randn((N, D), generator=g) * 3).to(cuda, dtype)
    w = torch.randn((D,), generator=g).to(cuda, wdtype)
    do = torch.randn((N, D), generator=g).to(cuda, dtype)
    before = dict(counts.LAUNCHES)
    out, rstd = ops.rmsnorm_fwd(x, w, 1e-5)
    dx, parts = ops.rmsnorm_bwd(x, w, rstd, do)
    assert counts.LAUNCHES["rmsnorm_fwd"] == before["rmsnorm_fwd"] + 1
    assert counts.LAUNCHES["rmsnorm_bwd"] == before["rmsnorm_bwd"] + 1
    pout, prstd = ops.rmsnorm_fwd_plain(x, w, 1e-5)
    pdx, pparts = ops.rmsnorm_bwd_plain(x, w, rstd, do)
    torch.cuda.synchronize()
    assert out.dtype == dtype and dx.dtype == dtype and parts.shape == pparts.shape
    torch.testing.assert_close(rstd, prstd, atol=0, rtol=2e-6)
    _bf16_or_f32_close(out, pout, 1e-6)
    _bf16_or_f32_close(dx, pdx, 1e-5)
    torch.testing.assert_close(parts, pparts, atol=1e-5 * float(pparts.abs().max()), rtol=1e-5)



# K10 on both layouts: one row, a decode step's 4, a prefill's 8192 and a
# ragged count, at the widths the models run (2560, 4096, 5120, 6144), in
# bf16 with either gain type and in float32 (6144 in float32 is past the
# resident route's 4096 and takes the two-pass one)
@pytest.mark.parametrize("N", [1, 4, 8192, 37])
@pytest.mark.parametrize("D", [2560, 4096, 5120, 6144])
@pytest.mark.parametrize("dtype,wdtype", [(torch.bfloat16, torch.bfloat16),
                                          (torch.bfloat16, torch.float32),
                                          (torch.float32, torch.float32)])
@pytest.mark.parametrize("route", [None, "two_pass"])
def test_rmsnorm_fwd_layouts_match_plain(cuda, N, D, dtype, wdtype, route):
    from repro_torch.kernels import counts
    from repro_torch.kernels.rmsnorm import ops

    g = torch.Generator(device="cpu").manual_seed(N + D)
    x = (torch.randn((N, D), generator=g) * 3).to(cuda, dtype)
    w = torch.randn((D,), generator=g).to(cuda, wdtype)
    taken = route or ops.rmsnorm_fwd_route(dtype, D, True)
    assert taken == ("resident" if route is None and D <= ops.RESIDENT_MAX_D[dtype]
                     else "two_pass")
    counts.reset()
    out, rstd = ops.rmsnorm_fwd_cuda(x, w, 1e-5, route=route)
    assert counts.ROUTE_LAUNCHES == {f"rmsnorm_fwd/{taken}": 1}
    pout, prstd = ops.rmsnorm_fwd_plain(x, w, 1e-5)
    torch.cuda.synchronize()
    assert out.dtype == dtype and rstd.shape == (N,)
    torch.testing.assert_close(rstd, prstd, atol=0, rtol=2e-6)
    _bf16_or_f32_close(out, pout, 1e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_fwd_odd_widths_and_unaligned_rows_take_the_two_pass_route(cuda, dtype):
    from repro_torch.kernels import counts
    from repro_torch.kernels.rmsnorm import ops

    g = torch.Generator(device="cpu").manual_seed(11)
    cases = [(torch.randn((33, 4099), generator=g) * 3).to(cuda, dtype)]
    buf = torch.empty(130 * 2560 + 1, dtype=dtype, device=cuda)
    cases.append(buf[1:].view(130, 2560))
    cases[1].copy_(torch.randn((130, 2560), generator=g) * 3)
    for x in cases:
        w = torch.randn((x.shape[1],), generator=g).to(cuda, torch.bfloat16)
        counts.reset()
        out, rstd = ops.rmsnorm_fwd(x, w, 1e-5)
        assert counts.ROUTE_LAUNCHES == {"rmsnorm_fwd/two_pass": 1}
        pout, prstd = ops.rmsnorm_fwd_plain(x, w, 1e-5)
        torch.cuda.synchronize()
        torch.testing.assert_close(rstd, prstd, atol=0, rtol=2e-6)
        _bf16_or_f32_close(out, pout, 1e-6)
    with pytest.raises(ValueError, match="does not take"):
        ops.rmsnorm_fwd_cuda(cases[1], w, route="resident")

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_rmsnorm_autograd_on_the_card_matches_the_cpu(cuda, dtype):
    from repro_torch.kernels import counts
    from repro_torch.models.blocks import rmsnorm

    g = torch.Generator(device="cpu").manual_seed(3)
    host = [torch.randn(s, generator=g).to(dtype) for s in ((2, 300, 256), (256,), (2, 300, 256))]
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        x, w = (t.to(dev).requires_grad_(True) for t in host[:2])
        counts.reset()
        out = rmsnorm(x, w, 1e-5)
        out.backward(host[2].to(dev))
        on_card = dev.type == "cuda"
        for name in ("rmsnorm_fwd", "rmsnorm_bwd"):
            assert counts.LAUNCHES[name] == int(on_card)
            assert counts.PLAIN_CALLS[name] == int(not on_card)
        grads[dev.type] = [out.detach().cpu(), x.grad.cpu(), w.grad.cpu()]
    for got, want in zip(grads["cuda"], grads["cpu"]):
        _bf16_or_f32_close(got, want, 1e-5)


def test_rmsnorm_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.rmsnorm import ops

    x, w = torch.ones((4, 8), device=cuda), torch.ones(8, device=cuda)
    with pytest.raises(TypeError, match="not supported"):
        ops.rmsnorm_fwd_cuda(x.half(), w)
    with pytest.raises(ValueError, match="shape"):
        ops.rmsnorm_fwd_cuda(x, torch.ones(9, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        ops.rmsnorm_fwd_cuda(torch.ones((8, 4), device=cuda).t(), w)
    with pytest.raises(TypeError, match="dtype"):
        ops.rmsnorm_bwd_cuda(x, w, torch.ones(4, device=cuda), x.to(torch.bfloat16))


# K11 on both layouts: the training shape, N not a multiple of 128, D not a
# multiple of the cluster's column slice (4100: five blocks of 824 columns,
# the last 804), unvectorised rows over two blocks, and wider than a cluster
@pytest.mark.parametrize("N,D", [(8192, 4096), (300, 4096), (300, 4100), (129, 1030),
                                 (130, 16384)])
@pytest.mark.parametrize("dtype,wdtype", [(torch.float32, torch.float32),
                                          (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("route", [None, "tile"])
def test_rmsnorm_bwd_layouts_match_plain(cuda, N, D, dtype, wdtype, route):
    from repro_torch.kernels import counts
    from repro_torch.kernels.rmsnorm import ops

    g = torch.Generator(device="cpu").manual_seed(N * 7 + D)
    x = (torch.randn((N, D), generator=g) * 3).to(cuda, dtype)
    w = torch.randn((D,), generator=g).to(cuda, wdtype)
    do = torch.randn((N, D), generator=g).to(cuda, dtype)
    _, rstd = ops.rmsnorm_fwd(x, w, 1e-5)
    counts.reset()
    dx, parts = ops.rmsnorm_bwd_cuda(x, w, rstd, do, route=route)
    assert counts.ROUTE_LAUNCHES == {f"rmsnorm_bwd/{route or ops.rmsnorm_bwd_route(D)}": 1}
    pdx, pparts = ops.rmsnorm_bwd_plain(x, w, rstd, do)
    torch.cuda.synchronize()
    assert parts.shape == ((N + 127) // 128, D)
    _bf16_or_f32_close(dx, pdx, 1e-5)
    torch.testing.assert_close(parts, pparts, atol=1e-5 * float(pparts.abs().max()), rtol=1e-5)


def test_rmsnorm_bwd_cluster_refuses_rows_wider_than_a_cluster(cuda):
    from repro_torch.kernels.rmsnorm import ops

    x, w = torch.ones((4, 8200), device=cuda), torch.ones(8200, device=cuda)
    with pytest.raises(ValueError, match="does not take"):
        ops.rmsnorm_bwd_cuda(x, w, torch.ones(4, device=cuda), x, route="cluster")


def test_dense_training_step_differentiates_through_k11(cuda):
    """Every gradient leaf of a reduced llama3-8b step exists with K10 and
    K11 on the path, and matches the CPU's."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, init_params, loss_fn
    from repro_torch.models.params import tree_leaves, tree_map

    cfg = reduced(get_arch("llama3-8b"))
    rt = Runtime(param_dtype="float32", compute_dtype="float32", attn_impl="flash",
                 q_block=32, kv_block=32)
    host = init_params(build_param_specs(cfg, rt), torch.Generator().manual_seed(0), "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(2, cfg.vocab, (2, 65)))
    grads = {}
    for dev in (cuda, torch.device("cpu")):
        params = tree_map(lambda t: t.to(dev).requires_grad_(True), host)
        batch = {"tokens": tokens[:, :-1].to(dev), "labels": tokens[:, 1:].to(dev)}
        counts.reset()
        loss = loss_fn(params, cfg, rt, batch)
        leaves = tree_leaves(params)
        grads[dev.type] = [gr.cpu() for gr in torch.autograd.grad(loss, leaves)]
        if dev.type == "cuda":
            assert counts.LAUNCHES["rmsnorm_fwd"] == counts.LAUNCHES["rmsnorm_bwd"] \
                == 2 * cfg.n_layers + 1
            assert counts.PLAIN_CALLS["rmsnorm_fwd"] == counts.PLAIN_CALLS["rmsnorm_bwd"] == 0
    for got, want in zip(grads["cuda"], grads["cpu"]):
        assert bool(want.abs().max() > 0)
        err = float((got - want).norm() / want.norm())
        assert err < 1e-4, err


# --------------------------------------------------------------------- K12

def _wkv_inputs(B, S, H, K, dtype, wdtype, device, seed=0):
    """r, k, v at scale 0.5, the model's floored log decay, u at scale 0.3."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    r, k, v = ((torch.randn((B, S, H, K), generator=g) * 0.5).to(device, dtype)
               for _ in range(3))
    w = (-torch.nn.functional.softplus(torch.randn((B, S, H, K), generator=g)) - 0.1)
    w = w.clamp_min(-2.0).to(device, wdtype)
    u = (torch.randn((H, K), generator=g) * 0.3).to(device)
    return r, k, v, w, u


def _wkv_close(y, py, st, pst, bf16_intra):
    """The state within 2e-5 of its largest magnitude. y in float32 products:
    within one bf16 step of its largest magnitude in bfloat16, 2e-5 in
    float32. With bf16 intra-chunk operands the function jumps by one bf16
    step where the kernel's and the plain version's float32 intermediates
    (sequential vs scanned cumsum, expf vs torch's exp) straddle a rounding
    boundary: there at least 95 % of y within that bound and all within one
    bf16 step (float32 y) or two (bfloat16 y)."""
    sscale = float(pst.abs().max())
    torch.testing.assert_close(st, pst, atol=2e-5 * sscale, rtol=2e-5)
    scale = float(py.float().abs().max())
    tol = 2.0 ** -7 if py.dtype == torch.bfloat16 else 2e-5
    err = (y.float() - py.float()).abs() / scale
    if not bf16_intra:
        assert float(err.max()) <= tol, float(err.max())
        return
    assert float((err <= tol).float().mean()) >= 0.95
    assert float(err.max()) <= (2 if py.dtype == torch.bfloat16 else 1) * 2.0 ** -7


# (B, S, H, K, chunk): the rwkv6-7b layout at full head width with a few
# chunks; the reduced model's; S not a multiple of the chunk (48 -> 16,
# 33 -> 1); K below 64 and not a power of two; K = 20, whose bf16 rows are
# no 16-byte multiple (element loads), over two chunks of 32
WKV_SHAPES = [(2, 256, 4, 64, 64), (2, 64, 4, 32, 32), (1, 48, 3, 32, 32), (2, 33, 2, 16, 16),
              (1, 96, 5, 24, 64), (1, 64, 3, 20, 32)]
WKV_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("B,S,H,K,chunk", WKV_SHAPES)
@pytest.mark.parametrize("dtype,wdtype", WKV_DTYPES)
@pytest.mark.parametrize("bf16_intra", [False, True])
@pytest.mark.parametrize("route", [None, "chunked", "serial"])
def test_wkv_matches_plain(cuda, B, S, H, K, chunk, dtype, wdtype, bf16_intra, route):
    """Each route, and the one ``wkv_route`` plans (None), against the plain
    version; the chunked route refuses a chunk that is no multiple of 16."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.rwkv6_wkv import ops

    r, k, v, w, u = _wkv_inputs(B, S, H, K, dtype, wdtype, cuda, seed=S + K)
    c = ops.cut_chunk(chunk, S)
    if route == "chunked" and ops.wkv_route(S, c, K) != "chunked":
        with pytest.raises(ValueError, match="chunked route takes"):
            ops.wkv_cuda(r, k, v, w, u[None], c, bf16_intra, route=route)
        return
    counts.reset()
    with torch.no_grad():
        if route is None:
            y, st = ops._wkv(r, k, v, w, u[None], chunk, bf16_intra)
        else:
            y, st = ops.wkv_cuda(r, k, v, w, u[None], c, bf16_intra, route=route)
        py, pst = ops.wkv_plain(r, k, v, w, u[None], c, bf16_intra)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["rwkv6_wkv"] == 1
    assert counts.ROUTE_LAUNCHES == {f"rwkv6_wkv/{route or ops.wkv_route(S, c, K)}": 1}
    assert y.dtype == dtype and st.shape == (B, H, K, K)
    _wkv_close(y, py, st, pst, bf16_intra)


@pytest.mark.parametrize("B,S,H,K,chunk",
                         [s for s in WKV_SHAPES if s[1] % 16 == 0 and s[3] % 4 == 0])
@pytest.mark.parametrize("dtype,wdtype", WKV_DTYPES)
@pytest.mark.parametrize("bf16_intra", [False, True])
def test_wkv_chunked_state_is_the_serial_state(cuda, B, S, H, K, chunk, dtype, wdtype,
                                               bf16_intra):
    """The chunked route sums each chunk's increment in the serial route's
    order and passes the state with its multiply and add: the final states
    are equal bit for bit."""
    from repro_torch.kernels.rwkv6_wkv import ops

    r, k, v, w, u = _wkv_inputs(B, S, H, K, dtype, wdtype, cuda, seed=3 * S + K)
    c = ops.cut_chunk(chunk, S)
    assert ops.wkv_route(S, c, K) == "chunked"
    with torch.no_grad():
        _, st = ops.wkv_cuda(r, k, v, w, u[None], c, bf16_intra, route="chunked")
        _, st_serial = ops.wkv_cuda(r, k, v, w, u[None], c, bf16_intra, route="serial")
    torch.cuda.synchronize()
    assert torch.equal(st, st_serial), float((st - st_serial).abs().max())


def test_wkv_pallas_layout_on_the_card(cuda):
    """``wkv_fwd`` ((BH, S, K), a bonus row per (b, h)) against its plain
    version in float32, and the model layout against the same rows."""
    from repro_torch.kernels.rwkv6_wkv import ops

    r, k, v, w, _ = _wkv_inputs(1, 128, 6, 32, torch.float32, torch.float32, cuda, seed=9)
    rows = [t[0].permute(1, 0, 2).contiguous() for t in (r, k, v, w)]   # (6, 128, 32)
    u = torch.randn((6, 32), generator=torch.Generator().manual_seed(1)).to(cuda) * 0.3
    y, st = ops.wkv_fwd(*rows, u, chunk=32)
    py, pst = ops.wkv_plain(*(t[:, :, None] for t in rows), u[:, None], 32, False)
    torch.cuda.synchronize()
    _wkv_close(y, py[:, :, 0], st, pst[:, 0], False)


def test_wkv_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.rwkv6_wkv import ops

    r, k, v, w, u = _wkv_inputs(1, 8, 2, 16, torch.float32, torch.float32, cuda)
    with pytest.raises(ValueError, match="K = 65 > 64"):
        big = [torch.zeros((1, 8, 1, 65), device=cuda) for _ in range(4)]
        ops.wkv_heads(*big, torch.zeros((1, 65), device=cuda), chunk=8)
    with pytest.raises(ValueError, match="chunk 128 > 64"):
        long = [torch.zeros((1, 128, 2, 16), device=cuda) for _ in range(4)]
        ops.wkv_heads(*long, u, chunk=128)
    with pytest.raises(TypeError, match="not supported"):
        ops.wkv_cuda(r.half(), k.half(), v.half(), w, u[None], 8, True)
    with pytest.raises(ValueError, match="contiguous"):
        ops.wkv_cuda(r.transpose(1, 2).contiguous().transpose(1, 2), k, v, w, u[None], 8, True)


def _grads_close(got, want, exact):
    """Each gradient within 2e-5 of its largest magnitude where the function
    rounds nothing to bf16 (``exact``: float32 tensors, float32 products),
    else within two bf16 steps of it: a bf16 rounding inside the forward
    rounds the gradient that crosses it, and the kernel's float32 sums,
    taken in another order than the plain version's, flip single
    roundings."""
    for i, (g, p) in enumerate(zip(got, want)):
        assert g.shape == p.shape and g.dtype == p.dtype, (i, g.shape, p.shape, g.dtype)
        scale = max(float(p.float().abs().max()), 1e-30)
        err = float((g.float() - p.float()).abs().max()) / scale
        assert err <= (2e-5 if exact else 2 * 2.0 ** -7), (i, err)


# (B, S, H, K, chunk): rwkv6-7b's head width over a few chunks of 64; the
# reduced model's; S that halves the chunk (48 -> 16, 33 -> 1); K below 64
# and not a power of two
WKV_BWD_SHAPES = [(2, 256, 2, 64, 64), (2, 64, 4, 32, 32), (1, 48, 3, 32, 32),
                  (2, 33, 2, 16, 16), (1, 96, 5, 24, 64), (1, 64, 3, 20, 32)]


@pytest.mark.parametrize("B,S,H,K,chunk", WKV_BWD_SHAPES)
@pytest.mark.parametrize("dtype,wdtype", WKV_DTYPES)
@pytest.mark.parametrize("bf16_intra", [False, True])
@pytest.mark.parametrize("u_rows", [False, True])
def test_wkv_bwd_matches_plain(cuda, B, S, H, K, chunk, dtype, wdtype, bf16_intra, u_rows):
    """K12b against its plain version (autograd of ``wkv_plain``) on the same
    card tensors, with the final state's gradient too; u shared over the
    batch (du summed) or one row per batch entry."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.rwkv6_wkv import ops

    r, k, v, w, u = _wkv_inputs(B, S, H, K, dtype, wdtype, cuda, seed=5 * S + K)
    u = u[None].repeat(B, 1, 1) * torch.arange(1, B + 1, device=cuda)[:, None, None] \
        if u_rows else u[None]
    g = torch.Generator().manual_seed(S)
    dy = torch.randn((B, S, H, K), generator=g).to(cuda, dtype)
    dstate = torch.randn((B, H, K, K), generator=g).to(cuda)
    c = ops.cut_chunk(chunk, S)
    counts.reset()
    got = ops.wkv_bwd_cuda(r, k, v, w, u.contiguous(), dy, dstate, c, bf16_intra)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["rwkv6_wkv_bwd"] == 1 and counts.PLAIN_CALLS["rwkv6_wkv_bwd"] == 0
    want = ops.wkv_bwd_plain(r, k, v, w, u.contiguous(), dy, dstate, c, bf16_intra)
    exact = dtype == wdtype == torch.float32 and not bf16_intra
    _grads_close(got, want, exact)


@pytest.mark.parametrize("form", ["heads", "scan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_wkv_autograd_on_the_card(cuda, form, dtype):
    """Both entry points' gradients through autograd: K12 forward and K12b
    backward once each, no plain call, equal to the plain backward."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.rwkv6_wkv import ops

    B, S, H, K = 2, 128, 3, 32
    r, k, v, w, u = _wkv_inputs(B, S, H, K, dtype, torch.float32, cuda, seed=21)
    if form == "scan":   # the Pallas layout, a bonus row per (b, h)
        r, k, v, w = (t.permute(0, 2, 1, 3).reshape(B * H, S, K).contiguous()
                      for t in (r, k, v, w))
        u = u.repeat(B, 1)
    leaves = [t.clone().requires_grad_(True) for t in (r, k, v, w, u)]
    dy = torch.randn(r.shape, generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
    counts.reset()
    y = (ops.wkv_scan(*leaves, chunk=32) if form == "scan"
         else ops.wkv_heads(*leaves, chunk=32)[0])
    y.backward(dy)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["rwkv6_wkv"] == counts.LAUNCHES["rwkv6_wkv_bwd"] == 1
    assert sum(counts.PLAIN_CALLS.values()) == 0
    if form == "scan":
        want = ops.wkv_bwd_plain(*(t[:, :, None] for t in (r, k, v, w)), u[:, None],
                                 dy[:, :, None], None, 32, False)
        want = [t[:, :, 0] for t in want[:4]] + [want[4][:, 0]]
    else:
        want = ops.wkv_bwd_plain(r, k, v, w, u[None], dy, None, 32, True)
        want = list(want[:4]) + [want[4][0]]
    _grads_close([t.grad for t in leaves], want, dtype == torch.float32 and form == "scan")


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_rwkv6_on_the_card_matches_the_cpu(cuda, dtype):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, decode_step, forward
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.params import tree_map

    cfg = reduced(get_arch("rwkv6-7b"))
    rt = Runtime(param_dtype=dtype, compute_dtype=dtype)
    host = init_params(build_param_specs(cfg, rt), torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)   # the bonus and the mixes, zero by the init rules
    for blk in ("tmix", "cmix"):
        host["blocks"][blk]["mix"] = (torch.randn(host["blocks"][blk]["mix"].shape, generator=g)
                                      * 0.5).to(host["blocks"][blk]["mix"].dtype)
    host["blocks"]["tmix"]["u_bonus"] = torch.randn(host["blocks"]["tmix"]["u_bonus"].shape,
                                                    generator=g) * 0.5
    card = tree_map(lambda t: t.to(cuda), host)
    tokens = np.random.default_rng(0).integers(2, cfg.vocab, (2, 64))
    counts.reset()
    with torch.no_grad():
        got = forward(card, cfg, rt, tokens=torch.from_numpy(tokens).to(cuda))
        assert counts.LAUNCHES["rwkv6_wkv"] == cfg.n_layers
        assert counts.LAUNCHES["rmsnorm_fwd"] == 3 * cfg.n_layers + 1
        cache = init_cache(cfg, rt, 2, 8, device=cuda)
        lg, cache = decode_step(card, cfg, rt, cache, torch.from_numpy(tokens[:, :1]).to(cuda))
        lg, cache = decode_step(card, cfg, rt, cache, torch.from_numpy(tokens[:, 1:2]).to(cuda))
        assert counts.LAUNCHES["rmsnorm_fwd"] == 3 * (3 * cfg.n_layers + 1)
        assert counts.LAUNCHES["rwkv6_wkv"] == cfg.n_layers
        assert counts.PLAIN_CALLS["rwkv6_wkv"] == counts.PLAIN_CALLS["rmsnorm_fwd"] == 0
        want = forward(host, cfg, rt, tokens=torch.from_numpy(tokens))
        hc = init_cache(cfg, rt, 2, 8, device="cpu")
        hl, hc = decode_step(host, cfg, rt, hc, torch.from_numpy(tokens[:, :1]))
        hl, hc = decode_step(host, cfg, rt, hc, torch.from_numpy(tokens[:, 1:2]))
    # the forward carries bf16 rounding flips through four layers of state
    # (tests/test_torch_ssm.py); decode has none
    fwd_tol, dec_tol = (5e-3, 1e-5) if dtype == "float32" else (5e-2, 5e-2)
    for a, b, tol in ((got, want, fwd_tol), (lg, hl, dec_tol)):
        err = (torch.softmax(a.float().cpu(), -1) - torch.softmax(b.float(), -1)).abs().max()
        assert float(err) < tol, float(err)
    torch.testing.assert_close(cache["wkv"].cpu(), hc["wkv"],
                               atol=(1e-5 if dtype == "float32" else 5e-2)
                               * float(hc["wkv"].abs().max()), rtol=0)


# ---------------------------------------------------------------- K4 at 80

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal,window,offset", FLASH_MASKS)
def test_flash_fwd_at_head_dim_80_matches_plain(cuda, dtype, causal, window, offset):
    """zamba2-2.7b's shared attention has head dim 80; the backward kernels
    take it too."""
    from repro_torch.kernels.flash_attn import ops

    q, k, v = _flash_inputs(3, 128, 128, 1, 80, dtype, cuda, seed=8)
    q_offset = 0
    if offset:
        q = q[:, 64:].contiguous()
        q_offset = 64
    kw = dict(causal=causal, window=window, q_offset=q_offset, q_block=16, kv_block=32)
    o, lse = ops.flash_fwd(q, k, v, **kw)
    o_ref, lse_ref = ops.flash_fwd_plain(q, k, v, **kw)
    torch.cuda.synchronize()
    _close(o, o_ref, FLASH_TOL[dtype])
    _close(lse, lse_ref, FLASH_TOL[dtype])
    _check_bwd(q, k, v, kw)


# --------------------------------------------------------------------- K7

def _decode_inputs(B, S, Hkv, G, D, dtype, device, seed=0):
    """q, the cache at scale 1 and lengths 0, S // 3, S and S - 5 cycled over
    the rows."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    q = torch.randn((B, Hkv, G, D), generator=g).to(device, dtype)
    k, v = (torch.randn((B, S, Hkv, D), generator=g).to(device, dtype) for _ in range(2))
    lens = torch.tensor([(0, S // 3, S, S - 5)[i % 4] for i in range(B)], dtype=torch.int32,
                        device=device)
    return q, k, v, lens


def _decode_close(got, want):
    """float32: 2e-5 of o's largest magnitude; bfloat16: one bf16 step of it
    (both compute in float32 from the same inputs, then round o once)."""
    scale = float(want.float().abs().max())
    tol = 2.0 ** -7 if want.dtype == torch.bfloat16 else 2e-5
    torch.testing.assert_close(got.float(), want.float(), atol=tol * scale, rtol=0)


@pytest.mark.parametrize("S,kv_splits", [(96, 3), (128, 1), (256, 4), (4096, 4), (100, 2)])
@pytest.mark.parametrize("G,D", [(1, 64), (4, 80), (8, 128), (1, 80), (4, 128), (9, 128),
                                 (16, 64)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_matches_plain(cuda, S, kv_splits, G, D, dtype):
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_decode import ops, ref

    q, k, v, lens = _decode_inputs(4, S, 2, G, D, dtype, cuda, seed=S + G + D)
    splits, block = ops.split_plan(S, kv_splits, 32)
    before = counts.LAUNCHES["flash_decode"]
    o = ops.decode_attention(q, k, v, lens, kv_splits=kv_splits, kv_block=32)
    assert counts.LAUNCHES["flash_decode"] == before + 1
    want = ops.decode_plain(q, k, v, lens, splits, block)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    _decode_close(o, want)
    _decode_close(o, ref.decode_ref(q, k, v, lens))


def test_flash_decode_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels.flash_decode import ops

    with pytest.raises(ValueError, match="D = 192"):
        ops.decode_attention(*_decode_inputs(2, 64, 1, 1, 192, torch.float32, cuda))
    with pytest.raises(TypeError, match="not supported"):
        ops.decode_attention(*_decode_inputs(2, 64, 1, 1, 64, torch.float16, cuda))
    q, k, v, lens = _decode_inputs(3, 128, 2, 4, 64, torch.float32, cuda, seed=2)
    with pytest.raises(ValueError, match="contiguous"):
        ops.decode_cuda(q, k.transpose(1, 2).contiguous().transpose(1, 2), v, lens, 1)



def _decode_on(route, q, k, v, lens, splits=None):
    """K7 on a named route (None: the one ``decode_route`` picks), its launch
    and route counted, no plain call."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_decode import ops

    taken = route or ops.route_of(q, k, v)
    counts.reset()
    o = ops.decode_cuda(q, k, v, lens, splits, route=route)
    assert counts.ROUTE_LAUNCHES == {f"flash_decode/{taken}": 1}
    assert counts.LAUNCHES["flash_decode"] == 1 and counts.PLAIN_CALLS["flash_decode"] == 0
    return o


# both routes over a cache of 200 keys (not a multiple of the ring's 32-key
# tile, so the ring's last split is masked at S) with rows of length 0, 1, a
# partial tile, all of S and past S; G in 1, 4, 8, 9 and D in 64, 80, 128
@pytest.mark.parametrize("route,splits", [("ring", None), ("scalar", 4)])
@pytest.mark.parametrize("G,D", [(1, 64), (4, 80), (8, 128), (9, 128), (1, 80), (4, 128)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_decode_routes_match_plain(cuda, route, splits, G, D, dtype):
    from repro_torch.kernels.flash_decode import ops, ref

    B, S, Hkv = 5, 200, 2
    q, k, v, _ = _decode_inputs(B, S, Hkv, G, D, dtype, cuda, seed=G * D)
    lens = torch.tensor([0, 1, 17, S, S + 9], dtype=torch.int32, device=cuda)
    if route == "scalar":
        splits = 4 if S % 4 == 0 else 1
    o = _decode_on(route, q, k, v, lens, splits)
    torch.cuda.synchronize()
    assert o.dtype == dtype and o.shape == q.shape
    _decode_close(o, ops.decode_plain(q, k, v, lens, *ops.split_plan(S, 4, 32)))
    _decode_close(o, ref.decode_ref(q, k, v, lens))


# the smoke's long-context caches: 4 rows of 4096 keys of zamba2-2.7b (32 KV
# heads of 80, G = 1) and llama3-8b (8 of 128, G = 4), in bf16, one row empty
# and one a partial tile long
@pytest.mark.parametrize("Hkv,G,D", [(32, 1, 80), (8, 4, 128)], ids=["zamba2", "llama3"])
@pytest.mark.parametrize("route", ["ring", "scalar"])
def test_flash_decode_at_the_long_context_caches(cuda, Hkv, G, D, route):
    from repro_torch.kernels.flash_decode import ops

    B, S = 4, 4096
    q, k, v, _ = _decode_inputs(B, S, Hkv, G, D, torch.bfloat16, cuda, seed=Hkv + D)
    for lengths in ([S] * B, [S, 0, 1000, 7]):
        lens = torch.tensor(lengths, dtype=torch.int32, device=cuda)
        o = _decode_on(route, q, k, v, lens)
        _decode_close(o, ops.decode_plain(q, k, v, lens, *ops.split_plan(S, 4, 128)))


def test_flash_decode_takes_odd_heads_and_unaligned_views_on_the_scalar_route(cuda):
    from repro_torch.kernels.flash_decode import ops

    q, k, v, lens = _decode_inputs(4, 96, 2, 3, 20, torch.bfloat16, cuda, seed=4)
    assert ops.route_of(q, k, v) == "scalar"
    _decode_close(_decode_on(None, q, k, v, lens),
                  ops.decode_plain(q, k, v, lens, *ops.split_plan(96, 4, 32)))
    q, k, v, lens = _decode_inputs(4, 96, 2, 4, 64, torch.bfloat16, cuda, seed=5)
    buf = torch.empty(k.numel() + 1, dtype=k.dtype, device=cuda)
    ku = buf[1:].view(k.shape)
    ku.copy_(k)
    assert ops.route_of(q, ku, v) == "scalar"
    _decode_close(_decode_on(None, q, ku, v, lens),
                  ops.decode_plain(q, k, v, lens, *ops.split_plan(96, 4, 32)))
    with pytest.raises(ValueError, match="ring route needs"):
        ops.decode_cuda(q, ku, v, lens, route="ring")


def test_flash_decode_ring_route_refuses_a_split_count(cuda):
    """The ring route plans its own splits; a count is the scalar route's."""
    from repro_torch.kernels.flash_decode import ops

    q, k, v, lens = _decode_inputs(2, 96, 2, 4, 64, torch.bfloat16, cuda, seed=6)
    assert ops.route_of(q, k, v) == "ring"
    with pytest.raises(ValueError, match="plans its own splits"):
        ops.decode_cuda(q, k, v, lens, 3)
    with pytest.raises(ValueError, match="plans its own splits"):
        ops.decode_cuda(q, k, v, lens, 3, route="ring")


def test_flash_decode_ring_counters_reset_between_calls(cuda):
    """The in-launch merge's counters are back at 0 after each call, so calls
    that follow one another on a stream, of other shapes too, stay right."""
    from repro_torch.kernels.flash_decode import ops

    for B, S, Hkv, G, D in [(4, 4096, 8, 4, 128), (3, 300, 2, 9, 64), (4, 4096, 8, 4, 128)]:
        q, k, v, lens = _decode_inputs(B, S, Hkv, G, D, torch.bfloat16, cuda, seed=S + G)
        for _ in range(3):
            o = _decode_on("ring", q, k, v, lens)
        _decode_close(o, ops.decode_plain(q, k, v, lens, *ops.split_plan(S, 4, 128)))
    for ws, cnt in ops._SCRATCH.values():
        assert int(cnt.abs().sum()) == 0

def test_model_decode_flash_route_matches_plain_route(cuda):
    """A reduced llama3-8b decode step on the card: K7 (``flash``) against
    the reference's inline softmax (``xla``), in float32."""
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, decode_step, init_cache
    from repro_torch.models import init_params

    cfg = reduced(get_arch("llama3-8b"))
    rt = Runtime(param_dtype="float32", compute_dtype="float32")
    params = init_params(build_param_specs(cfg, rt), torch.Generator(device=cuda).manual_seed(0),
                         cuda)
    tokens = torch.from_numpy(np.random.default_rng(1).integers(2, cfg.vocab, (3, 12))).to(cuda)
    out = {}
    for impl in ("xla", "flash"):
        r = dataclasses.replace(rt, attn_impl=impl)
        cache = init_cache(cfg, r, 3, 16, device=cuda)
        counts.reset()
        for t in range(tokens.shape[1]):
            lg, cache = decode_step(params, cfg, r, cache, tokens[:, t:t + 1])
        out[impl] = lg
        assert counts.LAUNCHES["flash_decode"] == (12 * cfg.n_layers if impl == "flash" else 0)
    _decode_close(out["flash"], out["xla"])


# --------------------------------------------------------------------- K8

def _ssd_inputs(B, S, H, P, N, dtype, adtype, device, seed=0):
    """x, B, C at scale 0.5, the log decay -softplus(normal) with a spread of
    rates, as the reference's sweep draws them."""
    g = torch.Generator(device="cpu").manual_seed(seed)
    x, Bm, Cm = ((torch.randn(s, generator=g) * 0.5).to(device, dtype)
                 for s in ((B, S, H, P), (B, S, H, N), (B, S, H, N)))
    a = -torch.nn.functional.softplus(torch.randn((B, S, H), generator=g))
    return x, Bm, Cm, a.to(device, adtype)


def _ssd_close(y, py, st, pst, model):
    """The state within 2e-5 of its largest magnitude. y with float32
    products: within one bf16 step of its largest magnitude in bfloat16,
    2e-5 in float32. The model's function in bfloat16 rounds the scores and
    both parts of y, so ulp-level differences between the kernel's and the
    plain version's float32 cumsum and exp flip single roundings: at least
    95 % of y within one bf16 step and all within two."""
    sscale = float(pst.abs().max())
    torch.testing.assert_close(st, pst, atol=2e-5 * sscale, rtol=2e-5)
    scale = float(py.float().abs().max())
    bf16 = py.dtype == torch.bfloat16
    tol = 2.0 ** -7 if bf16 else 2e-5
    err = (y.float() - py.float()).abs() / scale
    if not (model and bf16):
        assert float(err.max()) <= tol, float(err.max())
        return
    assert float((err <= tol).float().mean()) >= 0.95
    assert float(err.max()) <= 2 * tol, float(err.max())


# (B, S, H, P, N, chunk): zamba2-2.7b's P = N = 64 at chunk 128 and 64; the
# reduced model's; chunks of 32; S that halves the chunk (96 -> 32, 200 ->
# 8); P and N below 64 and not powers of two; P and N no multiple of 16
# over chunks of 64; P = 20, N = 12, whose bf16 rows are no 16-byte
# multiple (element loads); one chunk of 100 rows (S = 100)
SSD_SHAPES = [(2, 512, 3, 64, 64, 128), (1, 256, 4, 64, 64, 64), (2, 64, 8, 32, 16, 32),
              (1, 96, 2, 32, 16, 64), (2, 200, 2, 24, 40, 128), (1, 33, 3, 64, 64, 128),
              (2, 128, 3, 24, 40, 64), (1, 64, 2, 20, 12, 32), (1, 100, 2, 32, 16, 128)]
SSD_DTYPES = [(torch.float32, torch.float32), (torch.bfloat16, torch.float32),
              (torch.bfloat16, torch.bfloat16)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_SHAPES)
@pytest.mark.parametrize("dtype,adtype", SSD_DTYPES)
@pytest.mark.parametrize("model", [False, True])
@pytest.mark.parametrize("route", [None, "chunked", "serial"])
def test_ssd_matches_plain(cuda, B, S, H, P, N, chunk, dtype, adtype, model, route):
    """Each route, and the one ``ssd_route`` plans (None), against the plain
    version; the chunked route refuses a chunk that is no multiple of 16."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.mamba2_ssd import ops

    x, Bm, Cm, a = _ssd_inputs(B, S, H, P, N, dtype, adtype, cuda, seed=S + P + N)
    c = ops.cut_chunk(chunk, S)
    if route == "chunked" and ops.ssd_route(S, c, P, N) != "chunked":
        with pytest.raises(ValueError, match="chunked route takes"):
            ops.ssd_cuda(x, Bm, Cm, a.float(), c, model, route=route)
        return
    counts.reset()
    if route is None:
        y, st = ops._ssd(x, Bm, Cm, a, chunk, model)
    else:
        y, st = ops.ssd_cuda(x, Bm, Cm, a.float(), c, model, route=route)
    py, pst = ops.ssd_plain(x, Bm, Cm, a.float(), c, model)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["mamba2_ssd"] == 1
    assert counts.ROUTE_LAUNCHES == {f"mamba2_ssd/{route or ops.ssd_route(S, c, P, N)}": 1}
    assert y.dtype == dtype and st.shape == (B, H, P, N)
    assert bool(torch.isfinite(y.float()).all())
    _ssd_close(y, py, st, pst, model)


@pytest.mark.parametrize("B,S,H,P,N,chunk", [s for s in SSD_SHAPES if s[1] % 32 == 0])
@pytest.mark.parametrize("dtype,adtype", SSD_DTYPES)
@pytest.mark.parametrize("model", [False, True])
def test_ssd_chunked_state_is_the_serial_state(cuda, B, S, H, P, N, chunk, dtype, adtype, model):
    """The chunked route sums each chunk's increment in the serial route's
    order and passes the state with its multiply and add: the final states
    are equal bit for bit."""
    from repro_torch.kernels.mamba2_ssd import ops

    x, Bm, Cm, a = _ssd_inputs(B, S, H, P, N, dtype, adtype, cuda, seed=2 * S + P + N)
    c = ops.cut_chunk(chunk, S)
    assert ops.ssd_route(S, c, P, N) == "chunked"
    _, st = ops.ssd_cuda(x, Bm, Cm, a.float(), c, model, route="chunked")
    _, st_serial = ops.ssd_cuda(x, Bm, Cm, a.float(), c, model, route="serial")
    torch.cuda.synchronize()
    assert torch.equal(st, st_serial), float((st - st_serial).abs().max())


def test_ssd_strided_views_and_pallas_layout_on_the_card(cuda):
    """B and C as views of one wider row, as the model splits them; and
    ``ssd_fwd`` in the Pallas layout against the sequential oracle."""
    from repro_torch.kernels.mamba2_ssd import ops, ref

    B, S, H, P, N = 2, 256, 4, 64, 64
    x, Bm, Cm, a = _ssd_inputs(B, S, H, P, N, torch.bfloat16, torch.float32, cuda, seed=3)
    wide = torch.cat([x.reshape(B, S, H * P), Bm.reshape(B, S, H * N), Cm.reshape(B, S, H * N)],
                     -1)
    Bv = wide[..., H * P:H * (P + N)].reshape(B, S, H, N)
    Cv = wide[..., H * (P + N):].reshape(B, S, H, N)
    got = ops.ssd_heads(x, Bv, Cv, a, chunk=128)
    want = ops.ssd_heads(x, Bm, Cm, a, chunk=128)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    rows = [t[:, :, 0].contiguous().float() for t in (x, Bm, Cm)]
    y, st = ops.ssd_fwd(*rows, a[:, :, 0].contiguous(), chunk=64)
    yo, so = ref.ssd_ref(*(t[:, :, None] for t in rows), a[:, :, :1].contiguous())
    torch.cuda.synchronize()
    _ssd_close(y, yo[:, :, 0], st, so[:, 0], False)


def test_ssd_refuses_what_it_does_not_take(cuda):
    from repro_torch.kernels import counts
    from repro_torch.kernels.mamba2_ssd import ops

    x, Bm, Cm, a = _ssd_inputs(1, 64, 2, 32, 16, torch.float32, torch.float32, cuda)
    with pytest.raises(ValueError, match="chunk 256 > 128"):
        ops.ssd_heads(*_ssd_inputs(1, 256, 1, 8, 8, torch.float32, torch.float32, cuda),
                      chunk=256)
    with pytest.raises(ValueError, match="P = 96"):
        ops.ssd_heads(*_ssd_inputs(1, 8, 1, 96, 8, torch.float32, torch.float32, cuda), chunk=8)
    with pytest.raises(TypeError, match="not supported"):
        ops.ssd_cuda(x.half(), Bm.half(), Cm.half(), a, 32, True)
    with pytest.raises(ValueError, match="contiguous"):
        ops.ssd_cuda(x, Bm.transpose(2, 3).contiguous().transpose(2, 3), Cm, a, 32, True)
    # an input that needs a gradient gets one, through K8b
    counts.reset()
    x.requires_grad_(True)
    ops.ssd_heads(x, Bm, Cm, a, chunk=32)[0].sum().backward()
    torch.cuda.synchronize()
    assert counts.LAUNCHES["mamba2_ssd_bwd"] == 1 and x.grad is not None
    assert bool(torch.isfinite(x.grad).all())


# (B, S, H, P, N, chunk): zamba2-2.7b's P = N = 64 at chunk 128 over two
# chunks and at 64; chunks of 32; S that halves the chunk (200 -> 8, 33 ->
# 1); P and N below 64 and not powers of two; one chunk of 100 rows
SSD_BWD_SHAPES = [(2, 256, 2, 64, 64, 128), (1, 128, 3, 64, 64, 64), (2, 64, 4, 32, 16, 32),
                  (2, 200, 2, 24, 40, 128), (1, 33, 2, 64, 64, 128), (1, 64, 2, 20, 12, 32),
                  (1, 100, 2, 32, 16, 128)]


@pytest.mark.parametrize("B,S,H,P,N,chunk", SSD_BWD_SHAPES)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("model", [False, True])
def test_ssd_bwd_matches_plain(cuda, B, S, H, P, N, chunk, dtype, model):
    """K8b against its plain version (autograd of ``ssd_plain``) on the same
    card tensors, with the final state's gradient too, B and C read as
    views of one wider row, as the model passes them."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.mamba2_ssd import ops

    x, Bm, Cm, a = _ssd_inputs(B, S, H, P, N, dtype, torch.float32, cuda, seed=S + P)
    wide = torch.cat([x.reshape(B, S, H * P), Bm.reshape(B, S, H * N), Cm.reshape(B, S, H * N)],
                     -1)
    Bv = wide[..., H * P:H * (P + N)].reshape(B, S, H, N)
    Cv = wide[..., H * (P + N):].reshape(B, S, H, N)
    g = torch.Generator().manual_seed(S)
    dy = torch.randn((B, S, H, P), generator=g).to(cuda, dtype)
    dstate = torch.randn((B, H, P, N), generator=g).to(cuda)
    c = ops.cut_chunk(chunk, S)
    counts.reset()
    got = ops.ssd_bwd_cuda(x, Bv, Cv, a, dy, dstate, c, model)
    torch.cuda.synchronize()
    assert counts.LAUNCHES["mamba2_ssd_bwd"] == 1 and counts.PLAIN_CALLS["mamba2_ssd_bwd"] == 0
    want = ops.ssd_bwd_plain(x, Bm, Cm, a, dy, dstate, c, model)
    _grads_close(got, want, dtype == torch.float32)


@pytest.mark.parametrize("form", ["heads", "scan"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ssd_autograd_on_the_card(cuda, form, dtype):
    """Both entry points' gradients through autograd: K8 forward and K8b
    backward once each, no plain call, equal to the plain backward; in the
    model layout B and C are views of one projection, whose gradient takes
    dB and dC at their columns."""
    from repro_torch.kernels import counts
    from repro_torch.kernels.mamba2_ssd import ops

    B, S, H, P, N = 2, 256, 3, 32, 16
    x, Bm, Cm, a = _ssd_inputs(B, S, H, P, N, dtype, torch.float32, cuda, seed=4)
    dy = torch.randn((B, S, H, P), generator=torch.Generator().manual_seed(2)).to(cuda, dtype)
    counts.reset()
    if form == "scan":
        rows = [t.permute(0, 2, 1, 3).reshape(B * H, S, -1).contiguous() for t in (x, Bm, Cm)]
        rows.append(a.permute(0, 2, 1).reshape(B * H, S).contiguous())
        leaves = [t.clone().requires_grad_(True) for t in rows]
        dyr = dy.permute(0, 2, 1, 3).reshape(B * H, S, P).contiguous()
        ops.ssd_scan(*leaves, chunk=64).backward(dyr)
        want = ops.ssd_bwd_plain(*(t[:, :, None] for t in rows), dyr[:, :, None], None, 64,
                                 False)
        want = [t[:, :, 0] for t in want]
        got = [t.grad for t in leaves]
    else:
        wide = torch.cat([Bm.reshape(B, S, H * N), Cm.reshape(B, S, H * N)], -1)
        wide.requires_grad_(True)
        xl, al = x.clone().requires_grad_(True), a.clone().requires_grad_(True)
        Bv = wide[..., :H * N].reshape(B, S, H, N)
        Cv = wide[..., H * N:].reshape(B, S, H, N)
        ops.ssd_heads(xl, Bv, Cv, al, chunk=128)[0].backward(dy)
        want = ops.ssd_bwd_plain(x, Bm, Cm, a, dy, None, 128, True)
        got = [xl.grad, wide.grad[..., :H * N].reshape(B, S, H, N),
               wide.grad[..., H * N:].reshape(B, S, H, N), al.grad]
    torch.cuda.synchronize()
    assert counts.LAUNCHES["mamba2_ssd"] == counts.LAUNCHES["mamba2_ssd_bwd"] == 1
    assert sum(counts.PLAIN_CALLS.values()) == 0
    _grads_close([t.contiguous() for t in got], want, dtype == torch.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_reduced_zamba2_on_the_card_matches_the_cpu(cuda, dtype):
    from repro_torch.configs import get_arch, reduced
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, decode_step, forward
    from repro_torch.models import init_cache, init_params
    from repro_torch.models.params import tree_map

    cfg = reduced(get_arch("zamba2-2.7b"))
    rt = Runtime(param_dtype=dtype, compute_dtype=dtype, attn_impl="flash", q_block=32,
                 kv_block=32)
    host = init_params(build_param_specs(cfg, rt), torch.Generator().manual_seed(0), "cpu")
    g = torch.Generator().manual_seed(1)   # the rates, skip and step bias, zero by the init rules
    for name in ("A_log", "D", "dt_bias"):
        leaf = host["blocks"]["mamba"][name]
        host["blocks"]["mamba"][name] = torch.randn(leaf.shape, generator=g) * 0.5
    card = tree_map(lambda t: t.to(cuda), host)
    tokens = np.random.default_rng(0).integers(2, cfg.vocab, (2, 64))
    L, groups = cfg.n_layers, cfg.n_layers // cfg.attn_every
    counts.reset()
    with torch.no_grad():
        got = forward(card, cfg, rt, tokens=torch.from_numpy(tokens).to(cuda))
        assert counts.LAUNCHES["mamba2_ssd"] == L
        assert counts.LAUNCHES["flash_attn_fwd"] == groups
        assert counts.LAUNCHES["rmsnorm_fwd"] == 2 * L + 2 * groups + 1
        cache = init_cache(cfg, rt, 2, 8, device=cuda)
        for t in range(2):
            lg, cache = decode_step(card, cfg, rt, cache, torch.from_numpy(tokens[:, t:t + 1])
                                    .to(cuda))
        assert counts.LAUNCHES["flash_decode"] == 2 * groups
        assert counts.LAUNCHES["mamba2_ssd"] == L
        assert sum(counts.PLAIN_CALLS.values()) == 0
        want = forward(host, cfg, rt, tokens=torch.from_numpy(tokens))
        hc = init_cache(cfg, rt, 2, 8, device="cpu")
        for t in range(2):
            hl, hc = decode_step(host, cfg, rt, hc, torch.from_numpy(tokens[:, t:t + 1]))
    tol = 1e-5 if dtype == "float32" else 5e-2
    for a, b in ((got, want), (lg, hl)):
        err = (torch.softmax(a.float().cpu(), -1) - torch.softmax(b.float(), -1)).abs().max()
        assert float(err) < tol, float(err)
    for key in ("ssm", "conv", "attn_k"):
        torch.testing.assert_close(cache[key].cpu().float(), hc[key].float(),
                                   atol=tol * float(hc[key].float().abs().max()), rtol=0)


# ------------------------------------------- the fused propose step (Q1, Q2)


_HISTORIES: dict = {}


def _spark_plane(device, n_sources=12):
    """A plane of forests fitted to simulated Spark histories over the
    tuner's 60-knob space (12 sources x 10 trees, the fused step's scale),
    and the space. The histories are drawn once a process."""
    from repro_torch.core import make_forest
    from repro_torch.core.surrogate import ForestPlane
    from repro_torch.sparksim import SparkWorkload, all_task_specs, generate_history

    space = SparkWorkload("tpch", 100, "A").space
    forests = []
    for i, spec in enumerate(all_task_specs()[:n_sources]):
        if i not in _HISTORIES:
            obs = generate_history(spec.workload(), n_obs=50, seed=i, device=device).successful()
            _HISTORIES[i] = (space.encode_many([o.config for o in obs]),
                             np.array([o.performance for o in obs]))
        forests.append(make_forest(seed=i, device=device).fit(*_HISTORIES[i]))
    return space, forests, ForestPlane([f.pack() for f in forests])


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4097, 131072])
def test_qs_descent_matches_plain(cuda, n):
    from repro_torch.core.propose import _PlaneEntry
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import ops, propose

    space, _, plane = _spark_plane(cuda)
    qs = _PlaneEntry(plane, space.dim).qs()[0]
    X = space.sample(np.random.default_rng(n), n).unit_tensor(cuda)
    T = qs.n_trees
    counts.reset()
    got = propose.qs_leaf_stats_cuda(X, qs, T + 5)
    assert counts.LAUNCHES["qs_descent"] == 1
    want = propose.qs_leaf_stats_plain(X, qs)
    k1 = ops.forest_eval_cuda(plane.feat, plane.thr, plane.child, plane.mean, plane.var,
                              plane.roots, X, plane.depth, plane.node_table())
    torch.cuda.synchronize()
    for g, w, k in zip(got, want, k1):
        assert torch.equal(_bits(g[:T]), _bits(w)) and torch.equal(_bits(w), _bits(k))


def test_qs_descent_two_words_and_root_leaves(cuda):
    from repro_torch.core.propose import _PlaneEntry
    from repro_torch.core.surrogate import ForestPlane, make_forest
    from repro_torch.kernels.forest_eval import propose

    rng = np.random.default_rng(1)
    X = rng.random((220, 5))
    forests = [make_forest(seed=0, device=cuda).fit(X, rng.normal(size=220)),
               make_forest(seed=1, device=cuda).fit(X, np.full(220, 2.0))]
    qs = _PlaneEntry(ForestPlane([f.pack() for f in forests]), 5).qs()[0]
    assert qs.n_words == 2
    pool = torch.from_numpy(rng.random((3000, 5))).to(cuda)
    got = propose.qs_leaf_stats_cuda(pool, qs)
    want = propose.qs_leaf_stats_plain(pool, qs)
    torch.cuda.synchronize()
    assert all(torch.equal(_bits(g), _bits(w)) for g, w in zip(got, want))


@pytest.mark.parametrize("n", [256, 131072])
def test_combine_ei_matches_plain(cuda, n):
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import ops, propose

    space, forests, plane = _spark_plane(cuda)
    X = space.sample(np.random.default_rng(n), n).unit_tensor(cuda)
    m, v = ops.forest_eval_cuda(plane.feat, plane.thr, plane.child, plane.mean, plane.var,
                                plane.roots, X, plane.depth, plane.node_table())
    S = len(forests)
    ystats = torch.zeros((3, S + 3), dtype=torch.float64, device=cuda)
    ystats[:, :S] = torch.stack([plane.y_means, plane.y_stds, plane.y_std_sqs])
    inc = torch.zeros(S + 3, dtype=torch.float64, device=cuda)
    inc[:S] = torch.tensor([float(f.y_.min()) for f in forests], dtype=torch.float64)
    meta = torch.tensor([S, 10, n - 7], dtype=torch.int32, device=cuda)
    counts.reset()
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = propose.combine_ei_cuda(m, v, ystats, inc, meta)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert counts.LAUNCHES["combine_ei"] == 1
    want = propose.combine_ei_plain(m, v, ystats, inc, meta)
    host = propose.combine_ei_plain(m.cpu(), v.cpu(), ystats.cpu(), inc.cpu(), meta.cpu())
    torch.cuda.synchronize()
    assert torch.equal(_bits(got), _bits(want)) and torch.equal(_bits(got).cpu(), _bits(host))
    assert bool((got[:S, : n - 7] >= 0).all()) and bool((got[:S, n - 7:] == -1).all())


@pytest.mark.parametrize("descent", ["forest", "qs"])
def test_propose_graph_replay_matches_the_eager_step(cuda, descent):
    """Host-pool calls through the engine's graphs give the CPU engine's
    indices (and the staged path's) at several pool sizes and planes, with
    no host sync before the result's copy; each replay adds the captured
    launches to the counts."""
    from repro_torch.core import ProposeEngine, aggregate_ranks, score_sources
    from repro_torch.kernels import counts

    space, card, _ = _spark_plane(cuda, 6)
    _, host, _ = _spark_plane("cpu", 6)
    eng, ref = ProposeEngine(space, seed=0), ProposeEngine(space, seed=0)
    eng.check_sync = True
    rng = np.random.default_rng(0)
    for i, (n_pool, S) in enumerate([(200, 6), (256, 4), (3000, 6), (257, 5), (180, 6)]):
        X = space.sample(rng, n_pool).unit()
        incs, ws = list(rng.random(S)), list(rng.random(S) + 0.1)
        counts.reset()
        got = eng.score_topk(card[:S], X, incs, ws, 9, descent=descent)
        assert counts.LAUNCHES["combine_ei"] >= 1 and counts.LAUNCHES["radix_rank"] >= 2
        want = ref.score_topk(host[:S], X, incs, ws, 9, descent=descent)
        staged = np.argsort(aggregate_ranks(score_sources(host[:S], X, incs), ws).numpy(),
                            kind="stable")[:9]
        assert np.array_equal(got, want) and np.array_equal(got, staged), i
    stats = eng.graph_stats()
    assert stats["graphs"] == 3 and stats["replays"] == 5 and stats["captures"] == 3
    counts.reset()
    eng.score_topk(card[:4], X, incs[:4], ws[:4], 9, descent=descent)
    slot = eng.graphs[("host", 256, descent)]
    assert counts.LAUNCHES == {**dict.fromkeys(counts.KERNELS, 0), **slot.launches}


def test_propose_device_pool_graph_draws_fresh_pools(cuda):
    from repro_torch.core import ProposeEngine

    space, card, _ = _spark_plane(cuda, 3)
    a, b = ProposeEngine(space, seed=0, pool_size=4096), ProposeEngine(space, seed=0,
                                                                        pool_size=4096)
    outs_a = [a.propose(card, [1.0, 2.0, 3.0], [0.5, 0.3, 0.2], 5) for _ in range(2)]
    outs_b = [b.propose(card, [1.0, 2.0, 3.0], [0.5, 0.3, 0.2], 5) for _ in range(2)]
    for (ia, ua, ga), (ib, ub, gb) in zip(outs_a, outs_b):
        assert np.array_equal(ua, ub) and np.array_equal(ia, ib)
        assert ua.shape == (128, space.dim) and np.all((ua >= 0) & (ua <= 1))
        assert np.all(np.isfinite(ga)) and np.all(np.diff(ga) >= 0)
    assert not np.array_equal(outs_a[0][1], outs_a[1][1])
    assert a.graph_stats() == {"graphs": 1, "captures": 1, "replays": 2}
    steps = a.propose(card, [1.0, 2.0, 3.0], [0.5, 0.3, 0.2], 5, steps=3)
    assert steps[1].shape == (3, 128, space.dim) and not np.array_equal(steps[1][0],
                                                                          steps[1][1])


def _baseline_run(name, device):
    """One baseline tuner for 8 virtual hours on a fresh knowledge base of
    {tpch-600-B, tpch-100-B} x 20, built on ``device``: its observation
    stream, trajectory and launch counts."""
    from repro_torch import baselines
    from repro_torch.core import KnowledgeBase
    from repro_torch.kernels import counts
    from repro_torch.sparksim import SparkWorkload, TaskSpec, generate_history
    from repro_torch.tuneapi import Budget

    kb = KnowledgeBase()
    for i, spec in enumerate([TaskSpec("tpch", 600, "B"), TaskSpec("tpch", 100, "B")]):
        kb.add_task(generate_history(spec.workload(), n_obs=20, seed=i, device=device),
                    persist=False)
    tuner = getattr(baselines, name)(SparkWorkload("tpch", 100, "A"), kb=kb, seed=0,
                                     device=device)
    counts.reset()
    res = tuner.run(Budget(8 * 3600.0))
    snap = counts.snapshot()
    stream = [(o.performance, o.fidelity, o.failed, tuple(sorted(o.config.items())))
              for o in tuner.obs]
    traj = [(p.time, p.best, tuple(sorted(p.config.items()))) for p in res.trajectory]
    return stream, traj, snap


@pytest.mark.parametrize("name,kernels", [("VanillaBO", ("forest_eval",)),
                                          ("Rover", ("forest_eval", "radix_rank"))])
def test_baseline_on_the_card_equals_its_cpu_run(cuda, name, kernels):
    card = _baseline_run(name, cuda)
    host = _baseline_run(name, "cpu")
    assert card[0] == host[0] and len(card[0]) >= 8
    assert card[1] == host[1]
    assert all(card[2]["launches"][k] > 0 for k in kernels), card[2]
    assert not any(card[2]["plain_calls"].values()), card[2]
