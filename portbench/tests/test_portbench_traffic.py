"""The traffic drawn from the seed: deterministic by seed, drawn from the
stated distributions, and the same set of sizes for every seed in another
order; the weights drawn from the seed by the configuration's rules."""

from collections import Counter

import numpy as np
import pytest
import torch

from portbench.harness import drive, env, manifest, weights

SEEDS = (0, 7, 2**31 + 11, 3000000011)


MIXES = sorted(p.stem for p in (env.BENCH / "traffic").glob("*.json"))


@pytest.mark.parametrize("mix", MIXES)
def test_lengths_come_in_shuffled_blocks_of_the_stated_counts(mix):
    tr = manifest.load_json(env.BENCH / "traffic" / f"{mix}.json")
    block = sum(tr["counts"])
    want = Counter(dict(zip(tr["lengths"], tr["counts"])))
    plans = []
    for seed in SEEDS:
        plan = drive.length_plan(tr, np.random.default_rng(weights.sub_seed(seed, "lengths")), 50)
        assert len(plan) == 50 * block
        for b in range(50):
            assert Counter(plan[b * block:(b + 1) * block]) == want
        again = drive.length_plan(tr, np.random.default_rng(weights.sub_seed(seed, "lengths")), 50)
        assert plan == again
        plans.append(plan)
    assert len({tuple(p) for p in plans}) == len(SEEDS)


def test_stated_probabilities_and_mean():
    tr = manifest.load_json(env.BENCH / "traffic" / "prefill_closed_b1.json")
    n = sum(tr["counts"])
    probs = [c / n for c in tr["counts"]]
    assert probs == pytest.approx([0.30, 0.25, 0.20, 0.15, 0.10])
    assert sum(L * c for L, c in zip(tr["lengths"], tr["counts"])) / n == pytest.approx(2252.8)


@pytest.mark.parametrize("mix", MIXES)
def test_a_batch_holds_whole_prompts(mix):
    tr = manifest.load_json(env.BENCH / "traffic" / f"{mix}.json")
    assert not tr["batch_tokens"] or all(tr["batch_tokens"] % L == 0 for L in tr["lengths"])


def test_sub_seeds_are_distinct_and_fit_a_generator():
    seen = set()
    for seed in SEEDS:
        for tag in ("weights", "tokens", "lengths", "check"):
            s = weights.sub_seed(seed, tag)
            assert 0 <= s < 2**63
            seen.add(s)
            torch.Generator().manual_seed(s)
    assert len(seen) == 4 * len(SEEDS)


def test_token_pool_is_the_seeds():
    class C:
        pass

    ctx = C()
    ctx.seed, ctx.device = 3000000011, torch.device("cpu")
    ctx.arch = C()
    ctx.arch.vocab = 32000
    ctx.generator = lambda tag: drive.Ctx.generator(ctx, tag)
    a = drive.token_pool(ctx, 4096)
    b = drive.token_pool(ctx, 4096)
    assert torch.equal(a, b) and int(a.min()) >= 0 and int(a.max()) < 32000
    ctx.seed += 1
    assert not torch.equal(a, drive.token_pool(ctx, 4096))


def _leaves(tree, path=()):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _leaves(tree[k], path + (k,))
    else:
        yield "/".join(path), tree


def test_weights_are_the_seeds_and_follow_the_rules(tiny_cell):
    from repro_torch.models import Runtime, build_param_specs
    from portbench.harness.cell import _arch

    c = tiny_cell("mixtral-prefill", "float32")
    c.config["init"] = {"embed": ["normal", 2.0], "wo": ["scaled", 256]}
    arch = _arch(c.config)
    specs = build_param_specs(arch, Runtime(**c.config["runtime"]))
    a = weights.draw(specs, 5, "cpu", c.config["init"])
    b = weights.draw(specs, 5, "cpu", c.config["init"])
    other = weights.draw(specs, 6, "cpu", c.config["init"])
    for (n, x), (_, y), (_, z) in zip(_leaves(a), _leaves(b), _leaves(other)):
        assert torch.equal(x, y), n
        if n.endswith(("ln1", "ln2", "final_ln")):
            assert torch.equal(x, torch.ones_like(x)), n
        else:
            assert not torch.equal(x, z), n
    A = dict(_leaves(a))
    # a rule of the configuration, and a scaled leaf at 1 / sqrt(fan_in)
    assert float(A["embed"].std()) == pytest.approx(2.0, rel=0.05)
    assert float(A["blocks/attn/wo"].std()) == pytest.approx(256 ** -0.5, rel=0.1)
    w_up = A["blocks/moe/w_up"]
    assert float(w_up.std()) == pytest.approx(w_up.shape[-2] ** -0.5, rel=0.1)
