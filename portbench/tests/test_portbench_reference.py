"""The plain reference under portbench/reference against the port's CPU
path (its kernels' plain versions) at a tiny size in float32, where the
two compute the same function and differ by round-off alone."""

import pytest
import torch

from portbench.harness import weights
from portbench.harness.cell import _arch
from portbench.reference import moe
from portbench.reference.common import Numerics

TOL = 2e-4     # float32 on both sides, over a few layers


def _setup(tiny_cell, cell, window=None, seed=3):
    from repro_torch.models import Runtime, build_param_specs

    c = tiny_cell(cell, "float32", window=window)
    arch = _arch(c.config)
    rt = Runtime(**c.config["runtime"])
    specs = build_param_specs(arch, rt)
    return c, arch, rt, specs, weights.draw(specs, seed, "cpu", c.config["init"])


def _close(a, b, tol=TOL):
    scale = float(b.abs().max())
    assert float((a - b).abs().max()) <= tol * max(scale, 1.0)


@pytest.mark.parametrize("window", [None, 48])
def test_forward_matches_the_program(tiny_cell, window):
    from repro_torch.models import forward

    c, arch, rt, specs, params = _setup(tiny_cell, "mixtral-prefill", window)
    tokens = torch.randint(0, arch.vocab, (2, 64), generator=torch.Generator().manual_seed(1))
    with torch.no_grad():
        want = forward(params, arch, rt, tokens=tokens).float()
        hid = moe.forward_rows(params, c.config, list(tokens), Numerics())
    for b in range(2):
        got = torch.cat([lg for _, lg in moe.logits_at(params, c.config, hid[b], Numerics())])
        _close(got, want[b])


def test_moe_capacity_drops_the_later_assignments():
    cfg = {"arch": {"moe": {"n_experts": 2, "top_k": 1, "capacity_factor": 1.0}}}
    # 8 tokens, one expert: capacity max(floor(8 * 1 * 1 / 2), 4) = 4
    x = torch.ones(8, 4)
    lw = {"router": torch.tensor([[1.0, 0.0]] * 4), "w_gate": torch.ones(2, 4, 3),
          "w_up": torch.ones(2, 4, 3), "w_down": torch.ones(2, 3, 4)}
    out = moe.moe_ffn(Numerics(), x, lw, cfg, row_len=8)
    assert bool((out[:4] != 0).all()) and bool((out[4:] == 0).all())
    # one token a row: nothing dropped
    assert bool((moe.moe_ffn(Numerics(), x, lw, cfg, row_len=1) != 0).all())


@pytest.mark.parametrize("factor", [1.25, 8.0])
def test_routing_counter_counts_the_kept_assignments(tiny_cell, factor):
    from repro_torch.models import forward

    from portbench.families import moe as fam

    import dataclasses

    c, arch, rt, specs, params = _setup(tiny_cell, "mixtral-prefill")
    arch = dataclasses.replace(arch, moe=dataclasses.replace(arch.moe, capacity_factor=factor))
    S, k, E = 96, arch.moe.top_k, arch.moe.n_experts

    class Ctx:
        in_window = True
        cfg = c.config
        records = [(1, S)]

    tokens = torch.randint(0, arch.vocab, (1, S), generator=torch.Generator().manual_seed(5))
    with fam.instrument(Ctx) as counter, torch.no_grad():
        forward(params, arch, rt, tokens=tokens)
    kept = counter.per_call()
    assert len(kept) == arch.n_layers and all(len(layer) == E for layer in kept)
    cap = max(int(S * k * factor / E), 4)
    assert all(0 <= n <= cap for layer in kept for n in layer)
    if cap >= S:         # nothing can be dropped
        assert sum(map(sum, kept)) == S * k * arch.n_layers
    assert f"of {S * k * arch.n_layers};" in counter.report()
