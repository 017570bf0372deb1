"""The MoE family's model arithmetic and its routing counter.

``model_flops`` follows the repository's ``tools/flops.py`` (2 FLOPs a
parameter a token uses) and adds what it leaves out: the experts by the
assignments kept under capacity, not by top-k, and attention's score and
value products over the (query, key) pairs that the mask keeps.
``weight_bytes`` counts the weights a step reads once. The routing counter
wraps the program's ``moe_route`` in a traced window and counts, on the
device, each expert's kept assignments in each MoE layer call.
"""

from __future__ import annotations

import contextlib
from typing import List, Optional

import torch

from portbench.harness.work import attn_params, head_dim, kept_pairs


def model_flops(a: dict, B: int, S: int, kept_total: Optional[int] = None) -> float:
    """Forward FLOPs of B rows of S tokens: 2 per parameter a token uses
    (the head for every position, the embedding gather not; the experts by
    ``kept_total`` assignments over the layers, all B S top_k where not
    given), plus the score and value products over the kept pairs."""
    d, V, L, m = a["d_model"], a["vocab"], a["n_layers"], a["moe"]
    tokens = B * S
    kept = kept_total if kept_total is not None else L * tokens * m["top_k"]
    pairs = B * kept_pairs(S, a.get("window"))
    return (2.0 * tokens * V * d
            + 2.0 * tokens * L * (attn_params(a) + d * m["n_experts"])
            + 2.0 * kept * 3 * d * m["d_ff_expert"]
            + 4.0 * a["n_heads"] * head_dim(a) * pairs * L)


def weight_bytes(a: dict, experts_hit: Optional[int] = None) -> float:
    """bf16 bytes of the weights a step reads once, the embedding table
    left out (a step gathers rows of it); of the experts, the
    ``experts_hit`` (summed over the layers; all by default) that some kept
    assignment reaches; the float32 router."""
    d, L, m = a["d_model"], a["n_layers"], a["moe"]
    hit = L * m["n_experts"] if experts_hit is None else experts_hit
    experts = 3 * hit * d * m["d_ff_expert"]
    return (2.0 * (L * (attn_params(a) + 2 * d) + experts + a["vocab"] * d)
            + 4.0 * L * d * m["n_experts"])


class RoutingCounter:
    """Kept assignments per expert of every MoE layer call in a traced
    window, counted on the device; nothing is copied until the window has
    closed."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.calls: List[torch.Tensor] = []

    def per_call(self) -> List[List[int]]:
        return torch.stack(self.calls).cpu().tolist() if self.calls else []

    def report(self) -> str:
        kept = self.per_call()
        a = self.ctx.cfg["arch"]
        E, k = a["moe"]["n_experts"], a["moe"]["top_k"]
        assigned = sum(B * S for B, S in self.ctx.records) * k * a["n_layers"]
        return (f"MoE assignments kept {sum(map(sum, kept))} of {assigned}; per expert, "
                f"summed over the window: {[sum(c[e] for c in kept) for e in range(E)]}")


@contextlib.contextmanager
def instrument(ctx):
    """The routing counter, with the program's ``moe_route`` wrapped while
    it is installed."""
    import repro_torch.models.moe as moe

    counter = RoutingCounter(ctx)
    orig = moe.moe_route

    def counted(router, x, cfg, rt):
        gates, idx, slot, cr = orig(router, x, cfg, rt)
        if ctx.in_window:
            flat = idx.reshape(idx.shape[0], -1)
            kept = (slot < cr)[..., None]
            counter.calls.append((torch.nn.functional.one_hot(flat, cfg.moe.n_experts) * kept)
                                 .sum((0, 1)))
        return gates, idx, slot, cr

    moe.moe_route = counted
    try:
        yield counter
    finally:
        moe.moe_route = orig
