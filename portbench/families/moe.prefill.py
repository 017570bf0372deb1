"""The least time of a MoE model's prefill requests: for each request of
B prompts of S tokens, the model's FLOPs over the kept assignments (or its
weight bytes, whichever bounds), each layer's K9 products over its kept
assignments and K4 over the pairs the mask keeps."""

from portbench.families.moe import model_flops, weight_bytes
from portbench.harness import work


def work_of(ctx, kept_calls) -> work.Work:
    """``kept_calls``: each MoE layer call's kept assignments per expert,
    in the window's order (the routing counter's)."""
    a = ctx.cfg["arch"]
    L = a["n_layers"]
    calls = iter(kept_calls)
    wk = work.Work()
    for B, S in ctx.records:
        wk.steps += 1
        wk.tokens += B * S
        kept = [next(calls) for _ in range(L)]
        wk.add("model", weight_bytes(a, work.experts_hit(kept)) + 2.0 * B * S * a["d_model"],
               bf16_ops=model_flops(a, B, S, sum(map(sum, kept))))
        for layer in kept:
            work.k9_layer(wk, "k9", a, layer)
            work.k4_call(wk, "k4", a, B, S, a.get("window"))
    return wk
