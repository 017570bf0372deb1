"""The ``prefill`` kind: a closed loop of one client sending prompts.

A request is one prompt (``batch_tokens`` null) or ``batch_tokens /
length`` prompts of one length. ``make_prefill_step`` (``forward``) runs
over it and the greedy token of each prompt's last position is copied to
the host: the request's time to first token. The end-to-end metrics are
``prefill_tokens_per_s`` (every prompt token of the window's requests over
the window) and ``ttft_p95_ms`` (over every request of the window). The
window ends with the first whole block of lengths after ``seconds``, so
that every run's window holds the same sizes, whatever the seed's order: a
window cut inside a block would hold more short or more long prompts by
the seed, and the rate would follow.

The check keeps ``check_requests`` requests drawn from the seed among the
first two blocks, which every window finishes, the first of the longest
length among them. The reference runs over the same prompts; at every
position the gap is how far the reference's logit of the program's greedy
token lies below the reference's best, and ``gap_mean``, the mean, is
compared (the widest gap, ``logit_gap``, is printed beside it: where the
router's second and third experts nearly tie, the reference's own float32
path takes the other expert at a few positions, and there the gap is that
of another model).

Faults a prefill can have, planted under the timed path by
:func:`fault`: ``token_altered`` (the logits that give the greedy tokens
shifted by one vocabulary entry at every 8th position, where they are
produced) and ``half_batch`` (the first half of the prompts computed and
their logits handed out for the rest too).
"""

from __future__ import annotations

import contextlib
import time
from typing import List

import torch

from portbench.harness import check
from portbench.harness.drive import length_plan, p95, token_pool, window

FAULTS = ("token_altered", "half_batch")


def drive(ctx, step_mod) -> None:
    tr = ctx.traffic
    plan = length_plan(tr, ctx.rng("lengths"), 4096)
    pool = token_pool(ctx, int(tr["token_pool"]))
    block = sum(tr["counts"])

    def rows(S: int) -> int:
        return (tr["batch_tokens"] // S) if tr["batch_tokens"] else 1

    offset = [0]

    def request(S: int) -> torch.Tensor:
        n = rows(S) * S
        if offset[0] + n > pool.numel():
            offset[0] = 0
        t = pool[offset[0]:offset[0] + n].view(rows(S), S)
        offset[0] += n
        return t

    longest = max(tr["lengths"])
    sample = {plan.index(longest)}
    others = [i for i in range(2 * block) if i not in sample]
    sample |= set(int(i) for i in ctx.rng("check").choice(others, tr["check_requests"] - 1,
                                                          replace=False))

    step = step_mod.make_prefill_step(ctx.arch, ctx.rt)
    params = ctx.params
    with torch.no_grad():
        for S in sorted(set(tr["lengths"])):           # warm every shape once
            warm = step(params, {"tokens": pool[:rows(S) * S].view(rows(S), S)})
            warm[:, -1].argmax(-1).cpu()
            del warm
        ctx.sync()
        ttft: List[float] = []
        tokens_done = 0
        kept = {}
        i = 0
        with window(ctx) as prof:
            ctx.window_start = time.time()
            ctx.in_window = True
            t_start = time.perf_counter()
            while time.perf_counter() - t_start < ctx.seconds or i % block:
                S = plan[i]
                toks = request(S)
                with ctx.spans("request"):
                    t0 = time.perf_counter()
                    with ctx.spans("dispatch"):
                        logits = step(params, {"tokens": toks})
                        first = logits[:, -1].argmax(-1)
                    with ctx.spans("sync"):
                        first_host = first.cpu()
                    t1 = time.perf_counter()
                ttft.append(t1 - t0)
                tokens_done += toks.numel()
                ctx.records.append((toks.shape[0], S))
                if i in sample:
                    with ctx.spans("keep"):
                        kept[i] = (toks.cpu(), logits.argmax(-1).cpu(), first_host)
                del logits
                i += 1
            t_end = time.perf_counter()
            ctx.in_window = False
        ctx.window = prof
    ctx.window_s = t_end - t_start
    ctx.attempted = i
    ctx.e2e["prefill_tokens_per_s"] = tokens_done / ctx.window_s
    ctx.e2e["ttft_p95_ms"] = 1e3 * p95(ttft)
    ctx.served = {"sample": sorted(sample), "kept": kept}


def check_numbers(ctx, control: bool):
    """(the numbers compared, or None where a kept request never came; the
    control's, where ``control``)."""
    ref = check.reference(ctx.cfg)
    served = ctx.served
    if any(i not in served["kept"] for i in served["sample"]):
        return None, None
    got, got_c = [], []
    for i in served["sample"]:
        toks, greedy, first = served["kept"][i]
        if not torch.equal(greedy[:, -1], first):
            return {"gap_mean": float("inf")}, None
        rows = [r.to(ctx.device) for r in toks]
        hid = ref.forward_rows(ctx.params, ctx.cfg, rows, check.numerics(False))
        hid_c = ref.forward_rows(ctx.params, ctx.cfg, rows, check.numerics(True)) if control \
            else None
        for b, h in enumerate(hid):
            got.append(check.gaps(ref, ctx, h, None, greedy[b]))
            if control:
                got_c.append(check.gaps(ref, ctx, h, hid_c[b], None))
    return check.summary(got), (check.summary(got_c) if control else None)


@contextlib.contextmanager
def fault(name: str):
    """Plant the fault ``name`` under the timed path: ``make_prefill_step``
    of ``repro_torch.train.step``, which :func:`drive` looks up at run
    time, replaced by a broken one."""
    import repro_torch.train.step as step_mod

    made = step_mod.make_prefill_step

    if name == "token_altered":
        def make(cfg, rt):
            inner = made(cfg, rt)

            def step(params, batch):
                out = inner(params, batch)
                out[:, ::8] = out[:, ::8].roll(1, dims=-1)
                return out
            return step
    elif name == "half_batch":
        def make(cfg, rt):
            inner = made(cfg, rt)

            def step(params, batch):
                toks = batch["tokens"]
                half = max(toks.shape[0] // 2, 1)
                out = inner(params, {"tokens": toks[:half]})
                return out.repeat((toks.shape[0] + half - 1) // half, 1, 1)[:toks.shape[0]]
            return step
    else:
        raise ValueError(f"unknown fault {name!r}; known: {FAULTS}")
    step_mod.make_prefill_step = make
    try:
        yield
    finally:
        step_mod.make_prefill_step = made
