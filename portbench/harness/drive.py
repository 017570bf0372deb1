"""What every traffic kind shares: the run's context, the window, and the
lengths and tokens drawn from the seed.

A traffic mix is a data file, ``traffic/<mix>.json``; its ``kind`` names
the module ``portbench/kinds/<kind>.py`` that drives the program's entry
with it and judges what the entry produced. Lengths come in blocks that
hold each length ``counts[i]`` times, every block shuffled by the seed, so
every seed sends the same sizes in another order. Tokens are drawn on the
device in set-up, from one pool. A window ends once ``seconds`` have passed
and the work then in flight has come back, so a rate is all the work and
all the time of the window.
"""

from __future__ import annotations

import contextlib
import gc
import statistics
from typing import Any, Dict, List

import numpy as np
import torch

from .trace import Spans
from .weights import sub_seed


class Ctx:
    """What a traffic kind needs: the program's handles, the run's settings and
    what the kind hands on (``served`` for the check, ``records`` of each
    step's shape for the per-layer work)."""

    def __init__(self, cell, arch, rt, params, seed: int, seconds: float, traced: bool, device):
        self.arch, self.rt, self.params = arch, rt, params
        self.cfg, self.traffic = cell.config, cell.traffic
        self.seed, self.seconds, self.traced, self.device = seed, seconds, traced, device
        self.served: Dict[str, Any] = {}
        self.records: List[tuple] = []
        self.e2e: Dict[str, float] = {}
        self.window_s = 0.0
        self.attempted = 0
        self.window = None          # the profiler of a traced window
        self.spans = Spans(traced)  # the benchmark's host spans in it
        self.window_start = 0.0     # the window's start on the wall clock
        self.in_window = False

    def sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def generator(self, tag: str) -> torch.Generator:
        return torch.Generator(device=self.device).manual_seed(sub_seed(self.seed, tag))

    def rng(self, tag: str) -> np.random.Generator:
        return np.random.default_rng(sub_seed(self.seed, tag))


def window(ctx: Ctx):
    """The profiler of a traced window, nothing otherwise; either way the
    objects of set-up are moved out of the collector's reach first, so
    that a collection in the window does not walk them."""
    from .trace import profiler

    gc.collect()
    gc.freeze()
    return profiler() if ctx.traced and ctx.device.type == "cuda" else contextlib.nullcontext()


def length_plan(tr: dict, rng: np.random.Generator, n_blocks: int) -> List[int]:
    """The length of each request: blocks holding each length ``counts[i]``
    times, each block in the seed's order."""
    block = np.repeat(np.asarray(tr["lengths"]), np.asarray(tr["counts"]))
    return [int(x) for _ in range(n_blocks) for x in rng.permutation(block)]


def token_pool(ctx: Ctx, n: int) -> torch.Tensor:
    return torch.randint(0, ctx.arch.vocab, (n,), generator=ctx.generator("tokens"),
                         device=ctx.device)


def p95(values: List[float]) -> float:
    """The 95th percentile (linear between order statistics, as
    ``statistics.quantiles(..., n=20, method="inclusive")``)."""
    if len(values) < 2:
        return float(values[0])
    return statistics.quantiles(values, n=20, method="inclusive")[18]
