#!/usr/bin/env python3
"""Time the routes of K1 (forest descent) and K2 (radix rank) across shapes,
to set the routes' limits.

    PYTHONPATH=src python3 scripts/tuner_routes.py

Needs ``nvcc`` and an NVIDIA GPU. Every time is the kernels' device time a
call from a ``torch.profiler`` trace of 10 calls after a warm-up (the
smoke's ``traced_call_ms``), with an empty kernel's time beside them.

- K2: keys of S rows of N scores drawn on the card from seed 0 (a third of
  them 0, as EI's are), at S = 12 and 34 and N from 256 to 6144 and
  131072: the ``count``, ``onesweep`` and ``block`` routes (``count`` up
  to its limit), ``onesweep``'s histogram launch and its 8 passes apart,
  and ``torch.argsort`` with a scatter, the library yardstick. The least
  N at which ``onesweep`` beats ``count`` sets ``rank.COUNT_N``.
- K1: one forest and planes of 12 and 34 random forests (``make_forest``
  on 50 observations of 60 features, seeds 0..), over pools of 1, 64, 256
  and 131072 candidates drawn from seed 1 (the tuner's shapes and the
  fused propose step's): ``gather``, and ``tiled`` under plans that
  ask for one group of trees, 1, 2 and 4 blocks an SM
  (``ops._BLOCKS_PER_SM`` = 0, 1, 2, 4), and tiles of 32 rows only
  (``ops.TILE_ROWS``), each plan printed. Every output is held to the plain version.

Prints one line a measurement, the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.core.surrogate import ForestPlane, make_forest  # noqa: E402
from repro_torch.kernels.forest_eval import ops, rank  # noqa: E402


def rank_rows(dev) -> None:
    for S in (12, 34):
        for N in (256, 512, 1024, 1536, 2048, 3072, 4096, 6144, 131072):
            g = torch.Generator(device=dev).manual_seed(0)
            scores = torch.rand((S, N), generator=g, dtype=torch.float64, device=dev)
            scores[:, ::3] = 0.0
            keys = rank.monotone_keys(scores)
            want = rank.radix_rank_plain(keys)
            out = {}
            for route in rank.ROUTES:
                if route == "count" and N > rank.COUNT_LIMIT:
                    continue
                if not torch.equal(rank.radix_rank_cuda(keys, route=route), want):
                    smoke.fail(f"K2 {route} at {S} x {N} differs from its plain version")
                out[route] = smoke.traced_call_ms(lambda: rank.radix_rank_cuda(keys, route=route),
                                                  smoke.ROUTE_TAGS["radix_rank"][route])[0]
            for tag, n in smoke.ROUTE_TAGS["radix_rank"]["onesweep"]:
                out[f"onesweep:{tag}"] = smoke.traced_call_ms(
                    lambda: rank.radix_rank_cuda(keys, route="onesweep"), [(tag, n)])[0]
            out["argsort"] = smoke.traced_call_ms(smoke.rank_library(keys), [("", None)])[0]
            print(f"[k2] S={S} N={N} plan={rank.rank_route(S, N)} ms={out}", flush=True)


def forest_rows(dev) -> None:
    rng = np.random.default_rng(0)
    default, rows = ops._BLOCKS_PER_SM, ops.TILE_ROWS
    for n_sources, N in ((1, 1), (1, 64), (34, 256), (12, 131072)):
        forests = []
        for s in range(n_sources):
            X = rng.random((50, 60))
            y = np.sin(4 * X[:, s % 60]) + X[:, (s + 1) % 60] + 0.1 * rng.standard_normal(50)
            forests.append(make_forest(seed=s, device=dev).fit(X, y))
        plane = ForestPlane([f.pack() for f in forests])
        pool = torch.rand((N, 60), generator=torch.Generator(device=dev).manual_seed(1),
                          dtype=torch.float64, device=dev)
        args = (plane.feat, plane.thr, plane.child, plane.mean, plane.var, plane.roots, pool,
                plane.depth, plane.node_table())
        want = ops.forest_eval_plain(*args[:8])
        out = {}
        for per_sm in (None, 0, 1, 2, 4, "rows32"):
            route = "gather" if per_sm is None else "tiled"
            ops._BLOCKS_PER_SM = default if per_sm in (None, "rows32") else per_sm
            ops.TILE_ROWS = (32,) if per_sm == "rows32" else rows
            got = ops.forest_eval_cuda(*args, route=route)
            if not (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])):
                smoke.fail(f"K1 {route} at {n_sources} sources x {N} differs from plain")
            key = route if per_sm is None else f"tiled/{per_sm}"
            out[key] = smoke.traced_call_ms(lambda: ops.forest_eval_cuda(*args, route=route),
                                            smoke.ROUTE_TAGS["forest_eval"][route])[0]
            if per_sm is not None:
                print(f"[k1] plan {per_sm} a SM: "
                      f"{ops.forest_plan(len(plane.roots), N, 60, args[8], 132)}", flush=True)
        ops._BLOCKS_PER_SM, ops.TILE_ROWS = default, rows
        print(f"[k1] trees={len(plane.roots)} records={args[8].n_records} depth={plane.depth} "
              f"N={N} ms={out}", flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        smoke.fail("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {card.strip()}", flush=True)
    dev = torch.device("cuda")
    smoke.launch_floor_ms(dev)
    rank_rows(dev)
    forest_rows(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
