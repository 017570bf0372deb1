#!/usr/bin/env python3
"""The propose step against its pool size: staged against fused, graph
against eager, host pool against device pool.

    PYTHONPATH=src python3 scripts/propose_scaling.py [--kernels]

Needs ``nvcc`` and an NVIDIA GPU. The port's counterpart of
``benchmarks/bench_pool_scaling.py``: MFTune's combined surrogate at 12
sources of 10 trees, fitted to 50 simulated observations each of the first
12 tasks of the Spark grid, over the tuner's 60-knob space (TPC-H 100 GB,
hardware A), at pools of 256 to 131072 candidates, 16 candidates a call.
Each call draws a fresh pool, as a tuner iteration does:

- ``staged``: ``space.sample`` on the host, the unit encoding uploaded,
  ``score_sources`` (K1 and torch EI), ``aggregate_ranks`` (K2), a stable
  argsort on the host;
- ``host``: the same host pool through ``ProposeEngine.score_topk`` (one
  CUDA graph a bucket) and through the eager step (``propose_step`` on the
  uploaded pool, no graph); the selections must be the staged path's;
- ``device``: ``ProposeEngine.propose`` (the pool drawn inside the graph)
  and the eager step drawing the same way.

Each is timed by its host clock a call, ending in the copy of the result to
the host (the mean of 3 calls after a warm-up), and the graph calls' device
time a call by stage from a ``torch.profiler`` trace (descent, Q2, K2's
ranks, the rest in torch: the draw, the aggregate, the keys and the
scatter), with the draw alone traced beside them. At each size Q1's two
routes, each bit for bit with the plain version and K1, by trace in turns:
``per_tree`` against ``merged`` and against K1 ``tiled`` (first, new, new,
first); the smallest bucket from which ``per_tree`` beats K1 at every
larger bucket is the crossover that ``core.propose.QS_AUTO_MIN`` takes
(printed last; none where it wins nowhere). After the sweep the engine
must hold at most one graph a (mode, bucket, descent). ``--kernels`` runs
the Q1 and K1 sweep alone.

Prints one line a measurement, the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.core import ProposeEngine, aggregate_ranks, score_sources  # noqa: E402
from repro_torch.core.propose import _PlaneEntry  # noqa: E402
from repro_torch.kernels.forest_eval import ops  # noqa: E402
from repro_torch.kernels.forest_eval import propose as P  # noqa: E402
from repro_torch.sparksim import all_task_specs  # noqa: E402

POOLS = (256, 1024, 4096, 16384, 65536, 131072)
N_SOURCES = 12
K = 16
REPS = 3


def host_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(REPS):
        fn()
    return (time.perf_counter() - t0) / REPS * 1e3


def q1_routes(plane, qs, X0, dev, floor) -> bool:
    """Q1's routes at one pool, bit for bit with the plain version and K1,
    then by trace in turns: per_tree against merged and against K1
    ``tiled``. Returns whether per_tree beat K1."""
    from repro_torch.kernels.launch import n_sms

    N, D = X0.shape
    Xt = torch.from_numpy(X0).to(dev)
    nodes = plane.node_table()
    k1 = lambda: ops.forest_eval_cuda(plane.feat, plane.thr, plane.child, plane.mean,
                                      plane.var, plane.roots, Xt, plane.depth, nodes)
    tree = lambda: P.qs_leaf_stats_cuda(Xt, qs, route="per_tree")
    merged = lambda: P.qs_leaf_stats_cuda(Xt, qs, route="merged")
    want = P.qs_leaf_stats_plain(Xt, qs)
    bits = lambda t: t.view(torch.int64)
    for name, fn in (("per_tree", tree), ("merged", merged), ("K1", k1)):
        if not all(torch.equal(bits(g), bits(w)) for g, w in zip(fn(), want)):
            smoke.fail(f"Q1's {name} differs from the plain version at {N}")
    plan = P.qs_plan(qs, N, D, n_sms(dev))
    tags = [("qs_descent_tree_kernel", 1)]
    tm = smoke.traced_turns(merged, tree, [("qs_descent_kernel", 1)], tags)
    tk = smoke.traced_turns(k1, tree, [("forest_eval_tiled", 1)], tags)
    T = qs.n_trees
    bnd = smoke.bound(Xt.numel() * 8 + 2 * T * N * 8, 0)
    print(f"[scaling] N={N}: Q1 bit for bit with the plain version and K1 on both routes; "
          f"plan {tuple(plan)}; per_tree against merged in turns (merged, per_tree, per_tree, "
          f"merged) {tm[2]} ms (held {tm[3]}): merged {tm[0]}, per_tree {tm[1]}; against K1 "
          f"tiled (K1, per_tree, per_tree, K1) {tk[2]} ms (held {tk[3]}): K1 {tk[0]}, per_tree "
          f"{tk[1]}; bound {bnd[0]:.6f} ms ({bnd[1]}); launch floor {floor} ms", flush=True)
    return tk[0] is not None and tk[1] < tk[0]


def main() -> int:
    if not torch.cuda.is_available():
        smoke.fail("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {card.strip()}", flush=True)
    dev = torch.device("cuda")
    floor = smoke.launch_floor_ms(dev)
    kb = smoke.build_kb(all_task_specs()[:N_SOURCES], 50, dev)
    space, forests, plane = smoke.scale_plane(kb, dev, N_SOURCES)
    S, tps = len(forests), plane.uniform_tree_count
    incs = [float(f.y_.min()) for f in forests]
    ws = [float(w) for w in np.linspace(1.0, 0.1, S)]
    inc_t = torch.tensor(incs, dtype=torch.float64, device=dev)
    w_t = torch.tensor(ws, dtype=torch.float64, device=dev)
    entry = _PlaneEntry(plane, space.dim)
    qs = entry.qs()[0]
    sig, cols = space.plane().device_tables()
    cols = tuple(tuple(torch.from_numpy(np.asarray(a)).to(dev) for a in c) for c in cols)
    eng = ProposeEngine(space, seed=0)
    gen = torch.Generator(device=dev).manual_seed(1)
    rng = np.random.default_rng(0)
    kernels_only = "--kernels" in sys.argv[1:]
    wins = {}
    for N in POOLS:
        X0 = space.sample(np.random.default_rng(N), N).unit()
        wins[N] = q1_routes(plane, qs, X0, dev, floor)
        if kernels_only:
            continue
        staged0 = np.argsort(aggregate_ranks(score_sources(
            forests, torch.from_numpy(X0).to(dev), incs), ws).cpu().numpy(), kind="stable")[:K]
        for d in ("forest", "qs"):
            if not np.array_equal(eng.score_topk(forests, X0, incs, ws, K, descent=d), staged0):
                smoke.fail(f"the fused step at {N} ({d}) differs from the staged path")

        def staged():
            Xt = space.sample(rng, N).unit_tensor(dev)
            agg = aggregate_ranks(score_sources(forests, Xt, incs), ws).cpu().numpy()
            return np.argsort(agg, kind="stable")[:K]

        def host_graph(d):
            return eng.score_topk(forests, space.sample(rng, N).unit(), incs, ws, K, descent=d)

        def host_eager(d):
            Xt = space.sample(rng, N).unit_tensor(dev)
            return P.propose_step(None, None, entry.arena, entry.ystats, inc_t, w_t, n_pool=N,
                                  n_sources=S, tps=tps, k=K, descent=d, X=Xt,
                                  qs=qs if d == "qs" else None)[0].cpu()

        def device_graph(d):
            return eng.propose(forests, incs, ws, K, descent=d, pool_size=N)

        def device_eager(d):
            out = P.propose_step(gen, cols, entry.arena, entry.ystats, inc_t, w_t, n_pool=N,
                                 n_sources=S, tps=tps, k=K, sig=sig, descent=d,
                                 qs=qs if d == "qs" else None)
            return tuple(o.cpu() for o in out)

        row = {"staged": host_ms(staged)}
        for d in ("forest", "qs"):
            row[f"host_graph/{d}"] = host_ms(lambda: host_graph(d))
            row[f"host_eager/{d}"] = host_ms(lambda: host_eager(d))
            row[f"device_graph/{d}"] = host_ms(lambda: device_graph(d))
            row[f"device_eager/{d}"] = host_ms(lambda: device_eager(d))
        print(f"[scaling] N={N} host clock ms a call: {row}", flush=True)
        for d in ("forest", "qs"):
            print(f"[scaling] N={N} {d}: device ms a call by stage, host graph "
                  f"{smoke.step_profile(lambda: host_graph(d), REPS)}, device graph "
                  f"{smoke.step_profile(lambda: device_graph(d), REPS)}", flush=True)
        draw = smoke.traced_call_ms(lambda: P.draw_unit_pool(gen, sig, cols, N),
                                    [("", None)])[0]
        print(f"[scaling] N={N}: the draw alone {draw} ms (trace)", flush=True)
    cross = next((N for N in POOLS if all(wins[M] for M in POOLS if M >= N)), None)
    print(f"[scaling] Q1 per_tree beats K1 tiled at {[N for N in POOLS if wins[N]]}; the "
          f"crossover for QS_AUTO_MIN: {cross}", flush=True)
    if kernels_only:
        return 0
    stats = eng.graph_stats()
    print(f"[scaling] graphs {stats}, keys {sorted(eng.graphs)}", flush=True)
    if stats["graphs"] > 4 * len(POOLS):
        smoke.fail(f"{stats['graphs']} graphs for {len(POOLS)} buckets, two modes, two descents")
    return 0


if __name__ == "__main__":
    sys.exit(main())
