#!/usr/bin/env python3
"""Host seconds of the tuner's ``surrogate_eval`` span on the forest's host
route, with and without the chain-delta pool scoring.

    PYTHONPATH=src python3 scripts/delta_span.py [--hours 8] [--turns 2]

Runs MFTune on the CPU (the host route computes in numpy wherever the
forests live) on TPC-H 100 GB, hardware A, from seed 0, with a knowledge
base of {tpch-600-B, tpch-100-B} x 20 observations drawn on the CPU and
``surrogate_backend="numpy"``: every generator surrogate scores its pool by
the host gather descent. Each turn runs it twice, once as it is (the pool's
mutation provenance reaches ``ForestPlane.predict``, which takes the
chain-delta plan) and once with the provenance dropped (the gather descent
alone), in turns (delta, plain, plain, delta, ...), and checks that the two
observation streams are identical. Prints, per run, the summed host seconds
and the count of ``surrogate_eval`` spans, the ``forest_plane/`` counters
and the run's wall seconds. These are seconds of the host CPU that runs
the script, not a card's.
"""

import argparse
import time

import repro_torch.core.generator as gen
from repro_torch import obs
from repro_torch.core import KnowledgeBase, MFTune, MFTuneOptions
from repro_torch.sparksim import SparkWorkload, TaskSpec, generate_history
from repro_torch.tuneapi import Budget


def run(hours: float, delta: bool) -> dict:
    kb = KnowledgeBase()
    for i, spec in enumerate([TaskSpec("tpch", 600, "B"), TaskSpec("tpch", 100, "B")]):
        kb.add_task(generate_history(spec.workload(), n_obs=20, seed=i, device="cpu"),
                    persist=False)
    score = gen.score_sources
    if not delta:
        gen.score_sources = lambda models, X, incs, delta=None: score(models, X, incs)
    try:
        wl = SparkWorkload("tpch", 100, "A")
        t0 = time.perf_counter()
        with obs.tracing(name="delta_span") as tr:
            MFTune(wl, kb, MFTuneOptions(seed=0, surrogate_backend="numpy"),
                   device="cpu").run(Budget(hours * 3600.0))
        wall = time.perf_counter() - t0
    finally:
        gen.score_sources = score
    spans = [ev["dur"] for ev in tr.events
             if ev.get("type") == "span" and ev["name"] == "surrogate_eval"]
    stream = [(o.performance, o.fidelity, tuple(sorted(o.config.items())))
              for o in kb.get(wl.task_id).observations]
    return {"surrogate_eval_s": sum(spans), "surrogate_eval_calls": len(spans),
            "counters": tr.metrics.counters_view("forest_plane/"), "wall_s": wall,
            "stream": stream}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--hours", type=float, default=8.0)
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args()
    runs = []
    for turn in range(args.turns):
        order = (True, False) if turn % 2 == 0 else (False, True)
        for delta in order:
            r = run(args.hours, delta)
            runs.append((delta, r))
            print(f"delta={delta} surrogate_eval_s={r['surrogate_eval_s']} "
                  f"calls={r['surrogate_eval_calls']} counters={r['counters']} "
                  f"wall_s={r['wall_s']} evaluations={len(r['stream'])}", flush=True)
    streams = {tuple(r["stream"]) for _, r in runs}
    if len(streams) != 1:
        raise SystemExit("the runs' observation streams differ")
    for delta in (True, False):
        s = [r["surrogate_eval_s"] for d, r in runs if d == delta]
        print(f"delta={delta}: surrogate_eval seconds by run {s}, mean {sum(s) / len(s)}")
    print("the observation streams are identical (host CPU seconds)")


if __name__ == "__main__":
    main()
