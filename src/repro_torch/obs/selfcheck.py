"""End-to-end trace self-check of the port: ``python -m repro_torch.obs.selfcheck``.

Runs one small tracing-enabled ``MFTune.run()`` of the port against the
warm-history TPC-H recipe of the reference's self-check (a 12-observation
history of TPC-H 100 GB on hardware A, 8 virtual hours, seed 0), on the
CUDA card by default or on the host with ``--device cpu``, exports the
trace in both formats, and asserts the acceptance properties of the
observability plane:

  * every event validates against the port's ``trace_schema.json``;
  * the span stream covers every tuner stage: pool generation, surrogate
    fit/eval, propose, rung evaluation (MFO must activate), compression,
    and workload evaluation;
  * the Perfetto export is plain JSON (``json.load`` round-trips) and
    decodes back to schema-valid canonical events;
  * the run summary renders.

Exit code 0 = all checks passed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

REQUIRED_SPANS = {
    "pool_gen",
    "surrogate_fit",
    "surrogate_eval",
    "bo_recommend",
    "rung_eval",
    "space_compression",
    "workload_eval",
    "evaluate",
    "iteration",
}


def traced_run(device=None):
    """One warm-history MFTune run under a fresh tracer, on ``device``."""
    from .. import obs
    from ..core import MFTune, MFTuneOptions
    from ..core.knowledge import KnowledgeBase
    from ..sparksim import SparkWorkload, TaskSpec, generate_history
    from ..tuneapi import Budget

    kb = KnowledgeBase()
    kb.add_task(
        generate_history(
            TaskSpec("tpch", 100, "A").workload(), n_obs=12, n_init=5, seed=3, device=device
        ),
        persist=False,
    )
    wl = SparkWorkload("tpch", 100, "A")
    tracer = obs.Tracer("selfcheck")
    with obs.tracing(tracer):
        res = MFTune(wl, kb, MFTuneOptions(seed=0), device=device).run(Budget(8 * 3600.0))
    return res, tracer


def main(argv=None) -> int:
    from .. import obs

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None,
                    help="torch device of the run (default: the CUDA card; 'cpu' for the host)")
    args = ap.parse_args(argv)

    res, tracer = traced_run(args.device)
    events = obs.trace_events(tracer)
    failures = []

    violations = obs.validate_events(events)
    if violations:
        failures.append(f"schema: {len(violations)} violations, e.g. {violations[:3]}")

    seen = {e["name"] for e in events if e["type"] == "span"}
    missing = REQUIRED_SPANS - seen
    if missing:
        failures.append(f"span coverage: missing {sorted(missing)}")
    if res.mfo_activation_time is None:
        failures.append("MFO never activated")

    if not any(e["type"] == "counter" for e in events):
        failures.append("no counter events exported")
    if res.overheads != res.metrics["counters"] and not res.overheads:
        failures.append("TuningResult.overheads view is empty")

    with tempfile.TemporaryDirectory() as td:
        pf = os.path.join(td, "trace.json")
        jl = os.path.join(td, "trace.jsonl")
        obs.export_perfetto(tracer, pf)
        obs.export_jsonl(tracer, jl)
        with open(pf) as f:
            doc = json.load(f)  # must be plain JSON for ui.perfetto.dev
        if "traceEvents" not in doc:
            failures.append("perfetto export lacks traceEvents")
        for path in (pf, jl):
            back = obs.read_events(path)
            v = obs.validate_events(back)
            if v:
                failures.append(f"{os.path.basename(path)} round-trip: {v[:3]}")
        if len(obs.read_events(pf)) != len(obs.read_events(jl)):
            failures.append("perfetto and jsonl round-trips disagree on event count")

    print(obs.summarize(events))
    print()
    n_spans = sum(e["type"] == "span" for e in events)
    print(f"selfcheck: {len(events)} events, {n_spans} spans, "
          f"{len(seen)} distinct span names, {len(violations)} schema violations, "
          f"mfo_activation_time={res.mfo_activation_time}")
    if failures:
        for f in failures:
            print("FAIL:", f)
        return 1
    print("selfcheck: OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
