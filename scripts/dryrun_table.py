"""Markdown tables of a dry-run sweep: a row per arch, a column per shape,
one table per mesh.

    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out OUT.json
    python3 scripts/dryrun_table.py OUT.json

Each cell, per device: arguments + temporaries (GB), the bottleneck
(c compute, m memory, x collective), the modeled step time (the H100 SXM
data-sheet roofline of ``repro_torch.tools.roofline``, not a measurement)
and ``useful_ratio``.
"""

from __future__ import annotations

import json
import sys

SHAPES = ("train_4k", "prefill_32k", "decode_32k", "long_500k")
BOTTLENECK = {"compute": "c", "memory": "m", "collective": "x"}


def cell(r) -> str:
    if r is None:
        return "—"
    if r["status"] != "ok":
        return r["status"]
    m, rl = r["memory"], r["roofline"]
    return (f"{m['args_gb_per_device']:.3g}+{m['temp_gb_per_device']:.3g}, "
            f"{BOTTLENECK[rl['bottleneck']]}, "
            f"{rl['step_time_s']:.4g} s, {rl['useful_ratio']:.3f}")


def main() -> None:
    with open(sys.argv[1]) as f:
        rows = json.load(f)
    by = {(r["arch"], r["shape"], r["multi_pod"]): r for r in rows}
    archs = sorted({r["arch"] for r in rows})
    for mp, name in ((False, "16 × 16"), (True, "2 × 16 × 16")):
        print(f"| {name} | " + " | ".join(SHAPES) + " |")
        print("|---" * (len(SHAPES) + 1) + "|")
        for a in archs:
            print(f"| {a} | " + " | ".join(cell(by.get((a, s, mp))) for s in SHAPES) + " |")
        print()
    n = {s: sum(r["status"] == s for r in rows) for s in ("ok", "skipped", "error")}
    traced = sum(r.get("lower_s", 0) + r.get("compile_s", 0) for r in rows)
    print(f"{n['ok']} ok, {n['skipped']} skipped, {n['error']} errors; "
          f"{traced:.1f} s of setup and traces summed over the cells")


if __name__ == "__main__":
    main()
