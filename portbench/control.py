"""Read a cell's compared numbers for the program and for the control, on
several seeds, in one process.

    python3 portbench/control.py --workload <name> --seconds <s> --seeds <n> [<n> ...] [--fault <f>]

The control is the plain reference put in the program's place in fp8
(``reference/lowp.py``), the nearest precision below the bf16 that the
configurations state. Each seed is one short run of the cell (long enough
to finish the requests the check takes) followed by the check, with the
control's numbers beside the program's; one JSON line a seed. The
benchmark's own runs never run the control: a limit is set between the
program's largest reading and the control's smallest (``PERF.md``).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import env  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default=None,
                   help="plant a fault of the traffic kind (portbench/kinds/<kind>.py) under "
                        "the timed path and read the program's numbers only")
    args = p.parse_args(argv)
    env.prepare()
    import torch

    from portbench.harness import manifest
    from portbench.harness.cell import run

    if not torch.cuda.is_available():
        print("control: no CUDA device", file=sys.stderr)
        return 2
    cell = manifest.cell(args.workload)
    kind = manifest.kind(cell.traffic["kind"])
    for seed in args.seeds:
        with kind.fault(args.fault) if args.fault else contextlib.nullcontext():
            r = run(cell, seed, args.seconds, False, torch.device("cuda", 0),
                    env.process_start(), control=not args.fault)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "program": r.get("numbers") or
                          {k: v["value"] for k, v in r["checks"].items()},
                          "control": r.get("control")}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
    return 0


if __name__ == "__main__":
    sys.exit(main())
