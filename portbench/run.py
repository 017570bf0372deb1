"""Run one cell of the port's benchmark once.

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The cell is an entry of ``BENCHMARK.json``;
its configuration, traffic mix, limits and per-layer readers are files
under ``portbench/`` found by name (``portbench/README.md``). The last line
of standard output is the result: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics with ``--trace 0``, its
per-layer metrics with ``--trace 1``), ``device`` and, traced,
``breakdown``; the numbers the check compared, each with its limit, come
last there under ``checks`` and as the last lines of standard error.

Exits non-zero, printing no result, without a CUDA device (or with fewer
than the cell asks for), outside a checkout that holds the program, and
where a module of JAX or of the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

from portbench.harness import env  # noqa: E402

T0 = env.process_start()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    env.prepare()
    if not (env.PACKAGE / "__init__.py").exists():
        print(f"portbench: the program ({env.PACKAGE}) is not in this checkout", file=sys.stderr)
        return 2
    from portbench.harness.manifest import cell as load_cell

    cell = load_cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s); "
              f"found {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench.harness.cell import run

    result = run(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), T0)
    found = env.forbidden_modules()
    if found:
        print(f"portbench: modules of JAX or of the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']} limit {c['limit']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
