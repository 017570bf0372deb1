"""MFTune tunes the LM stack's own distributed configuration.

The workload's "queries" are (arch x shape) cells; a query's latency is the
H100 roofline step time of the cell's step on the production mesh under the
candidate runtime configuration (``CellWorkload``). The tuner runs on the
card: its surrogate descent, rank aggregation and Shapley chains go through
K1-K3. Evaluations are cached by (cell, config) in ``cache_path``.

    PYTHONPATH=src python -m repro_torch.jaxwl.tune --budget-evals 16 \\
        --cells llama3-8b:train_4k mixtral-8x22b:decode_32k

(the reference's ``examples/tune_mesh.py``). ``--device cpu`` runs the
tuner's plain versions on the host.
"""

from __future__ import annotations

import argparse
from typing import Sequence, Tuple

from ..device import DeviceLike
from .workload import CACHE_PATH, CellWorkload

__all__ = ["tune_mesh", "main"]


def tune_mesh(cells: Sequence[Tuple[str, str]], budget_evals: float = 8,
              multi_pod: bool = False, cache_path: str = CACHE_PATH, seed: int = 0,
              device: DeviceLike = None):
    """MFTune over ``cells`` with a budget of ``budget_evals`` times the
    default configuration's summed step time (the reference's example:
    no knowledge base, no multi-fidelity, 4 LHS points). Returns (the
    default's EvalResult, the TuningResult, the MFTune object, whose ``wl``
    and ``kb`` hold the workload and the observations)."""
    from ..core import KnowledgeBase, MFTune, MFTuneOptions
    from ..tuneapi import Budget

    wl = CellWorkload(cells, multi_pod=multi_pod, cache_path=cache_path)
    base = wl.evaluate(wl.default_config())
    tuner = MFTune(wl, KnowledgeBase(), MFTuneOptions(
        seed=seed, enable_mfo=False, enable_transfer=False, init_lhs=4,
    ), device=device)
    res = tuner.run(Budget(base.aggregate * budget_evals))
    return base, res, tuner


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--budget-evals", type=float, default=8)
    ap.add_argument("--cells", nargs="+", default=["llama3-8b:train_4k"])
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--cache", default=CACHE_PATH)
    ap.add_argument("--device", default=None)
    args = ap.parse_args()

    cells = [tuple(c.split(":")) for c in args.cells]
    base, res, tuner = tune_mesh(cells, args.budget_evals, args.multi_pod, args.cache,
                                 device=args.device)
    wl = tuner.wl
    print(f"== default runtime config: modeled step time {base.aggregate * 1e3:.3f} ms "
          f"across {len(wl.queries)} cells (H100 SXM data-sheet roofline, not measured)")
    print(f"== best modeled step time {res.best_performance * 1e3:.3f} ms "
          f"({base.aggregate / res.best_performance:.3f}x the default) after "
          f"{res.n_evaluations} evaluations")
    for k, v in sorted(res.best_config.items()):
        print(f"   {k} = {v}")


if __name__ == "__main__":
    main()
