#!/usr/bin/env python3
"""Time the smoke's 24 h tuner run of one checkout, with its knowledge base.

    python3 scripts/tuner_wall.py ROOT

ROOT is a checkout of this repository: this one, or an earlier commit
unpacked beside it (``git archive <commit> | tar -x -C <dir>``), so two
commits can be run in turns (parent, change, change, parent) in one call on
one card, each in its own process. Needs ``nvcc`` and an NVIDIA GPU. Uses
ROOT's own ``chip_smoke.py``: builds K1-K3, draws the knowledge base of the
other 31 tasks of the grid x 50 observations on the card (``grid_kb``, its
host seconds as ``kb_s``), then times ``MFTune`` on TPC-H 100 GB, hardware
A, for 24 virtual hours from seed 0 (host clock ending in a device sync,
``wall_s``), and prints one line with the host seconds of each ``obs``
span.
"""

import sys
import time

root = sys.argv[1]
sys.path.insert(0, root + "/src")
sys.path.insert(0, root)

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from repro_torch import obs  # noqa: E402
from repro_torch.kernels import build  # noqa: E402

build.build_all(("forest_eval", "radix_rank", "chain_ordinals"))
t0 = time.perf_counter()
kb = cs.grid_kb(cs.KB_OBS, "cuda")
torch.cuda.synchronize()
kb_s = time.perf_counter() - t0
t0 = time.perf_counter()
with obs.tracing(name="wall") as tracer:
    res, sig, _ = cs.tune(kb, "cuda", hours=24.0)
torch.cuda.synchronize()
wall = time.perf_counter() - t0
spans = cs.span_seconds(tracer)
print(f"[wall] {root} kb_s={kb_s:.3f} wall_s={wall:.3f} evaluations={res.n_evaluations} "
      f"best={res.best_performance} " + " ".join(f"{k}={v:.3f}" for k, v in spans.items()),
      flush=True)
