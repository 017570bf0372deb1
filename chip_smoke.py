#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of MFTune on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order:

1. the card's name and power limit (``nvidia-smi``);
2. the build of the three CUDA kernels from ``src/repro_torch/csrc``, with
   the ``-Xptxas -v`` register and spill lines;
3. ``tuner``: ``repro_torch.core.MFTune`` on TPC-H 100 GB, hardware A, for
   24 virtual hours against a knowledge base of the other 31 tasks of the
   grid, with every kernel's launch count reset just before the run and
   read just after (each must be > 0); the inputs of each kernel's largest
   call in the run are kept;
4. ``kernels``: each kernel launched on those inputs and held against its
   plain PyTorch version on the same card (exact equality), then timed with
   CUDA events beside its plain version, a PyTorch library yardstick where
   one exists, and its bound; then K1 and K2 the same way at 131072
   candidates, the scale of the fused propose step;
5. ``agree``: a small fixed-seed tuner run on ``cuda`` and on ``cpu`` whose
   observation streams and trajectories must be identical;
6. one JSON line with the kernels' numbers, the card line, and as the last
   line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores


def fail(msg: str) -> "NoReturn":  # noqa: F821
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, after a warm-up, from
    CUDA events on the current stream."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def bound(n_bytes: float, n_ops: float):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the float32 rate."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / FP32_OPS_PER_S * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# knowledge bases
# ---------------------------------------------------------------------------


def build_kb(specs, n_obs: int, device, seed0: int = 0):
    from repro_torch.core import KnowledgeBase
    from repro_torch.sparksim import generate_history

    kb = KnowledgeBase()
    for i, spec in enumerate(specs):
        kb.add_task(generate_history(spec.workload(), n_obs=n_obs, seed=seed0 + i,
                                     device=device), persist=False)
    return kb


TARGET = ("tpch", 100, "A")
KB_OBS = 50  # the paper's historical-data protocol: 50 observations per task


def grid_kb(n_obs: int, device):
    """Histories of the 32-task grid minus the target, one per task."""
    from repro_torch.sparksim import all_task_specs, make_task_id

    target_id = make_task_id(*TARGET)
    specs = [s for s in all_task_specs() if s.task_id != target_id]
    return build_kb(specs, n_obs, device)


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

SOURCES = {
    "forest_eval": ("src/repro_torch/csrc/forest_eval.cu",
                    "src/repro/kernels/forest_eval/kernel.py:51"),
    "radix_rank": ("src/repro_torch/csrc/radix_rank.cu",
                   "src/repro/kernels/forest_eval/rank.py:324"),
    "chain_ordinals": ("src/repro_torch/csrc/chain_ordinals.cu",
                       "src/repro/kernels/forest_eval/kernel.py:117"),
}


def kernel_fns(name: str):
    """(module, CUDA wrapper name, plain version, work, shape) of a kernel.
    ``work(args)`` counts its operations, ``shape(args)`` describes a call."""
    from repro_torch.kernels.forest_eval import chain, ops, rank

    if name == "forest_eval":
        return (ops, "forest_eval_cuda", ops.forest_eval_plain,
                lambda a: a[5].numel() * a[6].shape[0] * a[7],
                lambda a: f"trees={a[5].numel()} nodes={a[0].numel()} depth={a[7]} "
                          f"pool={a[6].shape[0]}x{a[6].shape[1]}")
    if name == "radix_rank":
        return (rank, "radix_rank_cuda", rank.radix_rank_plain,
                lambda a: 0, lambda a: f"rows={a[0].shape[0]} n={a[0].shape[1]}")
    wx, wb = 0, 1
    return (chain, "chain_ordinals_cuda", chain.chain_ordinals_plain,
            lambda a: a[wx].shape[0] * (a[wx].shape[1] + 1) * a[wb].shape[0]
                      * a[wx].shape[2] * a[wx].shape[3],
            lambda a: f"chains={a[wx].shape[0]} d={a[wx].shape[1]} bg={a[wb].shape[0]} "
                      f"trees={a[wx].shape[2]} words={a[wx].shape[3]}")


def call_size(name: str, args) -> int:
    """Output elements of one call, by which the largest call is chosen."""
    if name == "forest_eval":
        return args[5].numel() * args[6].shape[0]
    if name == "radix_rank":
        return args[0].numel()
    return args[0].shape[0] * (args[0].shape[1] + 1) * args[1].shape[0] * args[0].shape[2]


@contextlib.contextmanager
def capture_calls():
    """While active, every launch of a kernel's CUDA wrapper is tallied by
    shape, and a copy of the inputs of its largest call is kept. Yields
    ``{name: {"largest": args, "shapes": Counter}}``."""
    import torch

    seen = {name: {"largest": None, "size": -1, "shapes": Counter()} for name in SOURCES}
    restore = []
    for name in SOURCES:
        module, attr, _, _, shape = kernel_fns(name)
        launch = getattr(module, attr)

        def wrapped(*args, _name=name, _launch=launch, _shape=shape):
            rec = seen[_name]
            rec["shapes"][_shape(args)] += 1
            size = call_size(_name, args)
            if size > rec["size"]:
                rec["size"] = size
                rec["largest"] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            return _launch(*args)

        setattr(module, attr, wrapped)
        restore.append((module, attr, launch))
    try:
        yield seen
    finally:
        for module, attr, launch in restore:
            setattr(module, attr, launch)


def hold(name: str, args, reps: int, library=None) -> dict:
    """Launch a kernel once on ``args``, require exact equality with its
    plain version (and with ``library()`` where given), then time all of
    them with CUDA events."""
    import torch

    module, attr, plain, work, shape = kernel_fns(name)
    cuda = getattr(module, attr)
    got, want = cuda(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    match = all(torch.equal(g, w) for g, w in zip(got, want))
    if library is not None:
        match = match and torch.equal(got[0], library())
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    tensors = [a for a in args if torch.is_tensor(a)]
    b_ms, b_by = bound(nbytes(*tensors) + nbytes(*got), work(args))
    source, replaces = SOURCES[name]
    row = dict(
        name=name, source=source, replaces=replaces, shape=shape(args),
        match=match, max_abs_err=err,
        ms=cuda_time_ms(lambda: cuda(*args), reps),
        plain_ms=cuda_time_ms(lambda: plain(*args), max(2, reps // 5)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=None if library is None else cuda_time_ms(library, reps),
    )
    print(f"[kernels] {name}: {row['shape']} match={match} max_abs_err={err} "
          f"ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} library_ms={row['library_ms']} "
          f"bound_ms={row['bound_ms']:.6f} ({b_by})", flush=True)
    return row


def rank_library(keys):
    """One-sort PyTorch yardstick for K2: positions under a stable argsort
    of the keys (bit 63 flipped, so int64 order is the unsigned order)."""
    import torch

    S, N = keys.shape
    iota = torch.arange(N, dtype=torch.float64, device=keys.device).expand(S, N)
    signed = keys ^ (-(1 << 63))
    return lambda: torch.empty_like(iota).scatter_(1, torch.argsort(signed, dim=1, stable=True),
                                                   iota)


def check_main_path(captured) -> list:
    """Each kernel at the largest call the tuner run gave it, on a copy of
    that call's inputs."""
    rows = []
    for name, rec in captured.items():
        print(f"[kernels] {name}: tuner calls by shape: {dict(rec['shapes'].most_common(6))}",
              flush=True)
        if rec["largest"] is None:
            fail(f"the tuner run never called {name}")
        args = rec["largest"]
        rows.append(hold(name, args, reps=200,
                         library=rank_library(args[0]) if name == "radix_rank" else None))
    return rows


def check_at_scale(kb, device, pool_n: int = 131072, n_sources: int = 12) -> list:
    """K1 and K2 at the fused-propose scale (ROADMAP item 7): a plane of 12
    sources over a 131072-candidate pool, and their 12 EI rows."""
    import numpy as np
    import torch

    from repro_torch.core import make_forest
    from repro_torch.core.acquisition import ei_matrix
    from repro_torch.core.surrogate import ForestPlane
    from repro_torch.kernels.forest_eval import rank
    from repro_torch.sparksim import SparkWorkload

    space = SparkWorkload(*TARGET).space
    tasks = [kb.get(t) for t in sorted(kb.tasks)][:n_sources]
    forests = []
    for i, task in enumerate(tasks):
        ok = task.successful()
        X = space.encode_many([o.config for o in ok])
        y = np.array([o.performance for o in ok])
        forests.append(make_forest(seed=i, device=device).fit(X, y))
    plane = ForestPlane([f.pack() for f in forests])
    pool = space.sample(np.random.default_rng(7), pool_n).unit_tensor(device)
    args = (plane.feat, plane.thr, plane.child, plane.mean, plane.var, plane.roots, pool,
            plane.depth)
    rows = [hold("forest_eval", args, reps=20)]
    # the EI on the card must equal the host's bit for bit (IEEE sqrt and
    # division)
    means, vars_ = plane.predict(pool)
    bests = [float(f.y_.min()) for f in forests]
    ei = ei_matrix(means, vars_, bests)
    if not torch.equal(ei.cpu(), ei_matrix(means.cpu(), vars_.cpu(), bests)):
        fail("EI on the card differs from EI on the host")
    keys = rank.monotone_keys(ei).contiguous()
    rows.append(hold("radix_rank", (keys,), reps=20, library=rank_library(keys)))
    return rows


# ---------------------------------------------------------------------------
# tuner runs
# ---------------------------------------------------------------------------


def tune(kb, device, hours: float, target=TARGET):
    from repro_torch.core import MFTune, MFTuneOptions
    from repro_torch.sparksim import SparkWorkload
    from repro_torch.tuneapi import Budget

    wl = SparkWorkload(*target)
    res = MFTune(wl, kb, MFTuneOptions(seed=0), device=device).run(Budget(hours * 3600.0))
    obs = kb.get(wl.task_id).observations
    sig = [(o.performance, o.fidelity, tuple(sorted(o.config.items()))) for o in obs]
    traj = [(p.time, p.best, tuple(sorted(p.config.items()))) for p in res.trajectory]
    return res, sig, traj


def span_seconds(tracer) -> dict:
    """Host-clock seconds per span name (nested spans count in their
    parents too)."""
    out: dict = {}
    for ev in tracer.events:
        if ev.get("type") == "span":
            out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def run_tuner(kb, device):
    """The 24 h tuner run; returns its launch counts and the kernel calls
    it made (see :func:`capture_calls`)."""
    import math

    import torch

    from repro_torch import obs
    from repro_torch.kernels import counts

    torch.cuda.reset_peak_memory_stats()
    with capture_calls() as captured:
        counts.reset()
        t0 = time.perf_counter()
        with obs.tracing(name="chip_smoke") as tracer:
            res, sig, _ = tune(kb, device, hours=24.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(counts.LAUNCHES)
        plain = dict(counts.PLAIN_CALLS)
    print(f"[tuner] evaluations={res.n_evaluations} full={res.n_full_evaluations} "
          f"best_latency_s={res.best_performance} wall_s={wall:.3f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"launches={launches} plain_calls={plain}", flush=True)
    spans = span_seconds(tracer)
    print("[tuner] host seconds by span: " + " ".join(
        f"{k}={v:.3f}" for k, v in spans.items()), flush=True)
    if not (res.n_evaluations > 0 and math.isfinite(res.best_performance)
            and res.best_performance > 0):
        fail("tuner produced no finite best latency")
    if any(v != 0 for v in plain.values()):
        fail(f"the cuda run reached a plain version: {plain}")
    zero = [k for k, v in launches.items() if v == 0]
    if zero:
        fail(f"kernels never launched on the main path: {zero}")
    return launches, captured


def run_agreement() -> None:
    from repro_torch.sparksim import TaskSpec

    specs = [TaskSpec("tpch", 600, "B"), TaskSpec("tpch", 100, "B")]
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res, sig, traj = tune(build_kb(specs, 20, dev), dev, hours=8.0)
        out[dev] = (sig, traj)
        print(f"[agree] {dev}: evaluations={res.n_evaluations} "
              f"best_latency_s={res.best_performance} wall_s={time.perf_counter() - t0:.3f}",
              flush=True)
    same_obs = out["cuda"][0] == out["cpu"][0]
    same_traj = out["cuda"][1] == out["cpu"][1]
    print(f"[agree] observations identical={same_obs} trajectory identical={same_traj}",
          flush=True)
    if not (same_obs and same_traj and len(out["cuda"][0]) > 10):
        fail("cuda and cpu runs disagree")


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no repro_torch checkout beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    device = "cuda"
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {len(logs)} kernels in {time.perf_counter() - t0:.1f}s "
          f"with {' '.join(build.NVCC_FLAGS)}", flush=True)
    for name, text in logs.items():
        for line in text.splitlines():
            if "ptxas" in line or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}", flush=True)

    t0 = time.perf_counter()
    kb = grid_kb(KB_OBS, device)
    print(f"[kb] {len(kb.tasks)} histories x {KB_OBS} observations built on "
          f"{device} in {time.perf_counter() - t0:.1f}s", flush=True)
    launches, captured = run_tuner(kb, device)
    main_rows = check_main_path(captured)
    scale_rows = check_at_scale(kb, device)
    bad = [f"{r['name']} ({r['shape']})" for r in main_rows + scale_rows if not r["match"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    run_agreement()

    def line(r, n_launches):
        return {"name": r["name"], "route": "cuda", "source": r["source"],
                "replaces": r["replaces"], "launches": n_launches, "shape": r["shape"],
                "max_abs_err": r["max_abs_err"], "match": r["match"], "ms": r["ms"],
                "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
                "bound_by": r["bound_by"], "library_ms": r["library_ms"]}

    # "kernels": each kernel at the largest call of the tuner run, with the
    # run's launch count; "at_scale": K1 and K2 at 131072 candidates, which
    # the tuner run does not reach (no launch count)
    print(json.dumps({"kernels": [line(r, launches[r["name"]]) for r in main_rows],
                      "at_scale": [line(r, None) for r in scale_rows]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
