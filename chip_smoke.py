#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port of MFTune on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order:

1. the card's name and power limit (``nvidia-smi``);
2. the build of the CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once), with the ``-Xptxas -v`` register and
   spill lines;
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
5. ``serve``: the LM serving path at the full width of llama3-8b (32
   layers, d_model 4096, 32/8 heads of 128, d_ff 14336, vocab 128256,
   bf16, 16 GB of weights drawn on the card from seed 0): a 2 x 4096-token
   prefill through ``repro_torch.models.forward`` with
   ``attn_impl="flash"``, with K4's counts reset just before it and read
   just after (32 launches, no plain call), held against the plain blocked
   route (logits within 5e-2 of their largest magnitude, softmax within
   5e-2); ``ServingEngine`` answering 4 greedy requests of 64 prompt tokens
   with 32 new tokens each; a 64-token prompt teacher-forced through
   ``decode_step`` against ``forward`` (the same bounds, which must sit 4x
   under what another first context token does to the logits); a
   ``torch.profiler`` breakdown of one prefill and one decode step (kernel
   count, device busy share of the unprofiled wall, the costliest
   kernels); then K4 on the prefill's own inputs against its plain version,
   in bf16 (o within one bf16 step plus 1e-3) and upcast to float32 (o
   within 2e-5; lse within 1e-3 in both), timed beside it and beside
   ``scaled_dot_product_attention`` with KV expanded to all heads (timed
   only), and K4 at small shapes in both dtypes for every mask variant,
   rows that see no key included;
6. ``train``: the dense training path at llama3-8b's full width with its
   depth cut from 32 to 8 layers (the cut, with its reason, is printed): bf16
   weights drawn on the card from seed 0, float32 AdamW moments, a batch of
   2 x 4096 tokens from ``SyntheticTokenPipeline(seed=0)``, ``attn_impl=
   "flash"``, lr 1e-5. ``Trainer.run(3)`` with the counts of K4, K5 and K6 reset
   just before it and read just after (8 x 3 launches each, no plain call),
   finite losses and a first loss within 1 of ln(128256); three
   ``make_train_step`` steps on one repeated batch, whose loss must fall;
   one ``loss_fn`` gradient through the flash route and the plain ``xla``
   route from the same weights and batch (loss within 1e-2, each gradient
   leaf within 5e-2 relative in L2 and 4x under what another batch does to
   it); a ``torch.profiler`` breakdown of one step; then K5 and K6 on the
   first layer's own inputs against their plain versions (bf16 within one
   bf16 step plus 1e-3 of the largest magnitude, float32 within 2e-5),
   timed beside them, beside the backward of
   ``scaled_dot_product_attention`` (timed only) and against their bounds,
   and at small shapes in both dtypes for every mask variant;
7. ``agree``: a small fixed-seed tuner run on ``cuda`` and on ``cpu`` whose
   observation streams and trajectories must be identical;
8. one JSON line with the kernels' numbers, the card line, and as the last
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
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense


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


def bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type (float32 by default)."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = n_ops / ops_per_s * 1e3
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
    zero = [k for k in SOURCES if launches[k] == 0]
    if zero:
        fail(f"kernels never launched on the tuner path: {zero}")
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


# ---------------------------------------------------------------------------
# LM serving path (llama3-8b at full width)
# ---------------------------------------------------------------------------

LM_ARCH = "llama3-8b"
PREFILL = (2, 4096)           # batch x prompt tokens of the prefill
SERVE_REQS, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN = 4, 64, 32, 128
SOFTMAX_BOUND = 5e-2          # the bound of tests/test_decode_consistency.py
# max |logit diff| / max |logit| between the flash and plain routes and
# between decode and forward: on an H100 the two read 9.7e-3 and 1.4e-2,
# and another first token of a 64-token context moves the last position's
# logits by 1.3
LOGIT_TOL = 5e-2
# K4 against its plain version, (atol, rtol) on o: float32 at the tolerance
# of tests/test_kernels.py; bfloat16 within one bf16 rounding step (2**-7
# relative, both compute in float32 from the same inputs) plus 1e-3; lse
# (float32 in both dtypes) within 1e-3 absolute
K4_O_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 8e-3)}
K4_LSE_ATOL = 1e-3
K4_SOURCE = ("src/repro_torch/csrc/flash_attn_fwd.cu", "src/repro/kernels/flash_attn/kernel.py:77")


def logit_errs(a, b) -> tuple:
    """(max |a - b| / max |b|, max abs difference of the softmaxes, largest
    probability of b) over the last axis, in float32."""
    import torch

    a, b = a.float(), b.float()
    pb = torch.softmax(b, -1)
    return (float((a - b).abs().max() / b.abs().max()),
            float((torch.softmax(a, -1) - pb).abs().max()), float(pb.max()))


def k4_errs(o, lse, po, plse) -> tuple:
    """(o within tolerance, max |o - po|, max |lse - plse|) of K4's outputs
    against its plain version's."""
    import torch

    atol, rtol = K4_O_TOL[str(o.dtype)[6:]]
    o_err = float((o.float() - po.float()).abs().max())
    lse_err = float((lse - plse).abs().max())
    ok = bool(torch.allclose(o.float(), po.float(), atol=atol, rtol=rtol)
              and lse_err <= K4_LSE_ATOL)
    return ok, o_err, lse_err


@contextlib.contextmanager
def keep_flash_call(index: int, *wrappers: str):
    """While active, a copy of the inputs of the ``index``-th launch (from
    0) of each named CUDA wrapper of ``kernels.flash_attn.ops`` is kept in
    the yielded dict, as ``{wrapper: (args, kwargs)}``."""
    import torch

    from repro_torch.kernels.flash_attn import ops

    kept: dict = {}
    originals = {name: getattr(ops, name) for name in wrappers}

    def wrap(name):
        launch, calls = originals[name], [0]

        def wrapped(*args, **kwargs):
            if calls[0] == index:
                kept[name] = (tuple(a.clone() for a in args), dict(kwargs))
            calls[0] += 1
            return launch(*args, **kwargs)

        return wrapped

    for name in wrappers:
        setattr(ops, name, wrap(name))
    try:
        yield kept
    finally:
        for name, launch in originals.items():
            setattr(ops, name, launch)
        torch.cuda.synchronize()


def visible_pairs(Sq: int, Sk: int, causal: bool, window, q_offset: int) -> int:
    """(query, key) pairs the positional mask lets through, per (BH, group)."""
    import numpy as np

    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def sdpa_yardstick(q, k, v):
    """One ``scaled_dot_product_attention`` call on K4's inputs with KV
    expanded to every query head (timed beside K4, never used)."""
    import torch.nn.functional as F

    BHkv, S, G, D = q.shape
    B = PREFILL[0]
    Hkv = BHkv // B
    qs = q.reshape(B, Hkv, S, G, D).permute(0, 1, 3, 2, 4).reshape(B, Hkv * G, S, D).contiguous()
    ks = k.reshape(B, Hkv, 1, S, D).expand(B, Hkv, G, S, D).reshape(B, Hkv * G, S, D).contiguous()
    vs = v.reshape(B, Hkv, 1, S, D).expand(B, Hkv, G, S, D).reshape(B, Hkv * G, S, D).contiguous()
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)


def hold_flash(args, kwargs, launches: int) -> dict:
    """K4 on the prefill's own inputs against its plain version, in their
    dtype (bf16) and upcast to float32, then timed beside it, beside SDPA,
    and against its bound."""
    import torch

    from repro_torch.kernels.flash_attn import ops

    q, k, v = args
    o, lse = ops.flash_fwd_cuda(q, k, v, **kwargs)
    po, plse = ops.flash_fwd_plain(q, k, v, q_block=512, kv_block=1024, **kwargs)
    torch.cuda.synchronize()
    match, o_err, lse_err = k4_errs(o, lse, po, plse)
    err = max(o_err, lse_err)
    print(f"[serve] K4 vs plain at the prefill's inputs, bf16: max|o|={float(po.abs().max())} "
          f"o err {o_err} lse err {lse_err} match={match}", flush=True)
    del o, lse, po, plse
    q32, k32, v32 = q.float(), k.float(), v.float()
    o, lse = ops.flash_fwd_cuda(q32, k32, v32, **kwargs)
    po, plse = ops.flash_fwd_plain(q32, k32, v32, q_block=512, kv_block=1024, **kwargs)
    torch.cuda.synchronize()
    match32, o_err, lse_err = k4_errs(o, lse, po, plse)
    print(f"[serve] K4 vs plain at the prefill's inputs upcast to float32: max|o|="
          f"{float(po.abs().max())} o err {o_err} lse err {lse_err} match={match32}", flush=True)
    match = match and match32
    del q32, k32, v32, o, lse, po, plse
    BH, Sq, G, D = q.shape
    pairs = visible_pairs(Sq, k.shape[1], kwargs["causal"], kwargs["window"], kwargs["q_offset"])
    flops = 4.0 * BH * G * D * pairs   # two products, a multiply and an add each
    out_bytes = nbytes(q) + BH * Sq * G * 4   # o in q's dtype, lse in float32
    b_ms, b_by = bound(nbytes(q, k, v) + out_bytes, flops, BF16_OPS_PER_S)
    row = dict(name="flash_attn_fwd", source=K4_SOURCE[0], replaces=K4_SOURCE[1],
               shape=f"q={tuple(q.shape)} kv={tuple(k.shape)} {str(q.dtype)[6:]} "
                     f"causal={kwargs['causal']}",
               match=match, max_abs_err=err,
               ms=cuda_time_ms(lambda: ops.flash_fwd_cuda(q, k, v, **kwargs), 10),
               plain_ms=cuda_time_ms(lambda: ops.flash_fwd_plain(
                   q, k, v, q_block=512, kv_block=1024, **kwargs), 3),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=cuda_time_ms(sdpa_yardstick(q, k, v), 10))
    print(f"[serve] K4 at the prefill's inputs: {row['shape']} match={match} max_abs_err={err} "
          f"ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} sdpa_ms={row['library_ms']:.6f} "
          f"bound_ms={b_ms:.6f} ({b_by}) flops={flops:.4g} launches={launches}", flush=True)
    return row


def check_flash_small() -> list:
    """K4 against its plain version at small shapes, both dtypes, every
    mask variant; returns the names of the cases that disagree."""
    import torch

    from repro_torch.kernels.flash_attn import ops

    bad, worst = [], {}
    g = torch.Generator(device="cpu").manual_seed(0)
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for BH, Sq, Sk, G, D in [(2, 64, 64, 1, 16), (3, 48, 80, 3, 64), (2, 128, 256, 4, 128)]:
            # (causal, window, q rows, q_offset): the last two cases put the
            # rows at the end of the keys, and past them, where the rows from
            # position Sk + 31 on see no key
            for causal, window, sq, offset in [
                    (True, None, Sq, 0), (False, None, Sq, 0), (True, 32, Sq, 0),
                    (False, 32, Sq, 0), (True, None, Sq // 2, Sk - Sq // 2),
                    (False, 32, Sq, Sk - 16)]:
                q = torch.randn((BH, sq, G, D), generator=g).to("cuda", td)
                k = torch.randn((BH, Sk, D), generator=g).to("cuda", td)
                v = torch.randn((BH, Sk, D), generator=g).to("cuda", td)
                kw = dict(causal=causal, window=window, q_offset=offset)
                o, lse = ops.flash_fwd_cuda(q, k, v, **kw)
                po, plse = ops.flash_fwd_plain(q, k, v, q_block=8, kv_block=16, **kw)
                ok, o_err, lse_err = k4_errs(o, lse, po, plse)
                w = worst.setdefault(dtype, [0.0, 0.0])
                w[0], w[1] = max(w[0], o_err), max(w[1], lse_err)
                if not ok:
                    bad.append(f"{dtype} {(BH, sq, Sk, G, D)} {kw}")
    print(f"[serve] K4 small shapes x masks x dtypes: max abs err [o, lse] {worst} "
          f"disagree={bad}", flush=True)
    return bad


def device_profile(fn, label: str, reps: int, tag: str = "serve") -> None:
    """Time ``fn`` on the host clock (mean of ``reps`` calls), then run it
    once under ``torch.profiler`` and print the number of CUDA kernels it
    ran, their summed device time, the device busy share of the
    unprofiled wall (the profiler's own wall is longer), the kernels that
    took the most and the device time by class of kernel."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] profile {label}: wall_s={wall:.6f}; the profiler saw no device "
              f"kernels (device time not measured)", flush=True)
        return
    by_name: Counter = Counter()
    by_class: Counter = Counter()
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name[:60]] += us
        by_class[kernel_class(e.name)] += us
    busy = sum(by_name.values()) / 1e6
    top = ", ".join(f"{n} {us / 1e3:.3f}ms" for n, us in by_name.most_common(6))
    classes = ", ".join(f"{n} {us / 1e3:.3f}ms" for n, us in by_class.most_common())
    print(f"[{tag}] profile {label}: wall_s={wall:.6f} (mean of {reps}, unprofiled) "
          f"profiled_wall_s={pwall:.6f} kernels={len(kernels)} device_busy_s={busy:.6f} "
          f"busy_share={busy / wall:.4f}; top: {top}; by class: {classes}", flush=True)


def kernel_class(name: str) -> str:
    """A coarse class of a CUDA kernel, by its name."""
    if "flash_" in name:
        return "attention K4-K6"
    if "f32f32" in name or "sgemm" in name:
        return "float32 GEMM"
    if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "bf16 GEMM"
    if any(t in name for t in ("elementwise", "reduce", "Reduce", "index", "gather", "scatter",
                               "cat", "copy", "fill", "softmax", "norm")):
        return "elementwise, copies and reductions"
    return "other"


def run_serve(device) -> tuple:
    """The ``serve`` phase; returns (K4's row, K4 launches in the prefill)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import counts
    from repro_torch.models import (Runtime, build_param_specs, decode_step, forward,
                                    init_cache, init_params, param_bytes)
    from repro_torch.serving import Request, ServingEngine

    cfg = get_arch(LM_ARCH)
    rt = Runtime(attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    specs = build_param_specs(cfg, rt)
    params = init_params(specs, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab} "
          f"{rt.param_dtype}: {param_bytes(specs)} weight bytes drawn on {device} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    rng = np.random.default_rng(0)
    B, S = PREFILL
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab, (B, S))).to(device)
    with torch.no_grad():
        forward(params, cfg, rt, tokens=tokens[:1, :512])   # warm-up: cuBLAS, K4 load
        torch.cuda.synchronize()
        with keep_flash_call(0, "flash_fwd_cuda") as kept:
            counts.reset()
            t0 = time.perf_counter()
            logits = forward(params, cfg, rt, tokens=tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counts.LAUNCHES["flash_attn_fwd"]
            plain = counts.PLAIN_CALLS["flash_attn_fwd"]
        peak = torch.cuda.max_memory_allocated()
        print(f"[serve] prefill {B}x{S} attn_impl=flash: wall_s={wall:.6f} "
              f"tokens_per_s={B * S / wall:.1f} max_memory_allocated={peak} "
              f"K4 launches={launches} plain_calls={plain}", flush=True)
        if launches != cfg.n_layers or plain != 0:
            fail(f"prefill launched K4 {launches} times (want {cfg.n_layers}) and its plain "
                 f"version {plain} times (want 0)")
        if tuple(logits.shape) != (B, S, cfg.vocab) or not bool(torch.isfinite(logits).all()):
            fail(f"prefill logits of shape {tuple(logits.shape)} are not finite")
        sample = list(range(0, S, 512)) + [S - 1]
        flash_rows = logits[:, sample].float()
        del logits

        t0 = time.perf_counter()
        plain_logits = forward(params, cfg, dataclasses.replace(rt, attn_impl="xla"),
                               tokens=tokens)
        torch.cuda.synchronize()
        xla_wall = time.perf_counter() - t0
        rel, err, pmax = logit_errs(flash_rows, plain_logits[:, sample])
        del plain_logits
        print(f"[serve] prefill attn_impl=xla (plain blocked route): wall_s={xla_wall:.6f}; "
              f"flash vs xla at positions {sample}: max|logit diff|/max|logit| {rel} "
              f"(bound {LOGIT_TOL}), softmax max diff {err} (bound {SOFTMAX_BOUND}) "
              f"beside a largest probability of {pmax}", flush=True)
        if not (rel <= LOGIT_TOL and err < SOFTMAX_BOUND):
            fail(f"flash and xla routes disagree: logit diff {rel}, softmax diff {err}")

        engine = ServingEngine(params, cfg, rt, batch_size=SERVE_REQS, max_len=SERVE_MAX_LEN)
        reqs = [Request(prompt=rng.integers(2, cfg.vocab, SERVE_PROMPT).astype(np.int32),
                        max_new_tokens=SERVE_NEW) for _ in range(SERVE_REQS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        steps = SERVE_PROMPT + SERVE_NEW - 1
        n_new = sum(len(r.generated) for r in reqs)
        print(f"[serve] ServingEngine batch {SERVE_REQS} max_len {SERVE_MAX_LEN}: "
              f"{SERVE_REQS} greedy requests x {SERVE_PROMPT} prompt tokens, {n_new} new tokens "
              f"in wall_s={swall:.6f} ({steps} decode steps of {SERVE_REQS} slots: "
              f"step_ms={swall / steps * 1e3:.3f}, decode tokens_per_s="
              f"{SERVE_REQS * steps / swall:.1f}, new tokens_per_s={n_new / swall:.1f}); "
              f"first request: {reqs[0].generated[:8]}...", flush=True)
        if any(len(r.generated) != SERVE_NEW or not all(0 <= t < cfg.vocab for t in r.generated)
               for r in reqs):
            fail(f"not every request got {SERVE_NEW} tokens in range")

        prompt = torch.from_numpy(reqs[0].prompt[None].astype(np.int64)).to(device)
        par = forward(params, cfg, rt, tokens=prompt)[0].float()
        cache = init_cache(cfg, rt, 1, SERVE_PROMPT, device=device)
        dec = []
        for t in range(SERVE_PROMPT):
            lg, cache = decode_step(params, cfg, rt, cache, prompt[:, t:t + 1])
            dec.append(lg[0, 0].float())
        rel, derr, pmax = logit_errs(torch.stack(dec), par)
        # what the checks must be able to see: the last position's logits
        # when the first of the 64 context tokens is another one
        moved = prompt.clone()
        moved[0, 0] = 1
        sens = logit_errs(forward(params, cfg, rt, tokens=moved)[0, -1], par[-1])[0]
        print(f"[serve] decode_step teacher-forced over {SERVE_PROMPT} tokens vs forward: "
              f"max|logit diff|/max|logit| {rel} (bound {LOGIT_TOL}), softmax max diff {derr} "
              f"(bound {SOFTMAX_BOUND}) beside a largest probability of {pmax}; another first "
              f"token moves the last position's logits by {sens}", flush=True)
        if not (rel <= LOGIT_TOL and derr < SOFTMAX_BOUND):
            fail(f"decode and forward disagree: logit diff {rel}, softmax diff {derr}")
        if not sens > 4 * LOGIT_TOL:
            fail(f"the logit bound {LOGIT_TOL} is not 4x under the move {sens} that another "
                 f"context token makes")

        # where the time goes, from the profiler: one flash prefill and
        # one decode step of the 4-slot batch
        device_profile(lambda: forward(params, cfg, rt, tokens=tokens), f"prefill {B}x{S}", 2)
        cache = init_cache(cfg, rt, SERVE_REQS, SERVE_MAX_LEN, device=device)
        step_toks = torch.full((SERVE_REQS, 1), 7, device=device)
        for _ in range(SERVE_PROMPT):
            _, cache = decode_step(params, cfg, rt, cache, step_toks)
        device_profile(lambda: decode_step(params, cfg, rt, cache, step_toks),
                       f"decode step at position {SERVE_PROMPT}", 10)

    row = hold_flash(*kept["flash_fwd_cuda"], launches)
    bad = check_flash_small()
    if not row["match"] or bad:
        fail(f"K4 disagrees with its plain version: prefill match={row['match']} small={bad}")
    del params, engine, cache, kept
    torch.cuda.empty_cache()
    return row, launches


# ---------------------------------------------------------------------------
# LM training path (llama3-8b at full width, depth cut to 8 layers)
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 8              # llama3-8b's 32 layers cut to 8 (see run_train)
TRAIN_BATCH = (2, 4096)       # global batch x sequence length
TRAIN_STEPS = 3
# a step early in a warm-up towards llama3's published peak of 3e-4: at 3e-4
# from initialisation, AdamW's first sign-like step moves every logit by
# about 1 and the loss on the next batch rises from 11.9 to 17 (H100 run)
TRAIN_LR = 1e-5
# |first loss - ln(vocab)|: at initialisation the logits are about unit
# normal, which puts the expected loss near ln(vocab) + 1/2
LOSS_MARGIN = 1.0
# flash vs xla route from the same weights and batch: the loss within 1e-2,
# and each gradient leaf within 5e-2 relative in L2 (bf16 roundings of the
# attention outputs, carried through 8 layers), which must also sit 4x under
# what another batch does to that leaf
ROUTE_LOSS_TOL = 1e-2
ROUTE_GRAD_TOL = 5e-2
# K5/K6 against their plain versions, (atol as a fraction of the plain
# output's largest magnitude, rtol): float32 2e-5 of both (the summation
# order differs); bfloat16 one bf16 rounding step (2**-7 relative: both
# compute in float32 from the same inputs, then round) plus 1e-3 of the
# largest magnitude for values near zero
BWD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 8e-3)}
K5_SOURCE = ("src/repro_torch/csrc/flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:144")
K6_SOURCE = ("src/repro_torch/csrc/flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:211")


def bwd_errs(got, want) -> tuple:
    """(every output within BWD_TOL, max abs error, largest magnitude) of
    K5's or K6's outputs against the plain version's."""
    import torch

    frac, rtol = BWD_TOL[str(want[0].dtype)[6:]]
    ok, err, scale = True, 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        s = float(w.abs().max())
        ok = ok and bool(torch.allclose(g, w, atol=frac * s, rtol=rtol))
        err, scale = max(err, float((g - w).abs().max())), max(scale, s)
    return ok, err, scale


def sdpa_bwd_yardstick(q, k, v, do, batch: int):
    """The backward of one ``scaled_dot_product_attention(is_causal=True)``
    on K5's inputs with KV expanded to every query head: delta, dq, dk and
    dv in one library call (timed beside K5 and K6, never used)."""
    import torch
    import torch.nn.functional as F

    BHkv, S, G, D = q.shape
    Hkv = BHkv // batch

    def heads(t):
        return t.reshape(batch, Hkv, S, G, D).permute(0, 1, 3, 2, 4).reshape(batch, Hkv * G, S, D)

    def expand(t):
        return t.reshape(batch, Hkv, 1, S, D).expand(batch, Hkv, G, S, D).reshape(
            batch, Hkv * G, S, D)

    qs = heads(q).contiguous().requires_grad_(True)
    ks = expand(k).contiguous().requires_grad_(True)
    vs = expand(v).contiguous().requires_grad_(True)
    dos = heads(do).contiguous()
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    return lambda: torch.autograd.grad(o, (qs, ks, vs), dos, retain_graph=True)


def hold_bwd(kept, launches: dict) -> list:
    """K5 and K6 on the first layer's inputs from the training step against
    their plain versions, in bf16 and upcast to float32, then timed beside
    them, beside SDPA's backward, and against their bounds."""
    import torch

    from repro_torch.kernels.flash_attn import ops

    (q, k, v, do, lse, delta), kw = kept["flash_dq_cuda"]
    plain_kw = dict(q_block=512, kv_block=1024, **kw)
    rows = []
    checks = {}
    for label, args in (("bf16", (q, k, v, do)),
                        ("upcast to float32", tuple(t.float() for t in (q, k, v, do)))):
        dq = ops.flash_dq_cuda(*args, lse, delta, **kw)
        pdq = ops.flash_dq_plain(*args, lse, delta, **plain_kw)
        dk, dv = ops.flash_dkv_cuda(*args, lse, delta, **kw)
        pdk, pdv = ops.flash_dkv_plain(*args, lse, delta, **plain_kw)
        torch.cuda.synchronize()
        checks[label] = (bwd_errs((dq,), (pdq,)), bwd_errs((dk, dv), (pdk, pdv)))
        (ok5, e5, s5), (ok6, e6, s6) = checks[label]
        print(f"[train] K5/K6 vs plain at the first layer's inputs, {label}: dq max|plain| {s5} "
              f"err {e5} match={ok5}; dk/dv max|plain| {s6} err {e6} match={ok6}", flush=True)
        del dq, pdq, dk, dv, pdk, pdv
    BH, Sq, G, D = q.shape
    pairs = visible_pairs(Sq, k.shape[1], kw["causal"], kw["window"], kw["q_offset"])
    in_bytes = nbytes(q, k, v, do, lse, delta)
    library_ms = cuda_time_ms(sdpa_bwd_yardstick(q, k, v, do, TRAIN_BATCH[0]), 10)
    shape = f"q={tuple(q.shape)} kv={tuple(k.shape)} {str(q.dtype)[6:]} causal={kw['causal']}"
    for name, source, n_products, out_bytes, fn, plain, ck in (
            ("flash_attn_dq", K5_SOURCE, 3, nbytes(q),
             lambda: ops.flash_dq_cuda(q, k, v, do, lse, delta, **kw),
             lambda: ops.flash_dq_plain(q, k, v, do, lse, delta, **plain_kw), 0),
            ("flash_attn_dkv", K6_SOURCE, 4, nbytes(k, v),
             lambda: ops.flash_dkv_cuda(q, k, v, do, lse, delta, **kw),
             lambda: ops.flash_dkv_plain(q, k, v, do, lse, delta, **plain_kw), 1)):
        flops = 2.0 * n_products * BH * G * D * pairs   # a multiply and an add per term
        b_ms, b_by = bound(in_bytes + out_bytes, flops, BF16_OPS_PER_S)
        match = all(checks[lb][ck][0] for lb in checks)
        row = dict(name=name, source=source[0], replaces=source[1], shape=shape, match=match,
                   max_abs_err=max(checks[lb][ck][1] for lb in checks),
                   ms=cuda_time_ms(fn, 10), plain_ms=cuda_time_ms(plain, 3), bound_ms=b_ms,
                   bound_by=b_by, library_ms=library_ms,
                   library="backward of scaled_dot_product_attention (delta, dq, dk and dv "
                           "in one call, KV expanded to every head)")
        print(f"[train] {name} at the first layer's inputs: {shape} match={match} "
              f"max_abs_err={row['max_abs_err']} ms={row['ms']:.6f} plain_ms="
              f"{row['plain_ms']:.6f} sdpa_bwd_ms={library_ms:.6f} bound_ms={b_ms:.6f} ({b_by}) "
              f"flops={flops:.4g} launches={launches[name]}", flush=True)
        rows.append(row)
    return rows


def check_bwd_small() -> list:
    """K5 and K6 against their plain versions at small shapes, both dtypes,
    every mask variant; returns the names of the cases that disagree."""
    import torch

    from repro_torch.kernels.flash_attn import ops

    bad, worst = [], {}
    g = torch.Generator(device="cpu").manual_seed(1)
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for BH, Sq, Sk, G, D in [(2, 64, 64, 1, 16), (3, 48, 80, 3, 64), (1, 40, 72, 2, 32),
                                 (2, 128, 256, 4, 128)]:
            # (causal, window, q rows, q_offset): the last two put the rows
            # at the end of the keys and past them, where rows see no key
            for causal, window, sq, offset in [
                    (True, None, Sq, 0), (False, None, Sq, 0), (True, 32, Sq, 0),
                    (False, 32, Sq, 0), (True, None, Sq // 2, Sk - Sq // 2),
                    (False, 32, Sq, Sk - 16), (True, 16, Sq, Sk)]:
                q, do = (torch.randn((BH, sq, G, D), generator=g).to("cuda", td)
                         for _ in range(2))
                k, v = (torch.randn((BH, Sk, D), generator=g).to("cuda", td) for _ in range(2))
                kw = dict(causal=causal, window=window, q_offset=offset)
                o, lse = ops.flash_fwd_cuda(q, k, v, **kw)
                delta = (do.float() * o.float()).sum(-1)
                pkw = dict(q_block=sq, kv_block=8, **kw)
                ok5, e5, _ = bwd_errs((ops.flash_dq_cuda(q, k, v, do, lse, delta, **kw),),
                                      (ops.flash_dq_plain(q, k, v, do, lse, delta, **pkw),))
                ok6, e6, _ = bwd_errs(ops.flash_dkv_cuda(q, k, v, do, lse, delta, **kw),
                                      ops.flash_dkv_plain(q, k, v, do, lse, delta, **pkw))
                w = worst.setdefault(dtype, [0.0, 0.0])
                w[0], w[1] = max(w[0], e5), max(w[1], e6)
                if not (ok5 and ok6):
                    bad.append(f"{dtype} {(BH, sq, Sk, G, D)} {kw} dq={ok5} dkv={ok6}")
    print(f"[train] K5/K6 small shapes x masks x dtypes: max abs err [dq, dk/dv] {worst} "
          f"disagree={bad}", flush=True)
    return bad


def grads_of(params, cfg, rt, batch) -> tuple:
    """(loss, gradient leaves) of ``loss_fn`` through autograd."""
    import torch

    from repro_torch.models import loss_fn
    from repro_torch.models.params import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn(params, cfg, rt, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return float(loss.detach()), grads


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def run_train(device) -> tuple:
    """The ``train`` phase; returns (K5's and K6's rows, launches by kernel in
    ``Trainer.run``)."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs, param_bytes
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import Trainer

    torch.cuda.empty_cache()
    full = get_arch(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    rt = Runtime(attn_impl="flash", remat="none")
    B, S = TRAIN_BATCH
    n_full, n_cut = (sum(math.prod(s.shape) for s in tree_leaves(build_param_specs(c, rt)))
                     for c in (full, cfg))
    print(f"[train] {cfg.name} cut from {full.n_layers} to {cfg.n_layers} layers: at "
          f"{full.n_layers} layers {n_full / 1e9:.2f} B params x (2 bf16 weight + 2 bf16 grad "
          f"+ 8 float32 AdamW moment) bytes = {n_full * 12 / 1e9:.1f} GB, over the card's 80 GB "
          f"before any activation; at {cfg.n_layers}, {n_cut / 1e9:.2f} B x 12 = "
          f"{n_cut * 12 / 1e9:.1f} GB. Widths as published: d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"memory in use before the phase {torch.cuda.memory_allocated()} bytes", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, rt, seq_len=S, global_batch=B, lr=TRAIN_LR, seed=0, device=device)
    torch.cuda.synchronize()
    print(f"[train] {param_bytes(build_param_specs(cfg, rt))} weight bytes ({rt.param_dtype}) and "
          f"{rt.opt_state_dtype} AdamW moments on {device} in {time.perf_counter() - t0:.1f}s; "
          f"batch {B} x {S} from SyntheticTokenPipeline(seed=0), lr {trainer.lr}", flush=True)

    step_s: list = []
    # K5's inputs at layer 0 of the first step (the backward runs the layers
    # in reverse)
    with keep_flash_call(cfg.n_layers - 1, "flash_dq_cuda") as kept:
        counts.reset()
        t0 = time.perf_counter()
        losses = trainer.run(TRAIN_STEPS, log_every=1,
                             on_metrics=lambda step, m: step_s.append(m["s_per_step"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(counts.LAUNCHES)
        plain = dict(counts.PLAIN_CALLS)
    peak = torch.cuda.max_memory_allocated()
    steady = sum(step_s[1:]) / max(len(step_s) - 1, 1)
    print(f"[train] Trainer.run({TRAIN_STEPS}): losses {losses}; wall_s={wall:.6f}; step_s "
          f"{step_s} (the first includes warm-up); steady step_ms={steady * 1e3:.3f} "
          f"tokens_per_s={B * S / steady:.1f}; max_memory_allocated={peak}; launches "
          f"{ {k: launches[k] for k in ('flash_attn_fwd', 'flash_attn_dq', 'flash_attn_dkv')} } "
          f"plain_calls {plain}", flush=True)
    want = cfg.n_layers * TRAIN_STEPS
    for name in ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv"):
        if launches[name] != want or plain[name] != 0:
            fail(f"Trainer.run launched {name} {launches[name]} times (want {want}) and its "
                 f"plain version {plain[name]} times (want 0)")
    ln_v = math.log(cfg.vocab)
    if not all(math.isfinite(x) for x in losses) or abs(losses[0] - ln_v) > LOSS_MARGIN:
        fail(f"losses {losses} are not finite or the first is not within {LOSS_MARGIN} of "
             f"ln({cfg.vocab}) = {ln_v}")

    # three steps on one repeated batch, continuing from the trainer's
    # state; the loss must fall, as in the reference's
    # test_train_step_reduces_loss
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in trainer.pipeline.batch_at(TRAIN_STEPS).items()}
    step = make_train_step(cfg, rt, lr=trainer.lr)
    rep = []
    for _ in range(3):
        trainer.params, trainer.opt, m = step(trainer.params, trainer.opt, batch)
        rep.append(float(m["loss"]))
    print(f"[train] make_train_step x 3 on one repeated batch: losses {rep}", flush=True)
    if not rep[-1] < rep[0]:
        fail(f"the loss does not fall on a repeated batch: {rep}")

    # where a step's time goes
    device_profile(lambda: step(trainer.params, trainer.opt, batch),
                   f"train step {B}x{S}", 2, tag="train")

    # the flash route against the plain xla route, from the same weights and
    # batch; the yardstick is what another batch does to the gradients
    del trainer.opt
    torch.cuda.empty_cache()
    names = [".".join(p) for p in _leaf_paths(trainer.params)]
    other = {k: torch.from_numpy(v).to(device)
             for k, v in trainer.pipeline.batch_at(TRAIN_STEPS + 1).items()}
    loss_x, g_x = grads_of(trainer.params, cfg, dataclasses.replace(rt, attn_impl="xla"), batch)
    loss_f, g_f = grads_of(trainer.params, cfg, rt, batch)
    route = [rel_l2(a, b) for a, b in zip(g_f, g_x)]
    del g_x
    loss_o, g_o = grads_of(trainer.params, cfg, rt, other)
    moved = [rel_l2(a, b) for a, b in zip(g_o, g_f)]
    del g_o, g_f
    print(f"[train] loss_fn flash vs xla: losses {loss_f} / {loss_x} (diff "
          f"{abs(loss_f - loss_x)}, bound {ROUTE_LOSS_TOL}); another batch: loss {loss_o}", flush=True)
    for n, r, mv in zip(names, route, moved):
        print(f"[train]   grad {n}: |g_flash - g_xla| / |g_xla| = {r:.6g}; another batch "
              f"moves it by {mv:.6g}", flush=True)
    bad = [n for n, r, mv in zip(names, route, moved)
           if not (r <= ROUTE_GRAD_TOL and 4 * r <= mv)]
    if abs(loss_f - loss_x) > ROUTE_LOSS_TOL or bad:
        fail(f"flash and xla routes disagree: loss diff {abs(loss_f - loss_x)}, leaves {bad}")

    del trainer, batch, other
    torch.cuda.empty_cache()
    rows = hold_bwd(kept, launches)
    del kept
    bad = check_bwd_small()
    if not all(r["match"] for r in rows) or bad:
        fail(f"K5/K6 disagree with their plain versions: "
             f"{[(r['name'], r['match']) for r in rows]} small={bad}")
    torch.cuda.empty_cache()
    return rows, launches


def _leaf_paths(tree, prefix=()):
    """Key paths of a parameter tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], prefix + (k,))]
    return [prefix]


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
    print(f"[build] {len(logs)} kernels in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, text in logs.items():
        print(f"[build] {name}: nvcc {' '.join(build.NVCC_FLAGS)}", flush=True)
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
    k4_row, k4_launches = run_serve(device)
    launches["flash_attn_fwd"] = k4_launches
    main_rows.append(k4_row)
    bwd_rows, train_launches = run_train(device)
    for name in ("flash_attn_dq", "flash_attn_dkv"):
        launches[name] = train_launches[name]
    main_rows.extend(bwd_rows)
    run_agreement()

    def line(r, n_launches):
        out = {"name": r["name"], "route": "cuda", "source": r["source"],
               "replaces": r["replaces"], "launches": n_launches, "shape": r["shape"],
               "max_abs_err": r["max_abs_err"], "match": r["match"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        if "library" in r:
            out["library"] = r["library"]
        if r["name"] == "flash_attn_fwd" and n_launches is not None:
            out["train_launches"] = train_launches["flash_attn_fwd"]
        return out

    # "kernels": K1-K3 at the largest call of the tuner run, with the run's
    # launch counts; K4 at the serve phase's prefill with its launch count
    # there (and its count in the train phase's Trainer.run beside it); K5
    # and K6 at the train phase's first layer with their counts in
    # Trainer.run; "at_scale": K1 and K2 at 131072 candidates, which the
    # tuner run does not reach (no launch count)
    print(json.dumps({"kernels": [line(r, launches[r["name"]]) for r in main_rows],
                      "at_scale": [line(r, None) for r in scale_rows]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
