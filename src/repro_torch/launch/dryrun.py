"""Multi-pod dry-run: trace every (arch x shape) cell's step on fake tensors
on the production mesh and rate it against one device's roofline.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.dryrun --arch llama3-8b --shape train_4k
  PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes --out results/dryrun.json
  ... add --multi-pod for the 2x16x16 (512-device) mesh, --jobs N to trace
  N cells at once (one process each).

The reference lowers and compiles each cell with XLA on 512 forced host
devices and reads the compiled program. The port has no compiler to ask:
it builds the mesh on a fake process group (``launch/mesh.py``), places
parameters, optimizer state, inputs and caches by the rules of
``distributed/sharding.py``, runs the step once under ``FakeTensorMode``
and counts it with ``tools/step_cost.py``. The step is traced with one of each
repeating body (a layer; a hybrid group; the enc-dec family's encoder and
decoder layers counted apart) and with two, and extrapolated to the full
depth, as the reference's walker multiplies a while loop's body by its
trip count (``trip_counts``, ``n_while``: the bodies). ``lower_s`` is the
time to build and place the abstract trees, ``compile_s`` the traces'.
``memory`` holds per-device bytes: arguments from their placements,
temporaries from the traces' peak of live storages; nothing is compiled,
so ``generated_code_bytes`` is 0. The roofline's step time is a model evaluated against the
H100 SXM data sheet (``tools/roofline.py``), not a measurement.

Every cell writes incrementally to the output JSON so a long sweep can be
monitored and resumed (--resume skips cells already present).
"""

from __future__ import annotations

import argparse
import json
import os
import time
import traceback
from typing import Any, Dict, Optional, Tuple

import torch

__all__ = ["cell_costs", "depth_units", "run_cell", "main"]


def _leaf_bytes(t: torch.Tensor) -> float:
    return float(t.numel() * t.element_size())


def depth_units(cfg) -> Dict[str, int]:
    """The repeating bodies of ``cfg`` and their counts. A step's costs are
    linear in each count, as the reference's walker multiplies a while
    loop's body by its trip count: layers (after DeepSeek's leading dense
    ones), the hybrid family's Mamba2 layers and its shared-block groups,
    the enc-dec family's decoder and encoder layers."""
    if cfg.family == "hybrid":
        return {"layers": cfg.n_layers, "groups": cfg.n_layers // (cfg.attn_every or cfg.n_layers)}
    if cfg.family == "encdec":
        return {"layers": cfg.n_layers, "enc_layers": cfg.n_encoder_layers}
    nd = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    return {"layers": cfg.n_layers - nd}


def _at_depth(cfg, counts: Dict[str, int]):
    """``cfg`` with the repeating bodies of ``counts``."""
    from dataclasses import replace

    if cfg.family == "hybrid":
        return replace(cfg, n_layers=counts["layers"],
                       attn_every=counts["layers"] // counts["groups"])
    if cfg.family == "encdec":
        return replace(cfg, n_layers=counts["layers"], n_encoder_layers=counts["enc_layers"])
    nd = cfg.moe.first_dense_layers if cfg.moe is not None else 0
    return replace(cfg, n_layers=nd + counts["layers"])


def _placements(cfg, shape, rt, mesh):
    """Every step argument of the cell on ``meta`` with its sharding:
    (params, opt moments, batch, cache, tokens) as lists of (tensor,
    NamedSharding), the parameter shardings in leaf order, and the batch's
    spec."""
    from ..distributed.sharding import (NamedSharding, assign_pspec, batch_axes, cache_axes,
                                        cache_rules, dp_size, make_param_rules,
                                        shardings_for_specs)
    from ..models import abstract_params, build_param_specs
    from ..models.params import tree_leaves
    from ..models.runtime import torch_dtype
    from ..optim import adamw_init_abstract
    from ..train import input_specs

    specs = build_param_specs(cfg, rt)
    p_sh = tree_leaves(shardings_for_specs(specs, mesh, make_param_rules(rt, mesh)))
    params = abstract_params(specs)
    dp = batch_axes(mesh)
    dp_total = dp_size(rt, mesh)
    batch_ok = shape.global_batch % dp_total == 0 and shape.global_batch >= dp_total
    dp_spec = (dp if len(dp) > 1 else dp[0],) if dp and batch_ok else ()
    ins = input_specs(cfg, shape, rt)
    out = {"params": list(zip(tree_leaves(params), p_sh)), "moments": [], "batch": {},
           "cache": {}, "tokens": None}
    if shape.kind == "train":
        opt = adamw_init_abstract(params, dtype=torch_dtype(rt.opt_state_dtype))
        out["moments"] = [(t, sh) for moments in (opt.m, opt.v)
                          for t, sh in zip(tree_leaves(moments), p_sh)]
    for k, v in ins.get("batch", {}).items():
        whole = v.ndim >= 2 and v.shape[0] == shape.global_batch
        out["batch"][k] = (v, NamedSharding(mesh, dp_spec if whole else ()))
    if shape.kind == "decode":
        crules = cache_rules(rt, mesh, batch_shardable=batch_ok)
        caxes = cache_axes(cfg, ins["cache"])
        out["cache"] = {k: (v, NamedSharding(mesh, assign_pspec(v.shape, caxes[k], mesh, crules)))
                        for k, v in ins["cache"].items()}
        out["tokens"] = (ins["tokens"], NamedSharding(mesh, dp_spec))
    return out


def _trace(cfg, shape, rt, mesh):
    """One step of ``cfg`` traced on fake tensors under ``StepCostMode``:
    (StepCosts, the per-device bytes of its results)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from ..distributed.sharding import use_mesh
    from ..models import build_param_specs
    from ..models.params import tree_map
    from ..optim import AdamWState, adamw_update
    from ..tools.step_cost import StepCostMode
    from ..train import make_decode_step, make_prefill_step
    from ..train.step import loss_and_grads

    pl = _placements(cfg, shape, rt, mesh)
    mode = StepCostMode(mesh, fsdp=rt.fsdp)
    with FakeTensorMode(allow_non_fake_inputs=True):
        def fake(pair, param=False):
            t = torch.zeros(pair[0].shape, dtype=pair[0].dtype)
            mode.place(t, pair[1], param=param)
            return t

        leaves = [fake(pr, param=True) for pr in pl["params"]]
        it = iter(leaves)
        params = tree_map(lambda _: next(it), build_param_specs(cfg, rt))
        batch = {k: fake(pr) for k, pr in pl["batch"].items()}
        if shape.kind == "train":
            moments = [fake(pr) for pr in pl["moments"]]
            n = len(leaves)
            mi, vi = iter(moments[:n]), iter(moments[n:])
            opt = AdamWState(torch.zeros((), dtype=torch.int32),
                             tree_map(lambda _: next(mi), params),
                             tree_map(lambda _: next(vi), params))

            def step_fn():
                _, grads = loss_and_grads(params, cfg, rt, batch)
                mode.gathered = False        # the update runs on each device's shard
                adamw_update(params, grads, opt)
                return ()
        elif shape.kind == "prefill":
            prefill = make_prefill_step(cfg, rt)

            def step_fn():
                return (prefill(params, batch),)
        else:
            cache = {k: fake(pr) for k, pr in pl["cache"].items()}
            tokens = fake(pl["tokens"])
            decode = make_decode_step(cfg, rt)

            def step_fn():
                return (decode(params, cache, tokens)[0],)

        with use_mesh(mesh, on_place=mode.on_place), mode:
            outs = step_fn()
        mode.gathered = True
        mode.param_gathers(leaves, times=2 if shape.kind == "train" else 1)
        out_bytes = sum(mode.per_device(o) for o in outs)
    return mode.costs, out_bytes


def _combine(base, steps):
    """base + sum over ``steps`` of (count - 1) * (its trace - the trace
    before it): the linear extrapolation of the chain of traces."""
    from ..tools.step_cost import StepCosts

    out = StepCosts()
    names = ("flops", "bytes", "collective_bytes", "global_flops", "global_unique_flops",
             "global_bytes", "n_ops")
    kinds = set(base.collectives).union(*(c.collectives for _, c in steps))
    prev = base
    for name in names:
        setattr(out, name, getattr(base, name))
    for kind in kinds:
        out.collectives[kind] = base.collectives.get(kind, 0.0)
    for k, c in steps:
        for name in names:
            setattr(out, name, getattr(out, name) + (k - 1) * (getattr(c, name) - getattr(prev, name)))
        for kind in kinds:
            out.collectives[kind] += (k - 1) * (c.collectives.get(kind, 0.0)
                                                - prev.collectives.get(kind, 0.0))
        prev = c
    out.n_ops = int(out.n_ops)
    return out


def cell_costs(cfg, shape, rt, mesh) -> Tuple[Any, Dict[str, float], Dict[str, Any]]:
    """The per-device costs of one step of ``cfg`` at ``shape`` under ``rt``
    on ``mesh``: (StepCosts, memory bytes per device, trace record). The step
    is traced with one of each repeating body (``depth_units``) and with two
    of each in turn; the full depth's costs are extrapolated linearly, which
    is exact for the products, bytes, collectives and ops. A train step's
    peak of temporaries grows by what a body saves; a forward step keeps
    next to nothing from body to body, so its peak is the largest trace's."""
    t0 = time.perf_counter()
    pl = _placements(cfg, shape, rt, mesh)

    def per_device(pairs):
        return sum(_leaf_bytes(t) / sh.num_shards for t, sh in pairs)

    cache = list(pl["cache"].values())
    args = per_device(pl["params"] + pl["moments"] + list(pl["batch"].values()) + cache
                      + ([pl["tokens"]] if pl["tokens"] is not None else []))
    alias = per_device(pl["params"] + pl["moments"] if shape.kind == "train" else cache)
    t_setup = time.perf_counter() - t0

    t0 = time.perf_counter()
    units = depth_units(cfg)
    counts = {u: 1 for u in units}
    base, out_bytes = _trace(_at_depth(cfg, counts), shape, rt, mesh)
    steps = []
    for u, n in units.items():
        if n > 1:
            counts[u] = 2
            steps.append((n, _trace(_at_depth(cfg, counts), shape, rt, mesh)[0]))
    costs = _combine(base, steps)
    peaks = [base.temp_bytes] + [c.temp_bytes for _, c in steps]
    if shape.kind == "train":
        # what a body saves for the backward adds up; a body that lowers the
        # peak (another transient ruling it) adds nothing
        costs.temp_bytes = base.temp_bytes + sum(
            (k - 1) * max(c.temp_bytes - prev, 0.0)
            for (k, c), prev in zip(steps, peaks))
    else:
        # a forward keeps next to nothing from body to body: its peak is
        # about one body's
        costs.temp_bytes = max(peaks)
    costs.notes = [f"the plain route traced on fake tensors with 1 and 2 of {sorted(units)}, "
                   f"extrapolated to {units}",
                   "collective bytes from the placements' rules (tools/step_cost.py)"]
    memory = {"argument_bytes": args, "output_bytes": out_bytes + alias,
              "temp_bytes": costs.temp_bytes, "alias_bytes": alias}
    return costs, memory, {"setup_s": t_setup, "step_s": time.perf_counter() - t0,
                           "trip_counts": units}


def run_cell(arch_name: str, shape_name: str, multi_pod: bool,
             runtime_overrides: Optional[Dict[str, Any]] = None) -> Dict[str, Any]:
    from ..configs import SHAPES, get_arch, shape_applicable
    from ..models import Runtime
    from ..tools import H100, model_flops, roofline_terms
    from .mesh import fake_world, make_production_mesh

    cfg = get_arch(arch_name)
    shape = SHAPES[shape_name]
    ok, reason = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch_name, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skipped", "reason": reason}

    rt_kw: Dict[str, Any] = dict(
        remat="full" if shape.kind == "train" else "none",
        scan_layers=True,
        attn_chunk=2048 if shape.seq_len >= 32768 else 1024,
        # sequence-parallel residual stream: divides the saved activations
        # by the model-axis size
        seq_shard=shape.kind == "train",
    )
    if runtime_overrides:
        rt_kw.update(runtime_overrides)
    rt = Runtime(**rt_kw)

    with fake_world(512 if multi_pod else 256):
        mesh = make_production_mesh(multi_pod=multi_pod)
        chips = mesh.size()
        mesh_name = "x".join(str(s) for s in mesh.shape)
        costs, mem, secs = cell_costs(cfg, shape, rt, mesh)

    mf = model_flops(cfg, shape)
    report = roofline_terms(arch_name, shape_name, mesh_name, chips, costs, mf,
                            raw_flops=costs.global_flops, raw_bytes=costs.global_bytes,
                            chip=H100)
    gb = 2 ** 30
    return {
        "arch": arch_name, "shape": shape_name, "multi_pod": multi_pod,
        "mesh": mesh_name, "chips": chips, "status": "ok",
        "lower_s": round(secs["setup_s"], 2), "compile_s": round(secs["step_s"], 2),
        "memory": {
            "argument_bytes": int(mem["argument_bytes"]),
            "output_bytes": int(mem["output_bytes"]),
            "temp_bytes": int(mem["temp_bytes"]),
            "alias_bytes": int(mem["alias_bytes"]),
            "generated_code_bytes": 0,
            "temp_gb_per_device": round(mem["temp_bytes"] / gb, 3),
            "args_gb_per_device": round(mem["argument_bytes"] / gb, 3),
        },
        "roofline": report.to_json(),
        "chip": {"name": H100.name, "source": "data sheet (a model, not a measurement)"},
        "hlo_notes": costs.notes[:5],
        "n_while": len(secs["trip_counts"]),
        "trip_counts": secs["trip_counts"],
        "n_ops": costs.n_ops,
        "runtime": rt_kw,
    }


def _run_safe(arch: str, shape: str, multi_pod: bool,
              overrides: Optional[Dict[str, Any]]) -> Dict[str, Any]:
    try:
        return run_cell(arch, shape, multi_pod, overrides)
    except Exception as e:
        return {"arch": arch, "shape": shape, "multi_pod": multi_pod,
                "status": "error", "error": f"{type(e).__name__}: {e}",
                "traceback": traceback.format_exc()[-2000:]}


def _report(r: Dict[str, Any]) -> None:
    label = f"{r['arch']} x {r['shape']} ({'512' if r['multi_pod'] else '256'} chips)"
    print(f"=== {label}", flush=True)
    if r["status"] == "ok":
        rl = r["roofline"]
        print(f"    ok  trace={r['compile_s']}s temp/dev={r['memory']['temp_gb_per_device']}GB "
              f"args/dev={r['memory']['args_gb_per_device']}GB "
              f"bottleneck={rl['bottleneck']} step={rl['step_time_s']:.4f}s (H100 model) "
              f"useful={rl['useful_ratio']:.3f} "
              f"roofline_frac={rl['roofline_fraction']:.3f}", flush=True)
    else:
        print(f"    {r['status']}: {r.get('reason') or r.get('error')}", flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", type=str, default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--runtime", type=str, default=None, help="JSON runtime overrides")
    ap.add_argument("--jobs", type=int, default=1,
                    help="cells traced at once, each in a process of its own")
    args = ap.parse_args()

    from ..configs import all_cells

    overrides = json.loads(args.runtime) if args.runtime else None
    cells = all_cells() if args.all else [(args.arch, args.shape)]
    meshes = [False, True] if args.both_meshes else [args.multi_pod]

    results = []
    done = set()
    if args.out and args.resume and os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
        done = {(r["arch"], r["shape"], r["multi_pod"]) for r in results}
    todo = [(a, s, mp) for a, s in cells for mp in meshes if (a, s, mp) not in done]

    def record(r: Dict[str, Any]) -> None:
        _report(r)
        results.append(r)
        if args.out:
            os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
            with open(args.out + ".tmp", "w") as f:
                json.dump(results, f, indent=1)
            os.replace(args.out + ".tmp", args.out)

    t_sweep = time.perf_counter()
    if args.jobs > 1:
        import multiprocessing
        from concurrent.futures import ProcessPoolExecutor, as_completed

        with ProcessPoolExecutor(args.jobs,
                                 mp_context=multiprocessing.get_context("spawn")) as pool:
            futures = [pool.submit(_run_safe, a, s, mp, overrides) for a, s, mp in todo]
            for fut in as_completed(futures):
                record(fut.result())
    else:
        for a, s, mp in todo:
            record(_run_safe(a, s, mp, overrides))
    n_ok = sum(1 for r in results if r["status"] == "ok")
    n_skip = sum(1 for r in results if r["status"] == "skipped")
    n_err = sum(1 for r in results if r["status"] == "error")
    print(f"=== done: {n_ok} ok, {n_skip} skipped, {n_err} errors in "
          f"{time.perf_counter() - t_sweep:.1f}s", flush=True)
    if n_err:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
