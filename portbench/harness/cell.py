"""One run of one cell: set-up, the window, the per-layer readings of a
traced window, the check, and the result line.

Set-up builds the cell's CUDA sources into the program's own build
directory (``src/repro_torch/_build/``, inside the checkout, so a cell's
later runs load what its first built), draws the weights from the seed on
the device and warms every shape of the mix once; ``setup_s`` runs from
the process's start to the window's. The traffic kind's module drives the
window; the check runs after it, after the peak memory has been read and
the program's state freed.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import json
import typing
from typing import Dict, Optional

import torch

from . import check, drive, manifest, trace, work
from .env import forbidden_modules
from .manifest import Cell, read_per_layer


def _arch(cfg: dict):
    """The port's ``ArchConfig`` of the configuration's ``arch``, each
    nested group built as the dataclass its field names."""
    from repro_torch.configs.base import ArchConfig

    hints = typing.get_type_hints(ArchConfig)
    a = dict(cfg["arch"])
    for k, v in a.items():
        if isinstance(v, dict):
            cls = next(t for t in typing.get_args(hints[k]) + (hints[k],)
                       if dataclasses.is_dataclass(t))
            a[k] = cls(**v)
    return ArchConfig(**a)


class Window:
    """What a per-layer reader reads: the traced window's length and device
    time (``reduced``), the least time of the work done (``work``, by
    quantity) and the steps."""

    def __init__(self, seconds: float, reduced, wk: work.Work):
        self.seconds = seconds
        self.reduced = reduced
        self.work = wk
        self.steps = wk.steps

    def class_s(self, *classes: str) -> float:
        return sum(self.reduced.class_s.get(c, 0.0) for c in classes)

    def roofline(self, key: str, *classes: str) -> Optional[float]:
        """100 x the work's least time over the kernel time of ``classes``;
        None where either is nothing."""
        least, spent = self.work.least.get(key, 0.0), self.class_s(*classes)
        if least <= 0 or spent <= 0:
            return None
        return 100.0 * least / spent

    def mfu(self) -> Optional[float]:
        least = self.work.least.get("model", 0.0)
        return 100.0 * least / self.seconds if least > 0 else None

    def idle(self) -> float:
        return 100.0 * (1.0 - self.reduced.busy_s / self.reduced.window_s)

    def ms_per_step(self, *classes: str) -> Optional[float]:
        spent = self.class_s(*classes)
        return 1e3 * spent / self.steps if self.steps and spent > 0 else None


def run(cell: Cell, seed: int, seconds: float, traced: bool, device: torch.device,
        t0: float, control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object with the
    numbers compared under ``"checks"``. ``t0``: the process's start on the
    wall clock."""
    import repro_torch.train.step as step_mod
    from repro_torch.kernels import build, counts
    from repro_torch.models import Runtime, build_param_specs

    from .weights import draw

    cfg = cell.config
    kind = manifest.kind(cell.traffic["kind"])
    family = cfg["arch"]["family"]
    fam = manifest.family(family)
    if device.type == "cuda":
        build.build_all(tuple(cfg["sources"]))
    arch = _arch(cfg)
    rt = Runtime(**cfg["runtime"])
    params = draw(build_param_specs(arch, rt), seed, device, cfg.get("init"))
    ctx = drive.Ctx(cell, arch, rt, params, seed, seconds, traced, device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    counts.reset()
    counting = fam.instrument(ctx) if traced and fam is not None else contextlib.nullcontext()
    with counting as counter:
        kind.drive(ctx, step_mod)
    setup_s = ctx.window_start - t0
    launches = counts.snapshot()
    result: Dict = {"correct": False, "attempted": ctx.attempted, "failed": 0, "metrics": {}}
    dev: Dict = {"platform": "gpu" if device.type == "cuda" else device.type,
                 "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                 "count": 1,
                 "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))
                 if device.type == "cuda" else 0}
    if traced:
        reduced = (trace.reduce(ctx.window, ctx.spans, ctx.window_s)
                   if ctx.window is not None else None)
        ctx.window = None
        if reduced is not None:
            if counter is not None:
                print(f"[portbench] {counter.report()}", flush=True)
            counted = counter.per_call() if counter is not None else []
            wk = manifest.family_work(family, cell.traffic["kind"])(ctx, counted)
            result["metrics"] = read_per_layer(cell.per_layer, Window(ctx.window_s, reduced, wk))
            print("[portbench] device seconds by class "
                  + json.dumps({k: round(v, 6) for k, v in sorted(
                      reduced.class_s.items(), key=lambda kv: -kv[1])}), flush=True)
            dev["busy_s"] = reduced.busy_s
            dev["window_s"] = reduced.window_s
            result["breakdown"] = reduced.breakdown()
        print(f"[portbench] launches {launches['launches']} routes {launches['route_launches']} "
              f"plain {dict((k, v) for k, v in launches['plain_calls'].items() if v)}", flush=True)
    else:
        for m in cell.end_to_end:
            value = setup_s if m["name"] == "setup_s" else ctx.e2e.get(m["name"])
            if value is not None:
                result["metrics"][m["name"]] = {"value": float(value), "unit": m["unit"]}
    result["device"] = dev
    # the program's state goes before the reference runs; the reference
    # reads only the weights the benchmark drew (``ctx.params``)
    del params
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    got, ctl = check.numbers(ctx, kind, control=control)
    result["numbers"] = got
    if ctl is not None:
        result["control"] = ctl
    checks = {}
    ok = got is not None
    for name, lim in cell.limits["numbers"].items():
        value = None if got is None else got.get(name)
        checks[name] = {"value": value, "limit": lim["limit"]}
        if value is None or not value <= lim["limit"]:
            ok = False
    result["correct"] = ok
    found = forbidden_modules()
    if found:
        raise RuntimeError(f"modules of JAX or of the JAX package were loaded: {found}")
    result["checks"] = checks
    return result
