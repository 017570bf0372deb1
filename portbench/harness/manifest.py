"""``BENCHMARK.json`` and the files it names, found by name.

A cell (an entry of ``workloads``) names a configuration and a traffic
mix; the configuration is ``portbench/configs/<config>.json``, the mix
``portbench/traffic/<traffic>.json``, the cell's correctness limits
``portbench/limits/<cell>.json`` and each per-layer metric a reader
``portbench/metrics/<metric>.py`` with a function ``read(window)``. The
mix's ``kind`` names the module that drives and judges it,
``portbench/kinds/<kind>.py``; the configuration's ``arch.family`` names
``portbench/families/<family>.py`` (its counters, optional) and
``portbench/families/<family>.<kind>.py`` (the least time of that kind's
work); its ``reference`` names ``portbench/reference/<reference>.py``. A
later cell, configuration, mix, kind, family or metric is new files and
new entries: nothing here changes for it.
"""

from __future__ import annotations

import importlib.util
import json
from dataclasses import dataclass
from pathlib import Path
from typing import Callable, Dict, List, Optional

from .env import BENCH, ROOT


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]       # the metrics this cell reports with --trace 0
    per_layer: List[dict]        # ... and with --trace 1


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def manifest(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def _reports(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def cell(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` with its files; raises
    ``KeyError`` for a name the manifest does not hold."""
    m = manifest(root)
    entry = next((w for w in m["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; known: "
                       f"{[w['name'] for w in m['workloads']]}")
    return cell_of(entry, m, root)


def cell_of(entry: dict, m: dict, root: Path = ROOT) -> Cell:
    """The cell of a ``workloads`` entry (``name``, ``config``, ``traffic``,
    ``chips``) with its files, under the metrics of manifest ``m``."""
    bench = root / "portbench"
    name = entry["name"]
    return Cell(
        name=name,
        chips=int(entry["chips"]),
        config=load_json(bench / "configs" / f"{entry['config']}.json"),
        traffic=load_json(bench / "traffic" / f"{entry['traffic']}.json"),
        limits=load_json(bench / "limits" / f"{name}.json"),
        end_to_end=[x for x in m["end_to_end"] if _reports(x, name)],
        per_layer=[x for x in m["per_layer"] if _reports(x, name)],
    )


def _load(path: Path):
    """The module of the file ``path`` (whose name may hold dots)."""
    if not path.exists():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location("portbench_" + path.stem.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def reader(metric: str, bench: Path = BENCH) -> Callable:
    """``read`` of ``portbench/metrics/<metric>.py``."""
    return _load(bench / "metrics" / f"{metric}.py").read


def kind(name: str):
    """``portbench/kinds/<name>.py``: ``drive(ctx, step_mod)``,
    ``check_numbers(ctx, control)``, ``FAULTS`` and ``fault(name)``."""
    return importlib.import_module(f"portbench.kinds.{name}")


def family(name: str):
    """``portbench/families/<name>.py`` where there is one, else None: an
    ``instrument(ctx)`` context that counts what the family's per-layer
    work needs in a traced window."""
    path = BENCH / "families" / f"{name}.py"
    return importlib.import_module(f"portbench.families.{name}") if path.exists() else None


def family_work(name: str, kind_name: str) -> Callable:
    """``work_of(ctx, counted)`` of ``portbench/families/<name>.<kind>.py``:
    the least time of the window's work of that kind."""
    return _load(BENCH / "families" / f"{name}.{kind_name}.py").work_of


def read_per_layer(metrics: List[dict], window) -> Dict[str, dict]:
    """Each per-layer metric that its reader finds something for, as
    ``{name: {"value", "unit"}}``; a reader that returns None is left out."""
    out: Dict[str, dict] = {}
    for m in metrics:
        value: Optional[float] = reader(m["name"])(window)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out
