"""Carry fitted state across from the reference package.

The reference and the port share their data formats: a packed forest is
the same struct-of-arrays arena, and a knowledge base is the same JSON.
These helpers take the reference's objects as plain numpy arrays and JSON
(never by importing it) and build the port's counterparts, so one fitted
forest or one knowledge base can be fed to both packages.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Union

from .core.knowledge import KnowledgeBase, TaskRecord
from .core.surrogate import PackedForest
from .device import DeviceLike

__all__ = ["packed_forest_from_numpy", "knowledge_base_from_json"]

_ARENA_FIELDS = ("feat", "thr", "child", "mean", "var", "roots", "depth", "y_mean", "y_std")


def packed_forest_from_numpy(d: Union[Mapping[str, Any], Any],
                             device: DeviceLike = None) -> PackedForest:
    """The port's ``PackedForest`` on ``device`` from a reference arena.

    ``d`` is a mapping with the fields ``feat, thr, child, mean, var,
    roots, depth, y_mean, y_std`` (numpy arrays and scalars), or any object
    carrying them as attributes (a reference ``PackedForest``).
    """
    get = d.__getitem__ if isinstance(d, Mapping) else lambda k: getattr(d, k)
    f = {k: get(k) for k in _ARENA_FIELDS}
    return PackedForest.from_arrays(
        f["feat"], f["thr"], f["child"], f["mean"], f["var"], f["roots"],
        f["depth"], f["y_mean"], f["y_std"], device=device,
    )


def knowledge_base_from_json(src: Union[str, os.PathLike, Mapping[str, Any]]) -> KnowledgeBase:
    """An in-memory ``KnowledgeBase`` from the reference's KB JSON.

    ``src`` is a KB directory (one ``<task_id>.json`` per task, as the
    reference persists it), one task's JSON file, one task's JSON dict
    (``TaskRecord.to_json``), or a mapping ``task_id -> task dict``.
    """
    if isinstance(src, (str, os.PathLike)):
        if os.path.isdir(src):
            disk = KnowledgeBase(os.fspath(src))
            kb = KnowledgeBase()
            for rec in disk.tasks.values():
                kb.add_task(rec, persist=False)
            return kb
        with open(src) as f:
            src = json.load(f)
    records = [src] if "task_id" in src else list(src.values())
    kb = KnowledgeBase()
    for d in records:
        kb.add_task(TaskRecord.from_json(d), persist=False)
    return kb
