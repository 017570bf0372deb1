"""Carry fitted state across from the reference package.

The reference and the port share their data formats: a packed forest is
the same struct-of-arrays arena, and a knowledge base is the same JSON.
These helpers take the reference's objects as plain numpy arrays and JSON
(never by importing it) and build the port's counterparts, so one fitted
forest, one knowledge base, one set of LM weights or one AdamW state can
be fed to both packages.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping, Union

import numpy as np
import torch

from .core.knowledge import KnowledgeBase, TaskRecord
from .core.surrogate import PackedForest
from .device import DeviceLike, resolve_device
from .optim import AdamWState

__all__ = [
    "adamw_state_from_numpy", "knowledge_base_from_json", "lm_params_from_numpy",
    "packed_forest_from_numpy",
]

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


def _tensor_from_numpy(a: Any) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes' bfloat16: carry the bits
        bits = np.ascontiguousarray(a).view(np.int16)
        return torch.from_numpy(bits.copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


def lm_params_from_numpy(tree: Mapping[str, Any], device: DeviceLike = None) -> dict:
    """The port's LM parameter tree on ``device`` from the reference's.

    ``tree`` is the reference's parameter pytree as nested dicts with numpy
    arrays at the leaves (``jax.tree.map(np.asarray, params)``); bfloat16
    leaves keep their bits. The result has the same keys and shapes.
    """
    dev = resolve_device(device)

    def one(x):
        if isinstance(x, Mapping):
            return {k: one(v) for k, v in x.items()}
        return _tensor_from_numpy(x).to(dev)

    return one(tree)


def adamw_state_from_numpy(step: Any, m: Mapping[str, Any], v: Mapping[str, Any],
                           device: DeviceLike = None) -> AdamWState:
    """The port's ``AdamWState`` on ``device`` from the reference's: its
    ``step`` (a scalar) and moment trees ``m`` and ``v`` as nested dicts of
    numpy arrays (``jax.tree.map(np.asarray, opt)``), converted as
    :func:`lm_params_from_numpy` converts parameters."""
    dev = resolve_device(device)
    step_t = torch.tensor(int(np.asarray(step)), dtype=torch.int32, device=dev)
    return AdamWState(step_t, lm_params_from_numpy(m, dev), lm_params_from_numpy(v, dev))
