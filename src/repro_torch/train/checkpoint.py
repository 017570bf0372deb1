"""Fault-tolerant checkpointing in the reference's on-disk format.

The format is the reference's ``train/checkpoint.py``, so a checkpoint
written by either package restores in the other:

  * one directory ``step_%010d`` per checkpoint, written as ``.tmp`` and
    committed by an atomic rename after the manifest is fsynced;
  * ``manifest.json`` with ``step``, ``extra`` and one entry per leaf: its
    key (the path of dict keys and ``AdamWState`` field names joined by
    ``/``, e.g. ``params/blocks/attn/wq``, ``opt/m/embed``, ``opt/step``),
    file, shape and dtype name;
  * one ``.npy`` per leaf; bfloat16 leaves are saved as raw 2-byte void
    (as numpy saves ``ml_dtypes.bfloat16``) and viewed back by the
    manifest's dtype, here through int16 to ``torch.bfloat16``.

Saves copy every leaf to the host before returning (the port's optimizer
updates its tensors in place), then write in a thread unless asked to
block; one save is in flight at a time; the newest ``keep_k`` are kept.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from ..device import DeviceLike, resolve_device

__all__ = ["CheckpointManager"]

_VOID_BF16 = np.dtype("V2")


def _flatten_with_paths(tree, prefix: str = "") -> List[Tuple[str, Any]]:
    """(key, leaf) in the reference's order: dict keys sorted, named-tuple
    fields in order."""
    if isinstance(tree, dict):
        items = [(str(k), tree[k]) for k in sorted(tree)]
    elif isinstance(tree, tuple) and hasattr(tree, "_fields"):
        items = list(zip(tree._fields, tree))
    else:
        return [(prefix, tree)]
    out: List[Tuple[str, Any]] = []
    for k, v in items:
        out.extend(_flatten_with_paths(v, f"{prefix}/{k}" if prefix else k))
    return out


def _unflatten(template, leaves):
    if isinstance(template, dict):
        return {k: _unflatten(template[k], leaves) for k in sorted(template)}
    if isinstance(template, tuple) and hasattr(template, "_fields"):
        return type(template)(*[_unflatten(v, leaves) for v in template])
    return next(leaves)


def _to_host(t: torch.Tensor) -> Tuple[np.ndarray, str]:
    """A host copy of ``t`` as numpy and its dtype name."""
    t = t.detach().to("cpu", copy=True).contiguous()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_VOID_BF16), "bfloat16"
    a = t.numpy()
    return a, str(a.dtype)


def _from_host(a: np.ndarray, dtype_name: str) -> torch.Tensor:
    if a.dtype.kind == "V":
        if dtype_name != "bfloat16":
            raise ValueError(f"raw {a.dtype} leaf with manifest dtype {dtype_name!r}")
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(a, copy=True))


class CheckpointManager:
    def __init__(self, directory: str, keep_k: int = 3, async_save: bool = True):
        self.dir = directory
        self.keep_k = keep_k
        self.async_save = async_save
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        os.makedirs(directory, exist_ok=True)

    # ------------------------------------------------------------------ save
    def save(self, step: int, state: Dict[str, Any], extra: Optional[Dict[str, Any]] = None,
             block: bool = False) -> None:
        self.wait()  # one in-flight save at a time
        host = [(key, *_to_host(leaf)) for key, leaf in _flatten_with_paths(state)]

        def _write():
            tmp = os.path.join(self.dir, f"step_{step:010d}.tmp")
            final = os.path.join(self.dir, f"step_{step:010d}")
            os.makedirs(tmp, exist_ok=True)
            manifest = {"step": step, "extra": extra or {}, "leaves": []}
            for key, arr, dtype_name in host:
                fn = key.replace("/", "__") + ".npy"
                np.save(os.path.join(tmp, fn), arr)
                manifest["leaves"].append(
                    {"key": key, "file": fn, "shape": list(arr.shape), "dtype": dtype_name})
            with open(os.path.join(tmp, "manifest.json"), "w") as f:
                json.dump(manifest, f)
                f.flush()
                os.fsync(f.fileno())
            if os.path.exists(final):
                shutil.rmtree(final)
            os.replace(tmp, final)  # atomic commit
            self._gc()

        if self.async_save and not block:
            def _run():
                try:
                    _write()
                except Exception as e:  # raised again by the next wait()
                    self._error = e

            self._thread = threading.Thread(target=_run, daemon=True)
            self._thread.start()
        else:
            _write()

    def wait(self) -> None:
        """Join the save in flight; raise what it raised."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("checkpoint save failed") from err

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep_k] if self.keep_k else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:010d}"), ignore_errors=True)

    # --------------------------------------------------------------- restore
    def all_steps(self) -> List[int]:
        out = []
        for d in os.listdir(self.dir):
            if d.startswith("step_") and not d.endswith(".tmp"):
                try:
                    out.append(int(d[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, template: Dict[str, Any], step: Optional[int] = None,
                device: DeviceLike = None) -> Tuple[Dict[str, Any], Dict[str, Any]]:
        """Restore into the structure of ``template`` (leaves in the stored
        dtypes, on ``device``: the card unless ``"cpu"``); returns
        ``(state, extra)``."""
        dev = resolve_device(device)
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints under {self.dir}")
        d = os.path.join(self.dir, f"step_{step:010d}")
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        by_key = {m["key"]: m for m in manifest["leaves"]}
        restored = []
        for key, _ in _flatten_with_paths(template):
            meta = by_key[key]
            arr = np.load(os.path.join(d, meta["file"]))
            restored.append(_from_host(arr, meta["dtype"]).to(dev))
        return _unflatten(template, iter(restored)), manifest["extra"]
