"""Which knobs of the jaxwl workload's ``runtime_space()`` move the cost
of its cells on the 16 x 16 mesh, against the set PERF.md documents.

The cost is the port's dry-run (``launch/dryrun.py::run_cell``): a knob
moves it where one of the roofline's three terms (compute, memory,
collective) changes. Run at reduced widths on the real 16 x 16 mesh.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import Path

from repro_torch.configs import ARCHS
from repro_torch.jaxwl import CellWorkload, runtime_space
from repro_torch.launch import dryrun

CELLS = [("llama3-8b", "train_4k"), ("mixtral-8x22b", "decode_32k")]
ROOT = Path(__file__).resolve().parents[1]
SMALL = {"train_4k": ("train", 1024, 16), "decode_32k": ("decode", 1024, 16)}


def _documented() -> set:
    """The knobs PERF.md names on its line "knobs that move the 16 × 16 cost"."""
    names = set(runtime_space().names)
    for line in (ROOT / "PERF.md").read_text().splitlines():
        if "move the 16 × 16 cost" in line:
            return {n for n in re.findall(r"`([a-z_]+)`", line) if n in names}
    raise AssertionError("PERF.md names no knobs that move the 16 × 16 cost")


def test_knobs_that_move_the_16x16_cost(monkeypatch):
    """Each knob flipped from its default, cell by cell as ``CellWorkload``
    hands it to ``run_cell``: a knob moves the cost where one of the
    roofline's three terms changes. The jaxwl cells at reduced widths,
    one layer and 16 x 1024 tokens on the real 16 x 16 mesh."""
    from repro_torch import configs
    from repro_torch.configs import ShapeConfig, reduced

    monkeypatch.setattr(configs, "get_arch",
                        lambda name: dataclasses.replace(reduced(ARCHS[name]), n_layers=1))
    monkeypatch.setattr(configs, "SHAPES", {k: ShapeConfig(k, s, b, kind)
                                            for k, (kind, s, b) in SMALL.items()})
    space = runtime_space()
    wl = CellWorkload(CELLS, cache_path="")
    flips = {"remat": "none", "seq_shard": False, "fsdp": False, "attn_chunk": 512,
             "scan_unroll": 2, "capacity_factor": 2.0, "opt_state_dtype": "bfloat16",
             "act_shard": False}
    assert set(flips) == set(space.names)

    traced = {}

    def terms(cell, cfg):
        ov = wl._overrides(cfg, SMALL[cell[1]][0])
        key = (cell, tuple(sorted(ov.items())))
        if key not in traced:                 # the workload forces some knobs per shape
            r = dryrun.run_cell(cell[0], cell[1], False, ov)
            assert r["status"] == "ok"
            traced[key] = tuple(r["roofline"][k] for k in ("compute_s", "memory_s",
                                                           "collective_s"))
        return traced[key]

    moved = set()
    for cell in CELLS:
        default = terms(cell, space.default())
        moved |= {k for k, v in flips.items()
                  if terms(cell, dict(space.default(), **{k: v})) != default}
    assert moved == {"remat", "seq_shard", "fsdp", "attn_chunk", "opt_state_dtype", "act_shard"}
    assert moved == _documented()

