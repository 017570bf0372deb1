"""Whole runs at a tiny size on the CPU, past the harness's look for a
chip: ``correct`` holds for the program as it is, and comes out false with
each fault that a cell's traffic kind can have planted under its timed
path (``portbench/kinds/<kind>.py``): a token altered where it is
produced, and half of the batch left out where a request holds more than
one prompt. (A prefill returns no state to leave unchanged, and one chip
has no exchange between chips to leave out.) The program runs in float32
here, where it agrees with the reference to round-off, against each
cell's own limits. Then the control: the fp8 reference reads more than the
bf16 program on every cell's compared numbers."""

import pytest
import torch

from portbench.harness import manifest
from portbench.harness.cell import run

CPU = torch.device("cpu")
CELLS = [w["name"] for w in manifest.manifest()["workloads"]]


def _faults(name):
    tr = manifest.cell(name).traffic
    return [f for f in manifest.kind(tr["kind"]).FAULTS
            if f != "half_batch" or tr.get("batch_tokens")]


WINDOW = 3.0    # seconds: long enough, under a loaded CPU, to finish the requests the check keeps


def _run(cell, seed=12345678901):
    return run(cell, seed, WINDOW, False, CPU, 0.0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_runs_are_correct(tiny_cell, name):
    cell = tiny_cell(name, "float32")
    r = _run(cell)
    assert r["correct"], (r["checks"], r["attempted"])
    assert list(r)[-1] == "checks"
    assert r["attempted"] % sum(cell.traffic["counts"]) == 0      # whole blocks of lengths


@pytest.mark.parametrize("name,fault", [(n, f) for n in CELLS for f in _faults(n)])
def test_each_fault_fails_the_check(tiny_cell, name, fault):
    cell = tiny_cell(name, "float32")
    with manifest.kind(cell.traffic["kind"]).fault(fault):
        r = _run(cell)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_the_control_reads_more_than_the_program(tiny_cell, name):
    r = run(tiny_cell(name, "bfloat16"), 24681357913, WINDOW, False, CPU, 0.0, control=True)
    prog, ctl = r["numbers"], r["control"]
    assert any(ctl[k] > 3 * prog[k] for k in r["checks"]), (prog, ctl)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CELLS)
def test_on_the_card_the_limit_lies_between_program_and_control(cuda_device, name):
    """At the cell's own size: the program passes each limit, the fp8
    control fails one (about a minute a cell, with the build)."""
    r = run(manifest.cell(name), 97531864200, 6.0, False, cuda_device, 0.0, control=True)
    assert r["correct"], (r["checks"], r["attempted"])
    assert any(r["control"][k] > c["limit"] for k, c in r["checks"].items()), r["control"]
