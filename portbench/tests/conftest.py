"""Tests of the port's benchmark. They run on the CPU at tiny sizes; those
that need the card carry the ``gpu`` marker and skip without one.

    python -m pytest portbench/tests
"""

import copy
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

# each configuration's family at a size a CPU test holds: widths cut, the
# structure (GQA, experts top-2 with capacity) kept
TINY_ARCH = {
    "mixtral-8x22b-8l": {"n_layers": 2, "d_model": 64, "n_heads": 4, "n_kv_heads": 2, "d_ff": 128,
                         "vocab": 256,
                         "moe": {"n_experts": 4, "top_k": 2, "n_shared": 0, "d_ff_expert": 96,
                                 "capacity_factor": 1.25}},
}


def _tiny_cell(name: str, dtype: str = "bfloat16", window=None):
    """The cell ``name`` of BENCHMARK.json cut to a CPU test's size, its
    program in ``dtype`` (and attention in a ``window``, where given)."""
    from portbench.harness import manifest

    c = manifest.cell(name)
    c.config = copy.deepcopy(c.config)
    c.config["arch"].update(TINY_ARCH[c.config["name"]], window=window)
    c.config["runtime"] = dict(c.config["runtime"], param_dtype=dtype, compute_dtype=dtype)
    t = c.traffic = copy.deepcopy(c.traffic)
    if t["batch_tokens"]:
        t["lengths"], t["batch_tokens"] = [16, 32, 64], 128
    else:
        t["lengths"] = [16, 32, 48, 64, 96]
    # blocks of one request a length, so that the requests the check keeps
    # come early in a short window on a loaded CPU
    t["counts"] = [1] * len(t["lengths"])
    t["token_pool"] = 4096
    return c


@pytest.fixture
def cuda_device():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.fixture
def tiny_cell():
    """``tiny_cell(name, dtype="bfloat16")``: a cell at a CPU test's size."""
    return _tiny_cell


@pytest.fixture(autouse=True, scope="session")
def _one_cpu_thread():
    """One intra-op thread: the tiny runs are latency-bound, and several test
    workers on one host would otherwise oversubscribe its cores and stretch
    the time-boxed windows."""
    import torch

    saved = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(saved)
