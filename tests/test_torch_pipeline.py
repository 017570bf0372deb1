"""Pipeline and overlap: the port on gloo process groups against the
reference on forced host devices.

``bubble`` and ``make_mesh_shape`` are arithmetic and must be equal. The
reference's ``pipeline_forward`` and ``ring_allgather_matmul`` need several
JAX devices, and this process's JAX has one, so the reference runs once for
the module in a subprocess with four forced host devices, and the port
once a world size in gloo processes (1, 2 and 4 ranks: one rank is the
degenerate case). Both read the same seeded inputs; the outputs must agree
in float32 within 1e-6 of their scale.
"""
from __future__ import annotations

import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from repro.distributed.pipeline import bubble as ref_bubble
from repro.launch.mesh import make_mesh_shape as ref_make_mesh_shape
from repro_torch.distributed.pipeline import bubble
from repro_torch.launch.mesh import make_mesh_shape

ROOT = Path(__file__).resolve().parents[1]
WORLDS = (1, 2, 4)
M, MB, D = 5, 3, 8          # microbatches, microbatch rows, width
RM, RK, RN = 8, 16, 6       # ring: rows, contraction, columns

REFERENCE = r"""
import sys
import numpy as np
import jax, jax.numpy as jnp
from jax.sharding import Mesh
from repro.distributed.pipeline import pipeline_forward
from repro.distributed.overlap import ring_allgather_matmul

inp = np.load(sys.argv[1])
out = {}
for n in (1, 2, 4):
    mesh = Mesh(np.array(jax.devices()[:n]), ("pipe",))
    params = {"w": jnp.asarray(inp[f"w{n}"]), "b": jnp.asarray(inp[f"b{n}"])}
    fn = lambda p, h: jnp.tanh(h @ p["w"] + p["b"])
    out[f"pipe{n}"] = np.asarray(pipeline_forward(fn, params, jnp.asarray(inp["x"]), mesh))
    ring = Mesh(np.array(jax.devices()[:n]), ("model",))
    out[f"ring{n}"] = np.asarray(ring_allgather_matmul(jnp.asarray(inp["rx"]),
                                                       jnp.asarray(inp["rw"]), ring))
np.savez(sys.argv[2], **out)
"""

WORKER = r"""
import sys
import numpy as np
import torch
import torch.distributed as dist
from repro_torch.distributed.pipeline import pipeline_forward
from repro_torch.distributed.overlap import ring_allgather_matmul

rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
inp = np.load(sys.argv[4])
if world > 1:
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=rank,
                            world_size=world)
try:
    params = {"w": torch.from_numpy(inp[f"w{world}"]), "b": torch.from_numpy(inp[f"b{world}"])}
    fn = lambda p, h: torch.tanh(h @ p["w"] + p["b"])
    pipe = pipeline_forward(fn, params, torch.from_numpy(inp["x"]))
    m, k = inp["rx"].shape[0] // world, inp["rw"].shape[0] // world
    x = torch.from_numpy(inp["rx"][rank * m:(rank + 1) * m])
    w = torch.from_numpy(inp["rw"][rank * k:(rank + 1) * k])
    ring = ring_allgather_matmul(x, w)
finally:
    if world > 1:
        dist.destroy_process_group()
np.savez(sys.argv[5], pipe=pipe.numpy(), ring=ring.numpy())
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, the reference's outputs, the port's outputs by (world, rank))."""
    tmp = tmp_path_factory.mktemp("pipeline")
    rng = np.random.default_rng(0)
    inp = {"x": rng.standard_normal((M, MB, D)).astype(np.float32),
           "rx": rng.standard_normal((RM, RK)).astype(np.float32),
           "rw": rng.standard_normal((RK, RN)).astype(np.float32)}
    for n in WORLDS:
        inp[f"w{n}"] = (rng.standard_normal((n, D, D)) / np.sqrt(D)).astype(np.float32)
        inp[f"b{n}"] = rng.standard_normal((n, D)).astype(np.float32)
    np.savez(tmp / "in.npz", **inp)
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4", OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", REFERENCE, str(tmp / "in.npz"),
                               str(tmp / "ref.npz")], env=env, stderr=subprocess.PIPE)]
    for world in WORLDS:
        port = str(_free_port())
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", WORKER, str(rank), str(world), port,
                 str(tmp / "in.npz"), str(tmp / f"port_{world}_{rank}.npz")],
                env=env, stderr=subprocess.PIPE))
    for p in procs:
        _, err = p.communicate(timeout=120)
        assert p.returncode == 0, err.decode()[-3000:]
    ref = dict(np.load(tmp / "ref.npz"))
    port = {(w, r): dict(np.load(tmp / f"port_{w}_{r}.npz")) for w in WORLDS for r in range(w)}
    return inp, ref, port


def test_bubble_equal():
    for s in range(1, 17):
        for m in range(1, 33):
            assert bubble(s, m) == ref_bubble(s, m)


def test_make_mesh_shape_equal():
    for n in (1, 16, 32, 256, 512, 1024):
        for model in (1, 4, 8, 16):
            for mp in (False, True):
                if mp and n < 2 * model:
                    continue
                assert make_mesh_shape(n, model=model, multi_pod=mp) == \
                    ref_make_mesh_shape(n, model=model, multi_pod=mp)


def _close(got, want):
    scale = max(float(np.abs(want).max()), 1.0)
    assert got.shape == want.shape
    assert float(np.abs(got - want).max()) <= 1e-6 * scale


@pytest.mark.parametrize("world", WORLDS)
def test_pipeline_forward_matches_reference(runs, world):
    _, ref, port = runs
    for rank in range(world):
        _close(port[(world, rank)]["pipe"], ref[f"pipe{world}"])


@pytest.mark.parametrize("world", WORLDS)
def test_ring_allgather_matmul_matches_reference(runs, world):
    _, ref, port = runs
    rows = np.concatenate([port[(world, r)]["ring"] for r in range(world)])
    _close(rows, ref[f"ring{world}"])


def test_outputs_in_microbatch_order(runs):
    """The pipeline's output m is the stages applied to microbatch m."""
    inp, _, port = runs
    for world in WORLDS:
        h = inp["x"].astype(np.float64)
        for s in range(world):
            h = np.tanh(h @ inp[f"w{world}"][s] + inp[f"b{world}"][s])
        _close(port[(world, 0)]["pipe"], h.astype(np.float32))
    ring = inp["rx"].astype(np.float64) @ inp["rw"].astype(np.float64)
    for world in WORLDS:
        got = np.concatenate([port[(world, r)]["ring"] for r in range(world)])
        assert float(np.abs(got - ring).max()) <= 1e-5 * float(np.abs(ring).max())
