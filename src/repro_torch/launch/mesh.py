"""Production mesh construction on torch's ``DeviceMesh``.

Single pod: 16 x 16 = 256 devices, axes ("data", "model").
Multi-pod:  2 x 16 x 16 = 512 devices, axes ("pod", "data", "model"). The
"pod" axis is a second-level data-parallel axis whose collectives cross the
inter-pod links; gradient compression (``distributed/compression.py``)
targets exactly that axis.

A ``DeviceMesh`` stands on a default process group of the mesh's size. The
dry-run has no such cluster, so ``fake_world`` makes one: torch's ``fake``
backend, whose collectives move no data, in one process. One card is the
degenerate 1 x 1 mesh on a real one-rank group (``single_card_mesh``).
A process holds one default group at a time: leave each ``with`` block
before entering the next.
"""

from __future__ import annotations

import contextlib
import socket
from typing import Iterator

import torch
import torch.distributed as dist

__all__ = ["fake_world", "make_mesh_shape", "make_production_mesh", "single_card_mesh"]


def make_mesh_shape(n_devices: int, model: int = 16, multi_pod: bool = False):
    if multi_pod:
        pods = 2
        data = n_devices // (pods * model)
        return (pods, data, model), ("pod", "data", "model")
    data = n_devices // model
    return (data, model), ("data", "model")


@contextlib.contextmanager
def fake_world(world_size: int) -> Iterator[None]:
    """A default process group of ``world_size`` ranks on the ``fake``
    backend (this process is rank 0), destroyed on leaving the block."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    if dist.is_initialized():
        raise RuntimeError("a default process group already exists: destroy it before "
                           "making a fake world")
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False, model: int = 16):
    """The 16 x 16 (or 2 x 16 x 16) mesh on the default process group, which
    must have 256 (512) ranks: ``with fake_world(256): make_production_mesh()``."""
    from torch.distributed.device_mesh import init_device_mesh

    n = 512 if multi_pod else 256
    shape, axes = make_mesh_shape(n, model=model, multi_pod=multi_pod)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != n:
        raise RuntimeError(
            f"need a process group of {n} ranks for the "
            f"{'multi' if multi_pod else 'single'}-pod mesh, have {have}: "
            f"enter launch.mesh.fake_world({n}) first")
    return init_device_mesh("cpu", shape, mesh_dim_names=axes)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@contextlib.contextmanager
def single_card_mesh(device: torch.device) -> Iterator[object]:
    """The degenerate 1 x 1 ("data", "model") mesh on a real one-rank group:
    NCCL for a CUDA device, gloo for the CPU. The group is destroyed on
    leaving the block."""
    from torch.distributed.device_mesh import init_device_mesh

    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if dist.is_initialized():
        raise RuntimeError("a default process group already exists")
    backend = "nccl" if device.type == "cuda" else "gloo"
    kw = {"device_id": device} if device.type == "cuda" else {}
    dist.init_process_group(backend, init_method=f"tcp://localhost:{_free_port()}",
                            rank=0, world_size=1, **kw)
    try:
        yield init_device_mesh(device.type, (1, 1), mesh_dim_names=("data", "model"))
    finally:
        dist.destroy_process_group()
