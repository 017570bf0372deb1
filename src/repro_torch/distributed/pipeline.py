"""GPipe-style pipeline parallelism over ``torch.distributed`` point-to-point.

The reference's ``distributed/pipeline.py``, ported. The layer stack is
split into ``stages`` contiguous groups; stage s (the rank s of the pipeline
group) holds its group's parameters. A microbatched forward runs stages in
lockstep: at tick t, stage s processes microbatch (t - s) and sends its
activation to stage s + 1 (a ring send, ``batch_isend_irecv``). The bubble
fraction is (stages - 1) / (microbatches + stages - 1), reported by
``bubble()``.

The ticks, their masking and the final sum over stages are the
reference's, so outputs come out in microbatch order on every rank. Where a
stage is idle at a tick the reference computes on the carried activation
and then discards the result; the port skips that call, which gives the
same values. Collectives go through the group's backend: gloo on the CPU,
NCCL on the card. A pipeline of one stage (no process group, or a group of
one rank) runs the microbatches through ``stage_fn`` in order.
"""

from __future__ import annotations

from typing import Any, Callable

import torch
import torch.distributed as dist

from ..models.params import tree_map

__all__ = ["bubble", "pipeline_forward"]


def bubble(stages: int, microbatches: int) -> float:
    return (stages - 1) / (microbatches + stages - 1)


def _group(mesh, axis: str):
    if mesh is not None:
        return mesh.get_group(axis)
    return dist.group.WORLD if dist.is_initialized() else None


def _ring_shift(h: torch.Tensor, group, rank: int, stages: int) -> torch.Tensor:
    """Send ``h`` to the next stage and receive the previous stage's."""
    nxt, prv = (rank + 1) % stages, (rank - 1) % stages
    out = torch.empty_like(h)
    ops = [dist.P2POp(dist.isend, h.contiguous(), dist.get_global_rank(group, nxt), group),
           dist.P2POp(dist.irecv, out, dist.get_global_rank(group, prv), group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def pipeline_forward(
    stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
    stage_params: Any,           # tree of tensors with a leading (stages, ...) axis
    x: torch.Tensor,             # (microbatches, mb_size, ...) pre-split
    mesh=None,
    axis: str = "pipe",
) -> torch.Tensor:
    """Run x through all stages; returns outputs in microbatch order.

    ``stage_fn(params_slice, h) -> h`` is one stage's computation; stage s
    reads slice s of every leaf of ``stage_params``. ``mesh`` names the
    pipeline group by its ``axis``; without one the default group (or none:
    one stage) is the pipeline.
    """
    group = _group(mesh, axis)
    stages = dist.get_world_size(group) if group is not None else 1
    sidx = dist.get_rank(group) if group is not None else 0
    M = x.shape[0]
    if M < 1:
        raise ValueError("need at least one microbatch")
    params = tree_map(lambda a: a[sidx], stage_params)
    out = torch.zeros_like(x)
    h_in = torch.zeros_like(x[0])
    for t in range(M + stages - 1):
        mb = t - sidx                      # microbatch this stage works on at tick t
        active = 0 <= mb < M
        if active:
            src = x[mb] if sidx == 0 else h_in
            h = stage_fn(params, src)
            if sidx == stages - 1:
                out[mb] = h
        else:
            h = h_in
        h_in = _ring_shift(h, group, sidx, stages) if stages > 1 else h
    if stages > 1:
        # only the last stage holds real outputs; the sum of the masked
        # buffers gives them to every stage
        if sidx != stages - 1:
            out.zero_()
        dist.all_reduce(out, op=dist.ReduceOp.SUM, group=group)
    return out
