"""Compute/communication overlap: ring collective-matmul.

The reference's ``distributed/overlap.py``, ported to ``torch.distributed``.
``ring_allgather_matmul`` computes x @ w_full where the rows of w are
sharded over a group, without first gathering w. Each of the n steps
multiplies the shard it holds while the next one is sent around the ring
(``batch_isend_irecv``, started before the product and waited for after
it), so the transfer of step i + 1 hides behind the product of step i. On
one rank there is nothing to send.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

__all__ = ["ring_allgather_matmul"]


def ring_allgather_matmul(x: torch.Tensor, w: torch.Tensor, mesh=None,
                          axis: str = "model") -> torch.Tensor:
    """x: this rank's (m, K_total) rows; w: this rank's (K_total / n, N) rows
    of the weights. Returns this rank's (m, N) rows of x @ w_full, summed in
    float32 in the reference's order and cast to x's dtype."""
    if mesh is not None:
        group = mesh.get_group(axis)
    else:
        group = dist.group.WORLD if dist.is_initialized() else None
    n = dist.get_world_size(group) if group is not None else 1
    idx = dist.get_rank(group) if group is not None else 0
    k_shard = w.shape[0]
    acc = torch.zeros((x.shape[0], w.shape[1]), dtype=torch.float32, device=x.device)
    w_cur = w.contiguous()
    nxt = dist.get_global_rank(group, (idx + 1) % n) if n > 1 else None
    prv = dist.get_global_rank(group, (idx - 1) % n) if n > 1 else None
    for i in range(n):
        reqs, w_next = [], None
        if n > 1 and i < n - 1:
            # pass our w shard along the ring while this step's product runs
            w_next = torch.empty_like(w_cur)
            reqs = dist.batch_isend_irecv([dist.P2POp(dist.isend, w_cur, nxt, group),
                                           dist.P2POp(dist.irecv, w_next, prv, group)])
        # after i ring hops the shard we hold originated at (idx - i): it
        # covers K rows [src * k_shard, (src + 1) * k_shard)
        src = (idx - i) % n
        part = x[:, src * k_shard:(src + 1) * k_shard]
        acc = acc + part.float() @ w_cur.float()
        for r in reqs:
            r.wait()
        if w_next is not None:
            w_cur = w_next
    return acc.to(x.dtype)
