"""Mixture-of-Experts layer: top-k routing with capacity-based dispatch.

The reference's ``models/moe.py``, ported. Expert weights are stacked
(E, D, F); tokens are routed in float32 (router product, softmax, top-k,
gates renormalised), assigned per batch row to capacity slots by a
cumulative count (an overflow slot ``Cr`` takes what does not fit and is
thrown away), dispatched into a (B, E, Cr+1, D) buffer, multiplied by the
three expert products as (E, B*Cr, D) grouped matmuls, and combined back
with the gate weights. Shared experts run densely.

The expert products go through ``kernels.moe_gmm.ops.grouped_matmul``:
kernel K9 on the card, its plain version on the CPU. The (E, B*Cr, D)
input is B blocks of Cr rows per expert, each filled only in part, so
K9 gets no ``group_sizes``: an empty slot is a row of zeros and gives a row
of zeros, as in the reference's einsum.

Two choices keep the reference's answers:

- ``jax.lax.top_k`` puts the lower index first among equal values;
  ``torch.topk`` does not promise an order, so the top-k is the head of a
  stable descending sort.
- Kept (row, expert, slot) triples are unique, so the dispatch writes with
  ``index_put_`` without accumulation (the reference adds into zeros).
  Only the discarded overflow slot receives several tokens.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from ..configs.base import ArchConfig
from ..kernels.moe_gmm.ops import grouped_matmul
from .blocks import silu
from .params import ParamSpec
from .runtime import Runtime

__all__ = ["capacity_slots", "gates_at", "moe_apply", "moe_route", "moe_specs", "router_probs"]


def moe_specs(cfg: ArchConfig, stacked: Optional[int] = None,
              dtype: torch.dtype = torch.bfloat16) -> Dict[str, ParamSpec]:
    e = cfg.moe
    d = cfg.d_model
    f = e.d_ff_expert
    lead = (stacked,) if stacked else ()
    lx = ("layers",) if stacked else ()
    glu = cfg.act == "swiglu"
    specs: Dict[str, ParamSpec] = {
        "router": ParamSpec(lead + (d, e.n_experts), lx + ("embed", None), torch.float32, "scaled"),
        "w_up": ParamSpec(lead + (e.n_experts, d, f), lx + ("experts", "embed", "expert_mlp"),
                          dtype, "scaled"),
        "w_down": ParamSpec(lead + (e.n_experts, f, d), lx + ("experts", "expert_mlp", "embed"),
                            dtype, "scaled"),
    }
    if glu:
        specs["w_gate"] = ParamSpec(lead + (e.n_experts, d, f),
                                    lx + ("experts", "embed", "expert_mlp"), dtype, "scaled")
    if e.n_shared:
        fs = f * e.n_shared
        specs["ws_up"] = ParamSpec(lead + (d, fs), lx + ("embed", "mlp"), dtype, "scaled")
        specs["ws_down"] = ParamSpec(lead + (fs, d), lx + ("mlp", "embed"), dtype, "scaled")
        if glu:
            specs["ws_gate"] = ParamSpec(lead + (d, fs), lx + ("embed", "mlp"), dtype, "scaled")
    return specs


def router_probs(router: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """The router's float32 probabilities (B, S, E) for x (B, S, D)."""
    return torch.softmax(torch.einsum("bsd,de->bse", x.float(), router.float()), dim=-1)


def gates_at(probs: torch.Tensor, expert_idx: torch.Tensor) -> torch.Tensor:
    """The gates (B, S, K) of the chosen experts: ``probs`` at ``expert_idx``,
    renormalised to sum to 1."""
    gates = probs.gather(-1, expert_idx)
    return gates / gates.sum(-1, keepdim=True).clamp_min(1e-9)


def capacity_slots(expert_idx: torch.Tensor, n_experts: int, Cr: int) -> torch.Tensor:
    """Per batch row, the capacity slot (B, S*K) of each (token, choice): its
    position among the row's earlier assignments to the same expert, or
    ``Cr`` (dropped) from the capacity on."""
    B = expert_idx.shape[0]
    row_expert = expert_idx.reshape(B, -1)
    onehot = F.one_hot(row_expert, n_experts)
    prior = torch.cumsum(onehot, dim=1) - onehot
    pos_in_expert = prior.gather(2, row_expert[..., None])[..., 0]
    return torch.where(pos_in_expert < Cr, pos_in_expert, Cr)


def moe_route(router: torch.Tensor, x: torch.Tensor, cfg: ArchConfig, rt: Runtime
              ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Routing of x (B, S, D): (gate_vals (B, S, K) float32, expert_idx
    (B, S, K) int64, slot (B, S*K) int64 with ``Cr`` for a dropped
    assignment, Cr the per-row capacity)."""
    e = cfg.moe
    S = x.shape[1]
    probs = router_probs(router, x)
    # top-k with ties to the lower index, as jax.lax.top_k
    expert_idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][..., :e.top_k]
    cf = rt.capacity_factor if rt.capacity_factor is not None else e.capacity_factor
    Cr = max(int(S * e.top_k * cf / e.n_experts), 4)
    return gates_at(probs, expert_idx), expert_idx, capacity_slots(expert_idx, e.n_experts, Cr), Cr


def moe_apply(p: Dict[str, torch.Tensor], x: torch.Tensor, cfg: ArchConfig,
              rt: Runtime) -> torch.Tensor:
    """x: (B, S, D) -> (B, S, D)."""
    e = cfg.moe
    B, S, D = x.shape
    E, K = e.n_experts, e.top_k
    glu = cfg.act == "swiglu"
    gate_vals, expert_idx, slot, Cr = moe_route(p["router"], x, cfg, rt)
    row_expert = expert_idx.reshape(B, S * K)

    # ---- dispatch: (B, E, Cr+1, D); the kept triples are unique
    tok_idx = torch.arange(S, device=x.device).repeat_interleave(K)
    bidx = torch.arange(B, device=x.device)[:, None].expand(B, S * K)
    buf = torch.zeros((B, E, Cr + 1, D), dtype=x.dtype, device=x.device)
    buf.index_put_((bidx, row_expert, slot), x[:, tok_idx, :])
    expert_in = buf[:, :, :Cr, :].permute(1, 0, 2, 3).reshape(E, B * Cr, D).contiguous()

    # ---- expert FFN: three grouped matmuls (K9 on the card)
    if glu:
        h = silu(grouped_matmul(expert_in, p["w_gate"])) * grouped_matmul(expert_in, p["w_up"])
    else:
        r = F.relu(grouped_matmul(expert_in, p["w_up"]))
        h = r * r
    expert_out = grouped_matmul(h, p["w_down"])                          # (E, B*Cr, D)

    # ---- combine: gather back per row, weight, sum over the K choices
    per_row = expert_out.reshape(E, B, Cr, D).permute(1, 0, 2, 3)         # (B, E, Cr, D)
    padded = torch.cat([per_row, per_row.new_zeros((B, E, 1, D))], dim=2)
    gathered = padded[bidx, row_expert, slot]                             # (B, S*K, D)
    weighted = gathered * gate_vals.reshape(B, S * K)[..., None].to(gathered.dtype)
    out = weighted.reshape(B, S, K, D).sum(dim=2)

    # ---- shared experts (always on)
    if e.n_shared:
        if glu:
            hs = silu(x @ p["ws_gate"]) * (x @ p["ws_up"])
        else:
            r = F.relu(x @ p["ws_up"])
            hs = r * r
        out = out + hs @ p["ws_down"]
    return out
