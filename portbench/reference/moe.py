"""Plain float32 reference of the MoE family (mixtral-8x22b, arXiv:2401.04088).

A decoder layer: RMSNorm, causal grouped-query attention with rotary
positions (and a sliding window where the configuration states one), the
residual; RMSNorm, a router of float32 softmax
probabilities over the experts, each token's top-k experts (ties to the
lower index) with their probabilities renormalised to sum to one, each
expert a SwiGLU FFN, the residual. Capacity, as the configuration states
it: within a dispatch row of S tokens each expert keeps at most C =
max(floor(S k cf / E), 4) assignments, taken in the order of (token,
choice); the rest are dropped and add nothing.

Weights are the tree the benchmark drew (bf16, stacked over layers); each
layer is upcast to float32 when it runs, so the whole model is never held
twice.
"""

from __future__ import annotations

from typing import List

import torch

from .common import Numerics, attention, head_logits, rmsnorm, rope, silu


def capacity(S: int, cfg: dict) -> int:
    m = cfg["arch"]["moe"]
    return max(int(S * m["top_k"] * m["capacity_factor"] / m["n_experts"]), 4)


def moe_ffn(num: Numerics, x: torch.Tensor, lw: dict, cfg: dict, row_len: int) -> torch.Tensor:
    """The MoE FFN over x (T, D) of consecutive dispatch rows of ``row_len``
    tokens each."""
    m = cfg["arch"]["moe"]
    E, K = m["n_experts"], m["top_k"]
    T, D = x.shape
    probs = torch.softmax(x @ lw["router"].float(), dim=-1)           # (T, E)
    idx = torch.sort(probs, dim=-1, descending=True, stable=True)[1][:, :K]
    gates = probs.gather(-1, idx)
    gates = gates / gates.sum(-1, keepdim=True)
    C = capacity(row_len, cfg)
    # position of each (token, choice) among its row's earlier ones to the
    # same expert
    flat = idx.reshape(T // row_len, row_len * K)
    onehot = torch.nn.functional.one_hot(flat, E)
    before = (torch.cumsum(onehot, dim=1) - onehot).gather(2, flat[..., None])[..., 0]
    kept = (before < C).reshape(T, K)
    out = torch.zeros_like(x)
    for e in range(E):
        tok, choice = torch.nonzero((idx == e) & kept, as_tuple=True)
        if tok.numel() == 0:
            continue
        xe = x[tok]
        h = silu(num.lin(xe, lw["w_gate"][e])) * num.lin(xe, lw["w_up"][e])
        ye = num.lin(h, lw["w_down"][e])
        out.index_add_(0, tok, ye * gates[tok, choice][:, None])
    return out


def _layer(params: dict, i: int) -> dict:
    b = params["blocks"]
    return {"attn": {k: v[i] for k, v in b["attn"].items()},
            "moe": {k: v[i] for k, v in b["moe"].items()},
            "ln1": b["ln1"][i], "ln2": b["ln2"][i]}


def forward_rows(params: dict, cfg: dict, rows: List[torch.Tensor],
                 num: Numerics) -> List[torch.Tensor]:
    """Final hidden states (S_r, D), float32, of each row of tokens ``rows``
    (S_r,) at positions 0 .. S_r - 1; each row is its own dispatch row of
    the MoE capacity, as a prompt of a prefill batch is."""
    a = cfg["arch"]
    L, D, Hq, Hkv = a["n_layers"], a["d_model"], a["n_heads"], a["n_kv_heads"]
    hd = D // Hq
    eps, theta, window = a["norm_eps"], cfg["rope_theta"], a.get("window")
    emb = params["embed"]
    xs = [emb[r.long()].float() for r in rows]
    for i in range(L):
        lw = _layer(params, i)
        for j, x in enumerate(xs):
            S = x.shape[0]
            pos = torch.arange(S, device=x.device)
            h = rmsnorm(x, lw["ln1"], eps)
            q = num.lin(h, lw["attn"]["wq"].reshape(D, Hq * hd)).reshape(S, Hq, hd)
            k = num.lin(h, lw["attn"]["wk"].reshape(D, Hkv * hd)).reshape(S, Hkv, hd)
            v = num.lin(h, lw["attn"]["wv"].reshape(D, Hkv * hd)).reshape(S, Hkv, hd)
            q = rope(q[None], pos[None], theta)[0]
            k = rope(k[None], pos[None], theta)[0]
            o = attention(num, q, k, v, pos, pos, window)
            x = x + num.lin(o.reshape(S, Hq * hd), lw["attn"]["wo"].reshape(Hq * hd, D))
            xs[j] = x + moe_ffn(num, rmsnorm(x, lw["ln2"], eps), lw["moe"], cfg, S)
    return xs


def logits_at(params: dict, cfg: dict, hidden: torch.Tensor, num: Numerics,
              block: int = 1024):
    """Yields (start, logits (b, V) float32) over blocks of rows of the final
    hidden states (S, D)."""
    a = cfg["arch"]
    head = params["out"].float()
    for s0 in range(0, hidden.shape[0], block):
        yield s0, head_logits(num, hidden[s0:s0 + block], params["final_ln"], head, a["norm_eps"])
