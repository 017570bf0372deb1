"""The yardstick's arithmetic: the chip's peaks and the operations and
bytes that each kernel's and each step's work needs, computed from the
configuration and the inputs, never from what a kernel happens to do.

Peaks are NVIDIA's data sheet for one H100 SXM (dense rates, no sparsity,
at the full 700 W power limit). A call's least time is the larger of its
bytes over the memory rate and its operations over the peak of their type;
a roofline share is the sum of the calls' least times over the measured
kernel time. Each input byte is read once and each output byte written
once.

Copied from the repository's ``chip_smoke.py`` (``bound``) and
``tools/roofline.py`` (the constants) and kept here, frozen, so that a
later change to the program cannot move the yardstick. A family's model
FLOPs and weight bytes are in ``portbench/families/<family>.py``.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, Iterable, Optional, Sequence

BF16_OPS_PER_S = 989e12    # H100 SXM bf16 tensor cores, dense
F32_OPS_PER_S = 67e12      # H100 SXM float32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12  # H100 SXM HBM3


def least_s(n_bytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0) -> float:
    """The least time the chip could take for the work."""
    return max(n_bytes / HBM_BYTES_PER_S, bf16_ops / BF16_OPS_PER_S + f32_ops / F32_OPS_PER_S)


def kept_pairs(S: int, window: Optional[int]) -> int:
    """(query, key) pairs of S positions that a causal mask, and a window
    where there is one, keep (key k visible to query q when k <= q and
    q - k < window)."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


class Work:
    """Sums, per quantity (``"model"``, ``"k9"``, ...), of the least time of
    each call's work; ``steps`` counts the steps, ``tokens`` the tokens."""

    def __init__(self):
        self.least: Dict[str, float] = defaultdict(float)
        self.steps = 0
        self.tokens = 0

    def add(self, key: str, n_bytes: float, bf16_ops: float = 0.0, f32_ops: float = 0.0) -> None:
        self.least[key] += least_s(n_bytes, bf16_ops, f32_ops)


# ------------------------------------------------------------ model sizes


def head_dim(a: dict) -> int:
    return a.get("d_head") or a["d_model"] // a["n_heads"]


def attn_params(a: dict) -> int:
    """Parameters of one attention layer's q, k, v and output projections."""
    d, hq, hkv, hd = a["d_model"], a["n_heads"], a["n_kv_heads"], head_dim(a)
    return d * hq * hd * 2 + 2 * d * hkv * hd


# --------------------------------------------------------- per-call work


def k4_call(work: Work, key: str, a: dict, B: int, S: int, window: Optional[int]) -> None:
    """One attention layer's K4 over B prompts of S tokens: the score and
    value products over the pairs the mask keeps, q, k, v read and the
    output written once."""
    hq, hkv, hd = a["n_heads"], a["n_kv_heads"], head_dim(a)
    pairs = B * kept_pairs(S, window)
    n_bytes = 2.0 * B * S * hd * (2 * hq + 2 * hkv)
    work.add(key, n_bytes, bf16_ops=4.0 * hq * hd * pairs)


def k9_layer(work: Work, key: str, a: dict, kept: Sequence[int]) -> None:
    """One MoE layer's three K9 products over ``kept[e]`` kept assignments
    of each expert e: each hit expert's weights read once, the kept rows in
    and out, nothing of the padding."""
    d, f = a["d_model"], a["moe"]["d_ff_expert"]
    for rows_in, rows_out in ((d, f), (d, f), (f, d)):
        n_rows = sum(kept)
        hit = sum(1 for k in kept if k)
        n_bytes = 2.0 * (hit * d * f + n_rows * (rows_in + rows_out))
        work.add(key, n_bytes, bf16_ops=2.0 * n_rows * d * f)


def experts_hit(kept_rows: Iterable[Sequence[int]]) -> int:
    return sum(sum(1 for k in kept if k) for kept in kept_rows)
