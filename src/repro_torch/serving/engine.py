"""Batched serving: prefill + decode over a shared KV cache.

The reference's ``ServingEngine``, ported: a static-batch loop in which
requests join a slot, the prompts (left-padded with token 0) fill the
cache token by token through the decode path, and decode steps advance
every slot together. Greedy or temperature sampling runs on the host in
numpy with the same ``np.random.default_rng(seed)`` calls as the
reference, so at a fixed seed the two packages draw the same streams.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..models import Runtime, decode_step, init_cache

__all__ = ["Request", "ServingEngine", "prefill_with_cache"]


def prefill_with_cache(params, cfg: ArchConfig, rt: Runtime, cache, tokens: torch.Tensor):
    """Sequential prefill through the decode path (fills the cache exactly
    as decode will read it). tokens: (B, S_prompt). Returns (logits_last,
    cache)."""
    B, S = tokens.shape
    logits = torch.zeros((B, 1, cfg.vocab), dtype=rt.cdtype, device=tokens.device)
    for t in range(S):
        logits, cache = decode_step(params, cfg, rt, cache, tokens[:, t:t + 1])
    return logits, cache


@dataclass
class Request:
    prompt: np.ndarray           # (S,) int32
    max_new_tokens: int = 16
    temperature: float = 0.0
    generated: List[int] = field(default_factory=list)
    done: bool = False


class ServingEngine:
    def __init__(self, params, cfg: ArchConfig, rt: Runtime, batch_size: int = 4,
                 max_len: int = 256, seed: int = 0):
        self.params = params
        self.cfg = cfg
        self.rt = rt
        self.batch = batch_size
        self.max_len = max_len
        self.rng = np.random.default_rng(seed)
        self.device = params["embed"].device

    def generate(self, requests: List[Request]) -> List[Request]:
        """Serve a list of requests in static batches."""
        for start in range(0, len(requests), self.batch):
            group = requests[start:start + self.batch]
            self._serve_group(group)
        return requests

    def _decode(self, cache, toks: np.ndarray):
        return decode_step(self.params, self.cfg, self.rt, cache,
                           torch.from_numpy(toks).to(self.device))

    def _serve_group(self, group: List[Request]) -> None:
        B = self.batch
        cache = init_cache(self.cfg, self.rt, B, self.max_len,
                           enc_len=self.max_len if self.cfg.family == "encdec" else 0,
                           device=self.device)
        maxp = max(len(r.prompt) for r in group)
        toks = np.zeros((B, maxp), np.int32)
        for i, r in enumerate(group):
            toks[i, -len(r.prompt):] = r.prompt  # left-pad
        logits = None
        for t in range(maxp):
            logits, cache = self._decode(cache, toks[:, t:t + 1])
        steps = max(r.max_new_tokens for r in group)
        cur = self._sample(logits, group)
        for _ in range(steps):
            for i, r in enumerate(group):
                if not r.done:
                    r.generated.append(int(cur[i]))
                    if len(r.generated) >= r.max_new_tokens:
                        r.done = True
            if all(r.done for r in group):
                break
            logits, cache = self._decode(cache, cur[:, None])
            cur = self._sample(logits, group)

    def _sample(self, logits: torch.Tensor, group) -> np.ndarray:
        lg = logits[:, -1, :].float().cpu().numpy()
        out = np.zeros(len(lg), np.int32)
        for i, r in enumerate(group[: len(lg)]):
            if r.temperature <= 0:
                out[i] = int(lg[i].argmax())
            else:
                p = np.exp((lg[i] - lg[i].max()) / r.temperature)
                p /= p.sum()
                out[i] = int(self.rng.choice(len(p), p=p))
        return out
