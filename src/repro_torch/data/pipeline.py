"""Deterministic, sharded, checkpointable synthetic token pipeline.

A numpy copy of the reference's ``data/pipeline.py`` (the port imports
nothing of the reference): the same ``SeedSequence`` streams and draws, so
``batch_at(step)`` is bit-identical to the reference's for the same
arguments. Batches are numpy arrays; the trainer moves them to its device.

Large-scale properties it models faithfully:
  * determinism: batch(step) is a pure function of (seed, step, host) —
    restart at step N reproduces exactly the stream a continuous run saw;
  * host sharding: each host materializes only its slice of the global
    batch (no host-0 fan-out);
  * straggler skip-ahead: ``skip_to(step)`` is O(1) (counter-based PRNG,
    no state to replay) — a restarted/rescheduled worker jumps straight to
    the fleet's current step;
  * checkpoint integration: ``state()`` is just {"step": int}.

The token distribution is Zipfian with a document structure (BOS-separated
segments) so CE losses behave like real text rather than uniform noise.
"""

from __future__ import annotations

from typing import Dict, Iterator

import numpy as np

__all__ = ["SyntheticTokenPipeline"]


class SyntheticTokenPipeline:
    def __init__(
        self,
        vocab: int,
        seq_len: int,
        global_batch: int,
        seed: int = 0,
        host_index: int = 0,
        host_count: int = 1,
        zipf_a: float = 1.2,
        doc_len_mean: int = 512,
    ):
        if global_batch % host_count:
            raise ValueError(f"global batch {global_batch} is not a multiple of {host_count} hosts")
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.local_batch = global_batch // host_count
        self.seed = seed
        self.host_index = host_index
        self.host_count = host_count
        self.zipf_a = zipf_a
        self.doc_len_mean = doc_len_mean
        self._step = 0
        # Zipf over the vocab, renormalized (rank 1 = token id 2; 0=pad, 1=BOS)
        ranks = np.arange(1, vocab - 1, dtype=np.float64)
        p = ranks ** (-zipf_a)
        self._probs = p / p.sum()

    # ------------------------------------------------------------------ state
    def state(self) -> Dict[str, int]:
        return {"step": self._step}

    def restore(self, state: Dict[str, int]) -> None:
        self._step = int(state["step"])

    def skip_to(self, step: int) -> None:
        self._step = int(step)

    # ------------------------------------------------------------------ batch
    def _rng_for(self, step: int) -> np.random.Generator:
        # counter-based: independent stream per (seed, step, host)
        return np.random.default_rng(
            np.random.SeedSequence([self.seed, step, self.host_index])
        )

    def batch_at(self, step: int) -> Dict[str, np.ndarray]:
        rng = self._rng_for(step)
        B, S = self.local_batch, self.seq_len
        toks = rng.choice(self.vocab - 2, size=(B, S + 1), p=self._probs).astype(np.int32) + 2
        # document boundaries: geometric segment lengths, BOS token = 1
        n_docs = max(int((S + 1) / self.doc_len_mean * B), 1)
        rows = rng.integers(0, B, n_docs)
        cols = rng.integers(0, S + 1, n_docs)
        toks[rows, cols] = 1
        return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        return self

    def __next__(self) -> Dict[str, np.ndarray]:
        b = self.batch_at(self._step)
        self._step += 1
        return b
