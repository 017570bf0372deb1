#!/usr/bin/env python3
"""Time the bf16 activations that round at each step against the fused
torch calls they replaced, at the shapes of ``chip_smoke.py``'s phases.

    PYTHONPATH=src python3 scripts/activation_cost.py

Needs an NVIDIA GPU. XLA rounds every step of ``jax.nn.silu``,
``jax.nn.sigmoid`` and ``jax.nn.gelu`` to bf16; the port replays those
steps (``models/blocks.py``: ``silu``, ``sigmoid``, ``gelu_tanh``) where it
called ``F.silu``, ``torch.sigmoid`` and ``F.gelu``, each one kernel. The
replays take more elementwise passes. For each phase, the expression the
model evaluates a layer is timed with the replay and with the fused call in
turns (fused, replay, replay, fused; CUDA events, the mean of 20 calls
each after a warm-up, operands drawn on the card from seed 0), and the
difference times the layers of the phase's counted run is its cost:

- serve: llama3-8b's swiglu hidden product silu(x w_gate) * (x w_up) on
  2 x 4096 tokens of 14336, 32 layers;
- train: the same product forward and backward (autograd), 8 layers;
- moe: mixtral-8x22b's expert product on (8 experts, 2560 rows, 16384),
  8 layers (its shared experts: none);
- ssm: rwkv6-7b's receptance gate sigmoid(x w_r) * v on 2 x 4096 x 4096
  and its silu gate on the same, 32 layers (the sigmoids of the (2, D)
  and (5, D) mixes are negligible);
- starcoder2's gelu on 2 x 4096 x 18432 (no smoke phase; for the record).

Prints one line a phase and the card's name and power limit.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.models.blocks import gelu_tanh, sigmoid, silu  # noqa: E402


def cuda_ms(fn, reps: int = 20) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(fused, replay) -> tuple:
    t = [cuda_ms(fn) for fn in (fused, replay, replay, fused)]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2


def main() -> int:
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {card.strip()}", flush=True)
    g = torch.Generator(device=dev).manual_seed(0)

    def draw(*shape):
        return (torch.randn(shape, generator=g, device=dev) * 4).to(torch.bfloat16)

    def glu(act):
        return lambda a, b: act(a) * b

    def fwd_bwd(act, a, b):
        a = a.detach().requires_grad_(True)
        b = b.detach().requires_grad_(True)
        out = act(a) * b
        out.backward(torch.ones_like(out))

    cases = []
    a, b = draw(8192, 14336), draw(8192, 14336)
    cases.append(("serve", "swiglu", 32, lambda: glu(F.silu)(a, b), lambda: glu(silu)(a, b)))
    cases.append(("train", "swiglu forward and backward", 8,
                  lambda: fwd_bwd(F.silu, a, b), lambda: fwd_bwd(silu, a, b)))
    e, f = draw(8, 2560, 16384), draw(8, 2560, 16384)
    cases.append(("moe", "expert swiglu", 8, lambda: glu(F.silu)(e, f), lambda: glu(silu)(e, f)))
    r, v = draw(8192, 4096), draw(8192, 4096)
    cases.append(("ssm", "receptance sigmoid and silu gate", 32,
                  lambda: (torch.sigmoid(r) * v, F.silu(r) * v),
                  lambda: (sigmoid(r) * v, silu(r) * v)))
    x = draw(8192, 18432)
    cases.append(("starcoder2", "gelu (no smoke phase)", 32,
                  lambda: F.gelu(x, approximate="tanh"), lambda: gelu_tanh(x)))
    for phase, what, layers, fused, replay in cases:
        f_ms, r_ms = in_turns(fused, replay)
        print(f"[act] {phase}: {what}: fused {f_ms:.6f} ms, replay {r_ms:.6f} ms a layer "
              f"(in turns); {layers} layers: {layers * (r_ms - f_ms):.6f} ms more a run",
              flush=True)
    print(card.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
