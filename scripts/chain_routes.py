#!/usr/bin/env python3
"""Time the routes of K3 (the Shapley-chain walk) across shapes, to set the
planner's limits (``chain.ordinals_plan``, ``chain.values_plan``).

    PYTHONPATH=src python3 scripts/chain_routes.py

Needs ``nvcc`` and an NVIDIA GPU. Every time is the device time a call of
the named kernels from a ``torch.profiler`` trace of 10 calls after a
warm-up (the smoke's ``traced_call_ms``), with an empty kernel's time
beside them.

- Inputs: random leaf words of C chains (4 configs' rows, each chain's
  drawn), nb background rows, T trees and W words on d = 60 features,
  drawn on the host from seed 0 with every AND keeping a bit (so every
  walk exits), and leaf means of both signs, 64 a tree; over C in 20, 96,
  268, 512, nb in 12, 16, 64, T in 10, 50, 120 and W in 1, 2.
- Routes: the ordinals on ``per_chain`` and ``staged`` (each plan
  printed), the chain values on ``values`` where ``values_plan`` gives it,
  and on ``staged`` with the torch tail (all its kernels); every output
  held to its plain version bit for bit.
- A planner variant at the tuner's largest call (268 x 16 x 10 x 1) and at
  120 trees: one block an SM (``chain._BLOCKS_PER_SM = 1``).

Prints one line a measurement, the card's name and power limit first.
"""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))

import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels.forest_eval import chain  # noqa: E402
from repro_torch.kernels.launch import n_sms  # noqa: E402

D = 60
TAGS = smoke.ROUTE_TAGS["chain_ordinals"]


def inputs(C: int, nb: int, T: int, W: int, dev):
    """chain_values' arguments on the card, drawn from seed 0."""
    rng = np.random.default_rng(0)

    def draw(*shape):
        w = rng.integers(0, 2**63, size=shape, dtype=np.uint64) | (
            rng.integers(0, 2, size=shape, dtype=np.uint64) << np.uint64(63))
        w[..., -1] |= np.uint64(1) << np.uint64(63)
        return w

    words, wb = draw(4, D, T, W), draw(nb, D, T, W)
    if W == 2:
        words[..., 0] &= rng.integers(0, 2, size=(4, D, T), dtype=np.uint64) * np.uint64(2**62)
    perms = np.stack([rng.permutation(D) for _ in range(C)]).astype(np.int32)
    xoc = rng.integers(0, 4, C).astype(np.int32)
    lm = rng.normal(size=64 * W * T)
    offs = np.arange(T, dtype=np.int64) * 64 * W

    def to(a):
        return torch.from_numpy(a).to(dev)

    return (to(words.view(np.int64)), to(xoc), to(wb.view(np.int64)), to(perms), to(lm),
            to(offs), 1.7, -0.3)


def bits(t):
    return t.contiguous().view(torch.int64)


def measure(args, label: str) -> dict:
    """Each route of ``args`` held to its plain version, then timed."""
    words, xoc, wb, perms = args[:4]
    C, (_, d, T, W), nb = perms.shape[0], words.shape, wb.shape[0]
    wx = words[xoc.long()].contiguous()
    want = chain.chain_ordinals_plain(wx, wb, perms)
    want_vals = chain.chain_values_plain(*args)
    ord_plan = chain.ordinals_plan(C, d, nb, T, W, n_sms(words.device))
    val_plan = chain.values_plan(C, d, nb, T, W, args[4].numel(), n_sms(words.device))
    out = {}
    for route in chain.ROUTES:
        if route == "staged" and chain.staged_plan(C, d, nb, T, W, n_sms(words.device)) is None:
            continue
        if not torch.equal(chain.chain_ordinals_cuda(wx, wb, perms, route=route), want):
            smoke.fail(f"K3 {route} at {label} differs from its plain version")
        out[route] = smoke.traced_call_ms(
            lambda: chain.chain_ordinals_cuda(wx, wb, perms, route=route), TAGS[route])[0]
    for route in ("values", "staged"):
        if route == "values" and val_plan.route != "values" or "staged" not in out:
            continue
        if not torch.equal(bits(chain.chain_values_cuda(*args, route=route)), bits(want_vals)):
            smoke.fail(f"K3 values on {route} at {label} differ from the plain version")
        key = "values" if route == "values" else "staged+tail"
        out[key] = smoke.traced_call_ms(lambda: chain.chain_values_cuda(*args, route=route),
                                        [("", None)])[0]
    print(f"[k3] {label} ordinals plan {tuple(ord_plan)} values plan {tuple(val_plan)} "
          f"ms={out}", flush=True)
    return out


def variants(C: int, nb: int, T: int, W: int, dev) -> None:
    args = inputs(C, nb, T, W, dev)
    label = f"C={C} nb={nb} T={T} W={W}"
    default = chain._BLOCKS_PER_SM
    try:
        for name, per_sm in (("the plan", default), ("one block an SM", 1)):
            chain._BLOCKS_PER_SM = per_sm
            print(f"[k3] variant {name}:", flush=True)
            measure(args, f"{label} ({name})")
    finally:
        chain._BLOCKS_PER_SM = default


def main() -> int:
    if not torch.cuda.is_available():
        smoke.fail("needs a CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(f"[card] {card.strip()}", flush=True)
    dev = torch.device("cuda")
    smoke.launch_floor_ms(dev)
    variants(268, 16, 10, 1, dev)
    variants(268, 16, 120, 1, dev)
    for W in (1, 2):
        for T in (10, 50, 120):
            for nb in (12, 16, 64):
                for C in (20, 96, 268, 512):
                    measure(inputs(C, nb, T, W, dev), f"C={C} nb={nb} T={T} W={W}")
                    torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
