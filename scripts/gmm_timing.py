#!/usr/bin/env python3
"""Time K9's prefill route and K9b's two products on the card, for
comparing two trees of the port in turns within one machine.

    PYTHONPATH=<tree>/src python3 scripts/gmm_timing.py [--reps 20]

Needs ``nvcc`` and an NVIDIA H100. The kernels are those of the
``repro_torch`` that ``PYTHONPATH`` names (built into its own ``_build``),
so running this script on two trees, in the order A, B, B, A, compares
their kernels on one card. Shapes, bf16, inputs drawn on the card from
seed 0: K9 ``gmm_cuda`` at mixtral-8x22b's w_gate product (8, 2560, 6144) x
(8, 6144, 16384) and at deepseek-v3's (256, 320, 7168) x (256, 7168, 2048);
K9b ``gmm_bwd_cuda``'s dx and dw at the mixtral shape. Each is timed with
CUDA events over ``--reps`` calls after three warm-up calls; the median
call is printed as one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess

import torch

import repro_torch
from repro_torch.kernels.moe_gmm import ops


def _median_ms(fn, reps: int) -> float:
    for _ in range(3):
        fn()
    times = []
    for _ in range(reps):
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=20)
    reps = ap.parse_args().reps
    g = torch.Generator(device="cuda").manual_seed(0)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    out = {"tree": repro_torch.__file__}
    x, w = draw(8, 2560, 6144), draw(8, 6144, 16384, scale=6144 ** -0.5)
    dy = draw(8, 2560, 16384)
    out["k9_mixtral_ms"] = _median_ms(lambda: ops.gmm_cuda(x, w), reps)
    out["k9b_dx_ms"] = _median_ms(lambda: ops.gmm_bwd_cuda(x, w, dy, need=(True, False)), reps)
    out["k9b_dw_ms"] = _median_ms(lambda: ops.gmm_bwd_cuda(x, w, dy, need=(False, True)), reps)
    del x, w, dy
    x, w = draw(256, 320, 7168), draw(256, 7168, 2048, scale=7168 ** -0.5)
    out["k9_deepseek_ms"] = _median_ms(lambda: ops.gmm_cuda(x, w), reps)
    out["routes"] = [ops.route_of(x, w), ops.gmm_bwd_route(x.dtype, 7168, 2048, True)]
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
