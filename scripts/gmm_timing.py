#!/usr/bin/env python3
"""Time K9's prefill route and K9b's two products on the card, for
comparing two trees of the port in turns within one machine.

    PYTHONPATH=<tree>/src python3 scripts/gmm_timing.py [--reps 30] [--clock-s 3]

Needs ``nvcc`` and an NVIDIA H100. The kernels are those of the
``repro_torch`` that ``PYTHONPATH`` names (built into its own ``_build``),
so running this script on two trees, in the order A, B, B, A, compares
their kernels on one card. Shapes, bf16, inputs drawn on the card from
seed 0: K9 ``gmm_cuda`` at mixtral-8x22b's w_gate product (8, 2560, 6144) x
(8, 6144, 16384) and at deepseek-v3's (256, 320, 7168) x (256, 7168, 2048);
K9b ``gmm_bwd_cuda``'s dx and dw at mixtral's w_gate and w_down products
(the training step's shapes) on each persistent route the tree has
(``wgmma_overlap`` and ``wgmma``; a tree without the overlap route times
``wgmma`` alone), beside ``torch.bmm`` on transposed views and the bound
(operations at 989 TFLOP/s). The calls of one product are timed in
rounds, each round every call once in a rotating order, each call between
two CUDA events (the card's clock drifts as it heats, so turns of whole
series would compare different clocks) with a spin queued before them, so
the wrapper's host time stays outside; the median of ``--reps`` rounds is
kept, after three warm-up rounds. The spin also lets the card cool a
little before each call. So at both shapes each product on the route
``gmm_bwd_route`` picks, and ``torch.bmm``, also runs back to back for
``--clock-s`` seconds, the sustained load, while ``nvidia-smi`` reads the
SM clock and the power draw every 100 ms (their means, the first sixth of
the samples left out, and the calls' mean ms): under a load near the
power limit the card lowers its clock, and the tensor cores' rate with it
(the data sheet's 989 TFLOP/s is 4096 bf16 flop a clock an SM at 1830
MHz). The result is one JSON line with the card's name and power limit.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time

import torch

import repro_torch
from repro_torch.kernels.moe_gmm import ops

BF16_OPS_PER_S = 989e12


def rounds_ms(calls: dict, reps: int) -> dict:
    """{name: median ms} of each call, timed in rounds (every call once a
    round, the order rotated each round), each call between two events. A
    spin of about a millisecond is queued before the first event, so that
    the card is busy while the host prepares the call (a wrapper's host
    time would otherwise fall between the events)."""
    names = list(calls)
    times = {k: [] for k in names}
    for r in range(reps + 3):
        for i in range(len(names)):
            k = names[(i + r) % len(names)]
            a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            torch.cuda._sleep(1_500_000)
            a.record()
            calls[k]()
            b.record()
            b.synchronize()
            if r >= 3:
                times[k].append(a.elapsed_time(b))
    return {k: statistics.median(t) for k, t in times.items()}


def sampled(fn, seconds: float) -> dict:
    """Mean SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads
    every 100 ms while ``fn`` runs back to back for ``seconds`` (the first
    sixth of the samples left out), and the calls' mean ms."""
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    time.sleep(0.5)
    t0 = time.perf_counter()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    n = 0
    while time.perf_counter() - t0 < seconds:
        fn()
        n += 1
        if n % 4 == 0:
            torch.cuda.synchronize()
    b.record()
    b.synchronize()
    smi.terminate()
    text, _ = smi.communicate()
    rows = [[float(v) for v in ln.split(",")] for ln in text.strip().splitlines()
            if ln.strip() and "N/A" not in ln]
    rows = rows[max(1, len(rows) // 6):]
    return {"sm_mhz": statistics.mean(r[0] for r in rows),
            "power_w": statistics.mean(r[1] for r in rows), "samples": len(rows),
            "ms": a.elapsed_time(b) / n}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--clock-s", type=float, default=3.0,
                    help="seconds of each clock and power sample (0: none)")
    args = ap.parse_args()
    reps = args.reps
    g = torch.Generator(device="cuda").manual_seed(0)

    def draw(*shape, scale=1.0):
        return (torch.randn(shape, generator=g, device="cuda") * scale).to(torch.bfloat16)

    routes = [r for r in ("wgmma_overlap", "wgmma") if r in ops.BWD_ROUTES]
    out = {"tree": repro_torch.__file__, "routes": routes,
           "picked": ops.gmm_bwd_route(torch.bfloat16, 6144, 16384, True)}
    for label, (D, F) in (("w_gate", (6144, 16384)), ("w_down", (16384, 6144))):
        x, w = draw(8, 2560, D), draw(8, D, F, scale=D ** -0.5)
        dy = draw(8, 2560, F)
        row = {"bound_ms": 2.0 * 8 * 2560 * D * F / BF16_OPS_PER_S * 1e3}
        for which, need in (("dx", (True, False)), ("dw", (False, True))):
            calls = {r: (lambda r=r: ops.gmm_bwd_cuda(x, w, dy, need=need, route=r))
                     for r in routes}
            calls["bmm"] = ((lambda: torch.bmm(dy, w.transpose(1, 2))) if which == "dx"
                            else (lambda: torch.bmm(x.transpose(1, 2), dy)))
            for k, t in rounds_ms(calls, reps).items():
                row[f"{which}_{k}_ms"] = t
            if args.clock_s > 0:
                row[f"{which}_clocks"] = {k: sampled(calls[k], args.clock_s)
                                          for k in (out["picked"], "bmm")}
        out[f"k9b_{label}"] = row
        del x, w, dy, calls
        torch.cuda.empty_cache()
    x, w = draw(8, 2560, 6144), draw(8, 6144, 16384, scale=6144 ** -0.5)
    xd, wd = draw(256, 320, 7168), draw(256, 7168, 2048, scale=7168 ** -0.5)
    k9 = rounds_ms({"mixtral": lambda: ops.gmm_cuda(x, w),
                    "deepseek": lambda: ops.gmm_cuda(xd, wd)}, reps)
    out["k9_mixtral_ms"], out["k9_deepseek_ms"] = k9["mixtral"], k9["deepseek"]
    out["card"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True).stdout.strip()
    print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
