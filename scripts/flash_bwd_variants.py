#!/usr/bin/env python3
"""Time variants of K5's and K6's bf16 route against the source as it is.

    PYTHONPATH=src python3 scripts/flash_bwd_variants.py

Needs ``nvcc`` and an NVIDIA H100. Each variant is ``csrc/flash_attn_bwd.cu``
with a few constants or lines substituted, built by ``nvcc`` with the port's
flags into ``src/repro_torch/_build/variants/`` (all at once), its ptxas
spill and serialization warnings printed. Then, at llama3-8b's training
shape (q 16 x 4096 x 4 x 128 bf16, causal, lse and delta from K4), K5 and K6
of each variant are timed in turns with the unchanged source (source,
variant, variant, source; CUDA events, the mean of 10 calls each after a
warm-up), beside the largest difference of their outputs from the
source's. Some variants compute something else on purpose, to show what a
part of the kernel costs: their differences are not errors.
"""

from __future__ import annotations

import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_attn import ops

CSRC = Path(build.source_path("flash_attn_bwd")).parent
OUT = CSRC.parent / "_build" / "variants"

# name -> (what it shows, [(text in the source, its replacement)])
VARIANTS = {
    "base": ("the source as it is, built again", []),
    "regs240_sub64": (
        "K6 takes each 64-row q tile whole, with 240 consumer registers",
        [("PRODUCER_REGS = 40", "PRODUCER_REGS = 24"),
         ("CONSUMER_REGS = 232", "CONSUMER_REGS = 240"),
         ("constexpr int N = D > 80 ? 32 : TS;", "constexpr int N = TS;")]),
    "stages3": ("three shared-memory stages instead of two",
                [("constexpr int STAGES = 2;", "constexpr int STAGES = 3;")]),
    "fold_scale": ("scale and log2 e folded into one multiplier of the raw scores",
                   [("x[i] = exp2f(fmaf(x[i] * scale, kLog2e, -l));",
                     "x[i] = exp2f(fmaf(x[i], scale * kLog2e, -l));"),
                    ("float pA = exp2f(fmaf(x[4 * i + e] * scale, kLog2e, -l * kLog2e));",
                     "float pA = exp2f(fmaf(x[4 * i + e], scale * kLog2e, -l * kLog2e));"),
                    ("float pB = exp2f(fmaf(x[4 * i + 2 + e] * scale, kLog2e, -l * kLog2e));",
                     "float pB = exp2f(fmaf(x[4 * i + 2 + e], scale * kLog2e, -l * kLog2e));")]),
    "no_lo": ("p and ds as one bf16 part (wrong by design: the cost of the split)",
              [("#pragma unroll\n  for (int j = 0; j < J; ++j) wgmma_rs<D>(acc, lo[j], "
                "mnmajor(b, TS, j0 + j), 1);\n", "")]),
    "no_exp": ("no exp2 and no mask (wrong by design: the cost of the elementwise pass)",
               [("x[i] = exp2f(fmaf(x[i] * scale, kLog2e, -l));", "x[i] = x[i] * l;"),
                ("float pA = exp2f(fmaf(x[4 * i + e] * scale, kLog2e, -l * kLog2e));",
                 "float pA = x[4 * i + e] * l;"),
                ("float pB = exp2f(fmaf(x[4 * i + 2 + e] * scale, kLog2e, -l * kLog2e));",
                 "float pB = x[4 * i + 2 + e] * l;"),
                ("if (k0 < max(loA, loB) || k0 + TS > min(hiA, hiB)) {", "if (false) {"),
                ("if (!whole) {", "if (false) {")]),
}


def build_variants() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    shutil.copy(CSRC / "hopper.cuh", OUT)
    src = (CSRC / "flash_attn_bwd.cu").read_text()
    procs = {}
    for name, (_, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        (OUT / f"{name}.cu").write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
               str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"variant {name} does not build:\n{log[-4000:]}")
        spills, entry = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"(flash_(?:dq|dkv)_hopper)ILi(\d+)E", line)
                entry = f"{m.group(1)}<{m.group(2)}>" if m else None
            elif entry and "spill stores" in line and not line.strip().startswith("0 bytes"):
                spills.append(f"{entry}: {line.strip()}")
        print(f"{name}: {VARIANTS[name][0]}; serialized wgmma: {'serialized' in log}; "
              f"spills: {spills or 'none'}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def cuda_ms(fn, reps: int = 10) -> float:
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


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    libs = build_variants()
    g = torch.Generator(device="cpu").manual_seed(0)
    BH, S, G, D = 16, 4096, 4, 128
    q, do = (torch.randn((BH, S, G, D), generator=g).to("cuda", torch.bfloat16) for _ in range(2))
    k, v = (torch.randn((BH, S, D), generator=g).to("cuda", torch.bfloat16) for _ in range(2))
    o, lse = ops.flash_fwd_cuda(q, k, v, causal=True)
    delta = (do.float() * o.float()).sum(-1)

    def caller(lib, which):
        fn = getattr(lib, f"flash_attn_{which}_bf16")
        outs = [torch.empty_like(q)] if which == "dq" else [torch.empty_like(k),
                                                             torch.empty_like(v)]
        fn.argtypes = [ctypes.c_void_p] * (6 + len(outs)) + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        ptrs = [t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)]

        def run():
            rc = fn(*ptrs, BH, S, S, G, D, 1, 0, 0, 0, torch.cuda.current_stream().cuda_stream)
            if rc != 0:
                raise RuntimeError(f"CUDA error {rc}")
            return outs
        return run

    for which in ("dq", "dkv"):
        base = caller(libs["base"], which)
        ref = [t.clone() for t in base()]
        for name, lib in libs.items():
            if name == "base":
                continue
            fn = caller(lib, which)
            got = fn()
            torch.cuda.synchronize()
            diff = max(float((a.float() - b.float()).abs().max()) for a, b in zip(got, ref))
            turns = [cuda_ms(f) for f in (base, fn, fn, base)]
            print(f"{which} {name}: max|out - source's| {diff:.4g}; ms source, variant, variant, "
                  f"source: {', '.join(f'{t:.6f}' for t in turns)}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
