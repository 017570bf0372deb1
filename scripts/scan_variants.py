#!/usr/bin/env python3
"""Time variants of the chunked routes of K8 and K12 against the sources as
they are, step by step.

    PYTHONPATH=src python3 scripts/scan_variants.py

Needs ``nvcc`` and an NVIDIA H100. Each variant is ``csrc/mamba2_ssd.cu`` or
``csrc/rwkv6_wkv.cu`` with a few lines substituted, built by ``nvcc`` with
the port's flags into ``src/repro_torch/_build/variants_scan/`` (all at
once). At the smoke's shapes, the first layer of each prefill (zamba2-2.7b:
x, B and C (2, 4096, 80, 64) bf16, chunk 128, the model's function;
rwkv6-7b: r, k, v (2, 4096, 64, 64) bf16, w float32, chunk 64, bf16
intra-chunk operands), inputs drawn on the card from seed 5, each
variant's chunked C entry (its three launches) is run in turns with the
unchanged source (source, variant, variant, source; each turn 20 calls
after a warm-up under ``torch.profiler``), and the kernel time a call of
step 1 (the increments) and step 3 (the outputs) is read from each turn's
trace; beside them, the largest difference of the variant's y and final
state from the source's, and the card's name and power limit. Some
variants compute something else on purpose, to show what a part of a step
costs: their differences are not errors.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

from repro_torch.kernels import build  # noqa: E402

OUT = Path(build.source_path("mamba2_ssd")).parent.parent / "_build" / "variants_scan"

_K8_FMA = "  for (int k = 0; k < c; ++k) {\n    const float4 xv"
_K8_BEXP = "    sB[t * WMAX + n] = sB[t * WMAX + n] * sE[t];"
_K12_FMA = "  for (int s = 0; s < c; ++s) {\n    const float4 kv"
_K12_SCAN1 = "#pragma unroll 8\n    for (int t = 0; t < c; ++t) {\n      acc += sC[t * LDW + tid];"
_K12_SCAN3 = "#pragma unroll 8\n    for (int t = 0; t < c; ++t) {\n      const float wv"
_K12_BONUS = "    for (int j = 0; j < K; ++j) acc += to_f(m.sR"
_K12_FACT = ("  for (int e = tid; e < c * K; e += NT) {\n    const int t = e / K, j = e - t * K;\n"
             "    const float cs")

# kernel -> name -> (what it shows, [(text in the source, its replacement)])
VARIANTS = {
    "mamba2_ssd": {
        "base": ("the source as it is, built again", []),
        "s1_no_fma": ("step 1 without its products (wrong by design)",
                      [(_K8_FMA, _K8_FMA.replace("k < c", "k < 0"))]),
        "s1_no_bexp": ("step 1 without B * exp(total - cs) (wrong by design)",
                       [(_K8_BEXP, "")]),
        "s3_no_state": ("step 3 without the state's part (wrong by design)",
                        [("  for (int n = 0; n < N4; n += 4) {",
                          "  for (int n = 0; n < 0; n += 4) {")]),
        "s3_no_exp": ("step 3's mask without its exp (wrong by design)",
                      [("expf(csr[e >> 1] - sCs[k])", "1.f")]),
        "s3_no_mma": ("step 3 without its two tensor-core products (wrong by design)",
                      [("        mma_bf16(sc[nt], af, bfr);", ""),
                       ("          mma_bf16(yi[pt], sf[kk], bfr);", "")]),
    },
    "rwkv6_wkv": {
        "base": ("the source as it is, built again", []),
        "s1_no_fma": ("step 1 without its products (wrong by design)",
                      [(_K12_FMA, _K12_FMA.replace("s < c", "s < 0"))]),
        "s1_no_scan": ("step 1 without its cumsum (wrong by design)",
                       [(_K12_SCAN1, _K12_SCAN1.replace("t < c", "t < 0"))]),
        "s3_no_scan": ("step 3 without its cumsum (wrong by design)",
                       [(_K12_SCAN3, _K12_SCAN3.replace("t < c", "t < 0"))]),
        "s3_no_bonus": ("step 3 without its bonus (wrong by design)",
                        [(_K12_BONUS, _K12_BONUS.replace("j < K", "j < 0"))]),
        "s3_no_factors": ("step 3 without its factors (wrong by design)",
                          [(_K12_FACT, _K12_FACT.replace("e < c * K", "e < 0"))]),
        "s3_no_state": ("step 3 without the state's part (wrong by design)",
                        [("  for (int jj = 0; jj < K4; jj += 4) {",
                          "  for (int jj = 0; jj < 0; jj += 4) {")]),
    },
}


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown card"


def build_variants() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    procs = {}
    for kernel, variants in VARIANTS.items():
        src = build.source_path(kernel).read_text()
        for name, (_, subs) in variants.items():
            text = src
            for old, new in subs:
                if old not in text:
                    raise SystemExit(f"{kernel} variant {name}: {old!r} not in the source")
                text = text.replace(old, new)
            stem = f"{kernel}_{name}"
            # the variant includes chunk_scan.cuh from the source's directory
            (OUT / f"{stem}.cu").write_text(text)
            cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-I",
                   str(build.source_path(kernel).parent), "-o", str(OUT / f"lib{stem}.so"),
                   str(OUT / f"{stem}.cu")]
            procs[(kernel, name)] = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True)
    libs = {}
    for (kernel, name), proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"{kernel} variant {name} does not build:\n{log[-4000:]}")
        libs[(kernel, name)] = ctypes.CDLL(str(OUT / f"lib{kernel}_{name}.so"))
        print(f"{kernel} {name}: {VARIANTS[kernel][name][0]}", flush=True)
    return libs


def step_ms(fn, tags, reps: int = 20) -> list:
    """Kernel ms of ``fn``'s kernels named by each of ``tags`` (one such
    launch a call), the mean over the launches a ``torch.profiler`` trace
    of ``reps`` calls after a warm-up holds. The trace idles 50 ms on each
    side of the calls: traces that stopped right after their calls held
    fewer kernels than the calls launched."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    out = []
    for tag in tags:
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == torch.autograd.DeviceType.CUDA and tag in e.name]
        if not us:
            raise SystemExit(f"the trace holds no kernel named *{tag}*")
        out.append(sum(us) / len(us) / 1e3)
    return out


def ssd_case(g):
    Bt, S, H, P, N, c = 2, 4096, 80, 64, 64, 128
    x, Bm, Cm = ((torch.randn((Bt, S, H, W), generator=g, device="cuda") * 0.5)
                 .to(torch.bfloat16) for W in (P, N, N))
    a = -torch.nn.functional.softplus(torch.randn((Bt, S, H), generator=g, device="cuda"))
    nc = S // c
    y = torch.empty_like(x)
    st = torch.empty((Bt, H, P, N), dtype=torch.float32, device="cuda")
    ws = torch.empty((Bt, H, nc, P, N), dtype=torch.float32, device="cuda")
    decay = torch.empty((Bt, H, nc), dtype=torch.float32, device="cuda")
    tensors = (x, Bm, Cm, a, y, st, ws, decay)
    ints = (Bt, S, H, P, N, c, H * P, H * N, H * N, 1, 1)
    return "mamba2_ssd_chunked_bf16_model", tensors, ints, (y, st), ("ssd_states", "ssd_out")


def wkv_case(g):
    B, S, H, K, c = 2, 4096, 64, 64, 64
    r, k, v = ((torch.randn((B, S, H, K), generator=g, device="cuda") * 0.5).to(torch.bfloat16)
               for _ in range(3))
    w = (-torch.nn.functional.softplus(torch.randn((B, S, H, K), generator=g, device="cuda"))
         - 0.1).clamp_min(-2.0)
    u = torch.randn((1, H, K), generator=g, device="cuda") * 0.3
    nc = S // c
    y = torch.empty_like(r)
    st = torch.empty((B, H, K, K), dtype=torch.float32, device="cuda")
    ws = torch.empty((B, H, nc, K, K), dtype=torch.float32, device="cuda")
    decay = torch.empty((B, H, nc, K), dtype=torch.float32, device="cuda")
    tensors = (r, k, v, w, u, y, st, ws, decay)
    ints = (B, S, H, K, c, 0, 1, 3)
    return "rwkv6_wkv_chunked_bf16_f32_bf16", tensors, ints, (y, st), ("wkv_states", "wkv_out")


def caller(lib, symbol, tensors, ints):
    """One call of the chunked C entry on these tensors; the caller holds
    them (the kernels write y, the state and the workspace)."""
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptrs = [t.data_ptr() for t in tensors]

    def run():
        rc = fn(*ptrs, *ints, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
    return run


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"card: {card()}", flush=True)
    libs = build_variants()
    g = torch.Generator(device="cuda").manual_seed(5)
    for kernel, case in (("mamba2_ssd", ssd_case), ("rwkv6_wkv", wkv_case)):
        symbol, tensors, ints, outs, tags = case(g)
        base = caller(libs[(kernel, "base")], symbol, tensors, ints)
        base()
        torch.cuda.synchronize()
        want = [t.clone() for t in outs]
        for name in VARIANTS[kernel]:
            run = caller(libs[(kernel, name)], symbol, tensors, ints)
            run()
            torch.cuda.synchronize()
            diff = [float((o.float() - w.float()).abs().max()) for o, w in zip(outs, want)]
            line = [f"{kernel} {name}: max |diff| y {diff[0]} state {diff[1]}"]
            turns = [step_ms(f, tags) for f in (base, run, run, base)]
            for i, step in enumerate((1, 3)):
                b1, v1, v2, b2 = (t[i] for t in turns)
                line.append(f"step {step}: source {(b1 + b2) / 2:.6f} ms, variant "
                            f"{(v1 + v2) / 2:.6f} (turns {b1:.6f}, {v1:.6f}, {v2:.6f}, {b2:.6f})")
            print("; ".join(line), flush=True)
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
