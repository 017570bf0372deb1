#!/usr/bin/env python3
"""Time variants of the chunked routes of K8b and K12b (the scans'
backward kernels) against the sources as they are, launch by launch.

    PYTHONPATH=src python3 scripts/scan_bwd_variants.py

Needs ``nvcc`` and an NVIDIA H100. Each variant is ``csrc/mamba2_ssd_bwd.cu``
or ``csrc/rwkv6_wkv_bwd.cu`` with a few lines substituted, built by ``nvcc``
with the port's flags into ``src/repro_torch/_build/variants_scan_bwd/`` (all
at once). At the training phases' shapes, a layer of each (zamba2-2.7b: x, B
and C (2, 4096, 80, 64) bf16, chunk 128, the model's function; rwkv6-7b: r,
k, v, dy (2, 4096, 64, 64) bf16, w float32, chunk 64, bf16 intra-chunk
operands), inputs drawn on the card from seed 5, each variant's chunked C
entry (its three launches) is run in turns with the unchanged source
(source, variant, variant, source; each turn 10 calls after a warm-up under
``torch.profiler``), and the kernel time a call of step 1 (the increments),
step 2 (the state passes) and step 3 (the gradients) is read from each
turn's trace; beside them, the largest difference of the variant's first
gradient from the source's, and the card's name and power limit. The
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

OUT = Path(build.source_path("mamba2_ssd_bwd")).parent.parent / "_build" / "variants_scan_bwd"


def _skip(loop: str, cond: str, empty: str):
    """A substitution that makes the loop starting with ``loop`` run no
    iteration (``cond`` replaced by ``empty``)."""
    return (loop, loop.replace(cond, empty))


_W1_FMA = "  for (int s = 0; s < c; ++s) {\n    float ka[4], va[4], ra[4], ya[4];"
_W1_SCAN = "    for (int t = 0; t < c; ++t) {\n      const float wv = sW[t * LDW + tid];"
_W1_EXP = ("    sC[t * LDW + jj] = to_f(sK[t * LDW + jj]) * expf(vTot[jj] - sC[t * LDW + jj]);\n"
           "    sW[t * LDW + jj] = to_f(sR[t * LDW + jj]) * expf(sW[t * LDW + jj]);")
_W3_SCAN = "    for (int t = 0; t < c; ++t) {\n      const float wv = m.sD[t * LDF + tid];"
_W3_FACT = ("  for (int e = tid; e < c * K; e += NTG) {\n    const int t = e / K, j = e - t * K;\n"
            "    const float d = m.sD")
_W3_STATE = "    for (int ks = 0; ks < K16; ks += 16) {\n      uint32_t ay[4], av[4], ah[4], al[4];"
_W3_EXP = ("          const float ed = expf(d), edm = expf(d - mm), emc = expf(mm - cs);\n"
           "          const float etc = expf(tot - cs);")
_W3_TAIL1 = "    for (int t = run * rq; t < (run + 1) * rq; ++t) sum += m.Gcs[t * LDF + j];"
_W3_TAIL2 = "    for (int t = (run + 1) * rq - 1; t >= run * rq; --t) {"
_S1_FMA = "  for (int s = 0; s < c; ++s) {\n    float xa[4], ya[4], ba[4], ca[4];"
_S3_KS = ("      for (int ks = 0; ks < {w}; ks += 16) {{\n        uint32_t af[4];\n"
          "        frag(af, m.s{x},")
_S3_DC = _S3_KS.format(w="P16", x="Y")
_S3_DB = _S3_KS.format(w="P16", x="X")
_S3_DX = _S3_KS.format(w="N16", x="B")
_S3_TAIL1 = "    for (int t = lo; t < hi; ++t) run += term(t);"
_S3_TAIL2 = "    for (int t = hi - 1; t >= lo; --t) {"

# kernel -> name -> (what it shows, [(text in the source, its replacement)])
VARIANTS = {
    "rwkv6_wkv_bwd": {
        "base": ("the source as it is, built again", []),
        "s1_no_fma": ("step 1 without its two products", [_skip(_W1_FMA, "s < c", "s < 0")]),
        "s1_no_scan": ("step 1 without its cumsum", [_skip(_W1_SCAN, "t < c", "t < 0")]),
        "s1_no_exp": ("step 1 without the exps of KW and RD",
                      [(_W1_EXP, _W1_EXP.replace("expf", ""))]),
        "s3_no_scan": ("step 3 without its cumsum", [_skip(_W3_SCAN, "t < c", "t < 0")]),
        "s3_no_factors": ("step 3 without RF, KF and KW",
                          [_skip(_W3_FACT, "e < c * K", "e < 0")]),
        "s3_no_mma": ("step 3 without its tensor-core products",
                      [("            mma_bf16(sc[nt], af, bfr);", ""),
                       ("          mma_bf16(gRF[vt], af, bfr);", ""),
                       ("          mma_bf16(gKF[vt], dat, bfr);", ""),
                       ("          mma_bf16(gVi[vt], at, bfr);", "")]),
        "s3_no_state": ("step 3 without its state products (hi + lo halves on the tensor cores)",
                        [_skip(_W3_STATE, "ks < K16", "ks < 0")]),
        "s3_no_exp": ("step 3's outputs without their four exps",
                      [(_W3_EXP, _W3_EXP.replace("expf", ""))]),
        "s3_no_tail": ("step 3 without dw's reverse cumsum",
                       [_skip(_W3_TAIL1, "t < (run + 1) * rq", "t < run * rq"),
                        _skip(_W3_TAIL2, "t >= run * rq", "t >= (run + 1) * rq")]),
    },
    "mamba2_ssd_bwd": {
        "base": ("the source as it is, built again", []),
        "s1_no_fma": ("step 1 without its two products", [_skip(_S1_FMA, "s < c", "s < 0")]),
        "no_scan": ("steps 1 and 3 without the cumsum of a",
                    [("    for (int t = 0; t < c; ++t) {\n      acc += vA[t];",
                      "    for (int t = 0; t < 0; ++t) {\n      acc += vA[t];")]),
        "s3_no_score_mma": ("step 3's scores without their tensor-core products",
                            [("        mma_bf16(sc[nt], af, bfr);", ""),
                             ("        mma_bf16(gv[nt], af, bfr);", "")]),
        "s3_no_mma": ("step 3's outputs without their tensor-core products",
                      [("            mma_bf16(acc1[nt], af, bfr);", ""),
                       ("            mma_bf16(acc1[pt], af, bfr);", "")]),
        "s3_no_state": ("step 3 without its state products (hi + lo halves on the tensor cores)",
                        [_skip(_S3_DC, "ks < P16", "ks < 0"), _skip(_S3_DB, "ks < P16", "ks < 0"),
                         _skip(_S3_DX, "ks < N16", "ks < 0")]),
        "s3_no_mask_exp": ("step 3's decay mask without its exp",
                           [("const float L = expf(m.vCs[q] - m.vCs[s + o]);",
                             "const float L = 1.f;")]),
        "s3_no_tail": ("step 3 without da's reverse cumsum",
                       [_skip(_S3_TAIL1, "t < hi", "t < lo"),
                        _skip(_S3_TAIL2, "t >= lo", "t >= hi")]),
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
                if text.count(old) < 1:
                    raise SystemExit(f"{kernel} variant {name}: {old!r} not in the source")
                text = text.replace(old, new)
            stem = f"{kernel}_{name}"
            # the variant includes the headers from the source's directory
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


def step_ms(fn, tags, reps: int = 10) -> list:
    """Kernel ms of ``fn``'s kernels named by each of ``tags`` (one such
    launch a call), the mean over the launches a ``torch.profiler`` trace
    of ``reps`` calls after a warm-up holds; the trace idles 50 ms on each
    side of the calls."""
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
    x, Bm, Cm, dy = ((torch.randn((Bt, S, H, W), generator=g, device="cuda") * 0.5)
                     .to(torch.bfloat16) for W in (P, N, N, P))
    a = -torch.nn.functional.softplus(torch.randn((Bt, S, H), generator=g, device="cuda"))
    nc = S // c
    grads = [torch.empty_like(t) for t in (x, Bm, Cm, a)]
    ws = [torch.empty((Bt, H, nc, P, N), dtype=torch.float32, device="cuda") for _ in range(2)]
    decay = torch.empty((Bt, H, nc), dtype=torch.float32, device="cuda")
    tensors = (x, Bm, Cm, a, dy, None, *grads, *ws, decay)
    ints = (Bt, S, H, P, N, c, H * P, H * N, H * N, 1)
    return ("mamba2_ssd_bwd_chunked_bf16_model", tensors, ints, grads[0],
            ("ssd_bwd_states", "state_pass", "ssd_grad"))


def wkv_case(g):
    B, S, H, K, c = 2, 4096, 64, 64, 64
    r, k, v, dy = ((torch.randn((B, S, H, K), generator=g, device="cuda") * 0.5)
                   .to(torch.bfloat16) for _ in range(4))
    w = (-torch.nn.functional.softplus(torch.randn((B, S, H, K), generator=g, device="cuda"))
         - 0.1).clamp_min(-2.0)
    u = torch.randn((1, H, K), generator=g, device="cuda") * 0.3
    nc = S // c
    grads = [torch.empty_like(t) for t in (r, k, v, w)]
    dup = torch.empty((B, H, nc, K), dtype=torch.float32, device="cuda")
    ws = [torch.empty((B, H, nc, K, K), dtype=torch.float32, device="cuda") for _ in range(2)]
    decay = torch.empty((B, H, nc, K), dtype=torch.float32, device="cuda")
    tensors = (r, k, v, w, u, dy, None, *grads, dup, *ws, decay)
    ints = (B, S, H, K, c, 0, 3)
    return ("rwkv6_wkv_bwd_chunked_bf16_f32_bf16", tensors, ints, grads[0],
            ("wkv_bwd_states", "state_pass", "wkv_grad"))


def caller(lib, symbol, tensors, ints):
    """One call of the chunked C entry on these tensors; the caller holds
    them (the kernels write the gradients and the workspaces)."""
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptrs = [None if t is None else t.data_ptr() for t in tensors]

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
    for kernel, case in (("mamba2_ssd_bwd", ssd_case), ("rwkv6_wkv_bwd", wkv_case)):
        symbol, tensors, ints, out, tags = case(g)
        base = caller(libs[(kernel, "base")], symbol, tensors, ints)
        base()
        torch.cuda.synchronize()
        want = out.clone()
        for name in VARIANTS[kernel]:
            run = caller(libs[(kernel, name)], symbol, tensors, ints)
            run()
            torch.cuda.synchronize()
            diff = float((out.float() - want.float()).abs().max())
            line = [f"{kernel} {name}: max |diff| of the first gradient {diff}"]
            turns = [step_ms(f, tags) for f in (base, run, run, base)]
            for i, step in enumerate((1, 2, 3)):
                b1, v1, v2, b2 = (t[i] for t in turns)
                line.append(f"step {step}: source {(b1 + b2) / 2:.6f} ms, variant "
                            f"{(v1 + v2) / 2:.6f} (turns {b1:.6f}, {v1:.6f}, {v2:.6f}, {b2:.6f})")
            print("; ".join(line), flush=True)
        del tensors, out, want
        torch.cuda.empty_cache()
    print(card(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
