#!/usr/bin/env python3
"""Time variants of K7's ring route against the source as it is.

    PYTHONPATH=src python3 scripts/flash_decode_variants.py

Needs ``nvcc`` and an NVIDIA H100. Each variant is ``csrc/flash_decode.cu``
with a few constants or lines substituted, built by ``nvcc`` with the port's
flags into ``src/repro_torch/_build/variants_k7/`` (all at once), its ptxas
registers and spills printed for the ring kernel at one row a block and at
four. Then, at 4 rows of 4096 keys of zamba2-2.7b (32 KV heads of 80, G = 1)
and of llama3-8b (8 of 128, G = 4), and at mixtral-8x22b's G = 6 (8 of 128), in
bf16, every row full, each variant's
``flash_decode_ring_bf16`` is timed in turns with the unchanged source
(source, variant, variant, source; CUDA events, the mean of 50 calls each
after a warm-up) at the split plan ``ops.ring_plan`` gives, beside the
largest difference of its output from the source's and the card's name and
power limit; then the source at half and twice ``ring_plan``'s split
count, in turns with it. Some variants compute something else on purpose,
to show what a part of the kernel costs: their differences are not errors.

Last, the host time of the wrapper's argument check at the hybrid engine's
short-cache step (4 rows of 128 keys of zamba2-2.7b) as it is (one pass
over a table of what each tensor must be) and with ``check()`` called on
each tensor: the check alone, and one whole ``ops.decode_cuda`` call with
each, in turns (as is, four checks, four checks, as is; three rounds; the
mean over 2000 calls each, timed on the host's clock, the card never
behind).
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import time
from pathlib import Path

import torch

from repro_torch.kernels import build
from repro_torch.kernels.flash_decode import ops
from repro_torch.kernels.launch import check

CSRC = Path(build.source_path("flash_decode")).parent
OUT = CSRC.parent / "_build" / "variants_k7"

_MATH = "    for (int j0 = 0; j0 < NKG; j0 += NS) {"
_LAUNCH = """      (T*)o, Hkv, S, G, D, split_len, scale);
  return (int)cudaGetLastError();"""
# the splits' merge as a launch of its own, a block per (b, h, row block)
_MERGE_KERNEL = """template <typename T>
__global__ void __launch_bounds__(RT) decode_ring_merge(const float* __restrict__ ws,
                                                        T* __restrict__ o, int G, int D, int gb,
                                                        int splits) {
  const int64_t n_part = (int64_t)gridDim.x * splits * G;
  const float* m_part = ws + n_part * D;
  const int g0 = blockIdx.z * gb;
  merge_splits(ws, m_part, m_part + n_part, o, blockIdx.x, g0, min(gb, G - g0), G, D, splits);
}

template <typename T, int L, int GB>
int ring_launch("""
_EXPS = ("          const float corr = expf(m[g] - m_new);",
         "          s[g][j] = expf(s[g][j] - m_new);")

# name -> (what it shows, [(text in the source, its replacement)])
VARIANTS = {
    "base": ("the source as it is, built again", []),
    "stages4": ("four ring stages instead of three",
                [("constexpr int RSTAGES = 3;", "constexpr int RSTAGES = 4;")]),
    "tile64": ("64-key tiles (16 keys a warp) instead of 32",
               [("constexpr int RTK = 32;", "constexpr int RTK = 64;")]),
    "fast_exp": ("__expf for the softmax's exponentials",
                 [(e, e.replace("expf(", "__expf(")) for e in _EXPS]),
    "no_math": ("the copies and waits alone: no score, softmax or P . V (wrong by design)",
                [(_MATH, "    for (int j0 = 0; j0 < (t < 0 ? NKG : 0); j0 += NS) {")]),
    "merge_launch": ("the splits merged in a second launch instead of by the last block",
                     [("  if (splits == 1) return;", "  if (splits > 0) return;"),
                      ("template <typename T, int L, int GB>\nint ring_launch(", _MERGE_KERNEL),
                      (_LAUNCH, _LAUNCH.replace(
                          "  return",
                          "  cudaError_t err = cudaGetLastError();\n"
                          "  if (err != cudaSuccess || splits == 1) return (int)err;\n"
                          "  decode_ring_merge<T><<<dim3(B * Hkv, 1, gz), RT, 0, st>>>(\n"
                          "      (const float*)ws, (T*)o, G, D, GB, splits);\n"
                          "  return"))]),
    "l2_128": ("the copies ask L2 to fetch whole 128-byte lines",
               [("cp.async.cg.shared.global [%0]", "cp.async.cg.shared.global.L2::128B [%0]")]),
    "l2_256": ("the copies ask L2 to fetch 256-byte blocks",
               [("cp.async.cg.shared.global [%0]", "cp.async.cg.shared.global.L2::256B [%0]")]),
}
# the source at other split counts than ring_plan's: its count times these
SPLIT_SCALES = (0.5, 2.0)


def card() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True)
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 else "unknown card"


def build_variants() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    src = build.source_path("flash_decode").read_text()
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
        regs, entry = [], None
        for line in log.splitlines():
            if "Compiling entry function" in line:
                m = re.search(r"decode_ringI13__nv_bfloat16Li(\d+)ELi(\d+)E", line)
                entry = f"<bf16,{m.group(1)},{m.group(2)}>" if m and m.group(2) in "14" else None
            elif entry and "spill stores" in line:
                regs.append(f"{entry} {line.strip().split(',')[1].strip()}")
            elif entry and "Used" in line:
                regs[-1] += " " + re.search(r"Used \d+ registers", line).group(0)
                entry = None
        print(f"{name}: {VARIANTS[name][0]}; {'; '.join(regs)}", flush=True)
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
    return libs


def cuda_ms(fn, reps: int = 50) -> float:
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


def caller(lib, q, k, v, lens, split_scale: float = 1.0):
    """One call of the ring route's C entry on these inputs, with the split
    plan and scratch the wrapper would give it (its split count times
    ``split_scale``: the tiles shared out as evenly as whole tiles allow)."""
    fn = lib.flash_decode_ring_bf16
    fn.argtypes = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 8 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    gz = -(-G // ops.ring_rows(G))
    splits, split_len = ops.ring_plan(S, B * Hkv * gz,
                                      torch.cuda.get_device_properties(0).multi_processor_count)
    if split_scale != 1.0:
        tiles = -(-S // ops.RING_TILE)
        split_len = -(-tiles // min(tiles, max(1, int(splits * split_scale)))) * ops.RING_TILE
        splits = -(-S // split_len)
    ws = torch.empty(B * Hkv * splits * G * (D + 2), dtype=torch.float32, device="cuda")
    cnt = torch.zeros(B * Hkv * gz, dtype=torch.int32, device="cuda")
    tensors = (q, k, v, lens, ws, cnt, torch.empty_like(q))
    ptrs = [t.data_ptr() for t in tensors]

    def run():
        # run holds the tensors: the kernel writes ws and cnt, which must
        # not return to the allocator while it is called
        rc = fn(*ptrs, B, Hkv, S, G, D, splits, split_len, gz,
                torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
        return tensors[-1]
    return run, (splits, split_len)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"card: {card()}", flush=True)
    libs = build_variants()
    g = torch.Generator(device="cuda").manual_seed(5)
    for label, Hkv, G, D in (("zamba2", 32, 1, 80), ("llama3", 8, 4, 128), ("G=6", 8, 6, 128)):
        B, S = 4, 4096
        q = torch.randn((B, Hkv, G, D), generator=g, device="cuda").to(torch.bfloat16)
        k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda").to(torch.bfloat16)
                for _ in range(2))
        lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
        base, plan = caller(libs["base"], q, k, v, lens)
        want = base().clone()
        for name in VARIANTS:
            if name == "base":
                continue
            run, _ = caller(libs[name], q, k, v, lens)
            diff = float((run().float() - want.float()).abs().max())
            b1, v1, v2, b2 = (cuda_ms(f) for f in (base, run, run, base))
            print(f"{label} {B}x{S} (splits, split_len) {plan}: {name}: source "
                  f"{(b1 + b2) / 2:.6f} ms, variant {(v1 + v2) / 2:.6f} ms (turns {b1:.6f}, "
                  f"{v1:.6f}, {v2:.6f}, {b2:.6f}); max |diff| {diff}", flush=True)
        for scale in SPLIT_SCALES:
            run, other = caller(libs["base"], q, k, v, lens, scale)
            diff = float((run().float() - want.float()).abs().max())
            b1, v1, v2, b2 = (cuda_ms(f) for f in (base, run, run, base))
            print(f"{label} {B}x{S}: (splits, split_len) {plan}: {(b1 + b2) / 2:.6f} ms; "
                  f"{other}: {(v1 + v2) / 2:.6f} ms (turns {b1:.6f}, {v1:.6f}, {v2:.6f}, "
                  f"{b2:.6f}); max |diff| {diff}", flush=True)
    check_host_time(g)
    return 0


def _four_checks(q, k, v, lengths):
    """The wrapper's argument check with ``check()`` called on each tensor."""
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    for name, t, dt, shape in (("q", q, q.dtype, (B, Hkv, G, D)), ("k", k, q.dtype, (B, S, Hkv, D)),
                               ("v", v, q.dtype, (B, S, Hkv, D)),
                               ("lengths", lengths, torch.int32, (B,))):
        check(name, t, dt, shape, q.device)
    return B, Hkv, G, D, S


def check_host_time(g, calls: int = 2000) -> None:
    B, S, Hkv, G, D = 4, 128, 32, 1, 80
    q = torch.randn((B, Hkv, G, D), generator=g, device="cuda").to(torch.bfloat16)
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda").to(torch.bfloat16)
            for _ in range(2))
    lens = torch.full((B,), 100, dtype=torch.int32, device="cuda")
    table = ops._check

    def check_us(fn) -> float:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn(q, k, v, lens)
        return (time.perf_counter() - t0) / calls * 1e6

    def call_us(fn) -> float:
        ops._check = fn
        try:
            for _ in range(20):
                ops.decode_cuda(q, k, v, lens)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(calls):
                ops.decode_cuda(q, k, v, lens)
            t = time.perf_counter() - t0
            torch.cuda.synchronize()
            return t / calls * 1e6
        finally:
            ops._check = table

    for what, timer in (("the check alone", check_us), ("decode_cuda", call_us)):
        for rnd in range(3):
            a1, f1, f2, a2 = (timer(fn) for fn in (table, _four_checks, _four_checks, table))
            print(f"{what} at {B}x{S} zamba2-2.7b, round {rnd}: table check "
                  f"{(a1 + a2) / 2:.3f} us, four check() calls {(f1 + f2) / 2:.3f} us (turns "
                  f"{a1:.3f}, {f1:.3f}, {f2:.3f}, {a2:.3f})", flush=True)


if __name__ == "__main__":
    sys.exit(main())
