#!/usr/bin/env python3
"""Time variants of K3's staged and values kernels against the source as it
is, part by part.

    PYTHONPATH=src python3 scripts/chain_variants.py

Needs ``nvcc`` and an NVIDIA H100. Each variant is ``csrc/chain_ordinals.cu``
with a few lines substituted, built by ``nvcc`` with the port's flags into
``src/repro_torch/_build/variants_chain/`` (all at once; the ``-Xptxas -v``
lines of the unchanged source printed). At the tuner run's largest call
(268 chains, d = 60, 16 background rows, 10 trees, one word; the inputs of
``scripts/chain_routes.py``), each variant's ``chain_staged_launch`` and
``chain_values_launch`` is run in turns with the
unchanged source (source, variant, variant, source; each turn's kernel
time from a ``torch.profiler`` trace of 10 calls), under the plan the
wrappers take; the unchanged source is also timed on grids of 1, 2 and
3 chains a block, each with blocks of 160, 256, 320 and 512 threads (the
walk's levels cut into 1, 1, 2 and 3 segments at 16 x 10 pairs). Variants that leave a part out compute something else on
purpose, to show what that part costs.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import chain_routes  # noqa: E402
import chip_smoke as smoke  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.forest_eval import chain  # noqa: E402
from repro_torch.kernels.launch import n_sms  # noqa: E402

OUT = build.source_path("chain_ordinals").parent.parent / "_build" / "variants_chain"

_BG = "  copy_rows(bg, wb + (size_t)t0 * W, nb * d);"
_PREFIX1 = "    for (int u = tid; u < segs * tnW; u += nth) {"
_PREFIX2 = "    for (int u = tnW + tid; u < segs * tnW; u += nth) {"
_WALK = "    for (int u = tid; u < hs * np; u += nth) {\n      const int h = u / np, p = u - h * np, b = p / tn, tl = p - b * tn;\n      const u64* bq"
_NEXT = "    if (c + ahead * groups < C) stage(c + ahead * groups, slot);"
_PASSA = "    for (int u = np + tid; u < hs * np; u += nth) {"
_J = "          const int j = kk > lo ? sperm[kk - 1] * rw : 0;"
_P = "          p0w[i] = kk >= lo ? pq[kk * rw] : 0ull;"
_B = "          b0w[i] = kk > lo ? bq[j] : kOnes;"
_FFS = "  if (W == 1 || a0 != 0ull) return lowest_bit(a0);"
_DIV = "        s = __ddiv_rn(s, tdiv);"
_LOWBIT = "  return lo ? __ffs(lo) - 1 : (hi ? 31 + __ffs(hi) : -1);"
_PAIR = "        const double s = __dadd_rn(pairwise<kPairwiseDepth>(rows + (size_t)k * nb, nb), 0.0);"
_ROWS = "      for (int i = tid; i < (d + 1) * nb; i += nth) {"
_LEVELS = "      for (int k = tid; k <= d; k += nth) {"
_STORE = "            op[(size_t)kk * ostep] = ord[i];"
_STOREB = "            ob[kk * ostep] = (unsigned char)ord[i];"
_ORD = "          ord[i] = exit_ordinal<W>(p0w[i] & s0, p1w[i] & s1);"

# name -> (what it shows, [(text in the source, its replacement)])
VARIANTS = {
    "base": ("the source as it is, built again", []),
    "no_bg": ("no background words staged (wrong by design)", [(_BG, "")]),
    "no_prefix": ("no prefix table built (wrong by design)",
                  [(_PREFIX1, _PREFIX1.replace("u < segs", "u < 0 * segs")),
                   (_PREFIX2, _PREFIX2.replace("u < segs", "u < 0 * segs"))]),
    "no_walk": ("no walk (wrong by design)", [(_WALK, _WALK.replace("u < hs * np", "u < 0"))]),
    "no_pass_a": ("no upper walk segments' ANDs (wrong by design)",
                  [(_PASSA, _PASSA.replace("u < hs * np", "u < 0"))]),
    "skeleton": ("no prefix table, upper segments' ANDs or walk: staging and syncs alone",
                 [(_PREFIX1, _PREFIX1.replace("u < segs", "u < 0 * segs")),
                  (_PREFIX2, _PREFIX2.replace("u < segs", "u < 0 * segs")),
                  (_PASSA, _PASSA.replace("u < hs * np", "u < 0")),
                  (_WALK, _WALK.replace("u < hs * np", "u < 0"))]),
    "skeleton_no_bg": ("the skeleton without the background words",
                       [(_BG, ""),
                        (_PREFIX1, _PREFIX1.replace("u < segs", "u < 0 * segs")),
                        (_PREFIX2, _PREFIX2.replace("u < segs", "u < 0 * segs")),
                        (_PASSA, _PASSA.replace("u < hs * np", "u < 0")),
                        (_WALK, _WALK.replace("u < hs * np", "u < 0"))]),
    "walk_no_perm": ("the walk's features in order, not by the permutation (wrong by design)",
                     [(_J, "          const int j = kk > lo ? (kk - 1) * rw : 0;")]),
    "walk_no_pref": ("the walk without the prefix words (wrong by design)",
                     [(_P, "          p0w[i] = kOnes;")]),
    "walk_no_bg": ("the walk without the background words (wrong by design)",
                   [(_B, "          b0w[i] = kk > lo ? (u64)j : kOnes;")]),
    "walk_no_ffs": ("the exit ordinal as the low 6 bits (wrong by design)",
                    [(_FFS, "  if (W == 1 || a0 != 0ull) return (int)(a0 & 63);")]),
    "ffs_builtin": ("the lowest set bit by __ffsll", [(_LOWBIT, "  return __ffsll((long long)a) - 1;")]),
    "ffs_popc": ("the lowest set bit by a population count",
                 [(_LOWBIT, "  return a ? __popcll((a & (0ull - a)) - 1ull) : -1;")]),
    "tail_no_div": ("values: the tree sum multiplied by T, not divided (wrong by design)",
                    [(_DIV, "        s = __dmul_rn(s, tdiv);")]),
    "tail_no_pairwise": ("values: each level's first row, not the rows' sum (wrong by design)",
                         [(_PAIR, "        const double s = rows[(size_t)k * nb];")]),
    "no_next": ("no copy of the chain after next (wrong by design)", [(_NEXT, "")]),
    "store_only": ("the walk's stores alone (wrong by design)",
                   [(_ORD, "          ord[i] = k - i;")]),
    "no_tail": ("values: no tree sums and no row means (wrong by design)",
                [(_ROWS, _ROWS.replace("i < (d", "i < 0 * (d")),
                 (_LEVELS, _LEVELS.replace("k <= d", "k < 0"))]),
}


def build_variants() -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    src = build.source_path("chain_ordinals").read_text()
    texts = {}
    for name, (_, subs) in VARIANTS.items():
        text = src
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in the source")
            text = text.replace(old, new)
        texts[name] = text
    procs = {}
    for name, text in texts.items():
        (OUT / f"{name}.cu").write_text(text)
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, "-o", str(OUT / f"lib{name}.so"),
               str(OUT / f"{name}.cu")]
        procs[name] = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                       text=True)
    libs, failed = {}, []
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"variant {name} does not build:\n{log[-4000:]}")
            continue
        if name == "base":
            print("\n".join(line for line in log.splitlines()
                            if "Compiling" in line or "registers" in line or "spill" in line))
        libs[name] = ctypes.CDLL(str(OUT / f"lib{name}.so"))
        print(f"variant {name}: {VARIANTS[name][0]}", flush=True)
    if failed:
        raise SystemExit("\n".join(failed))
    return libs


def caller(lib, symbol, tensors, ints, doubles=()):
    fn = getattr(lib, symbol)
    fn.argtypes = ([ctypes.c_void_p] * len(tensors) + [ctypes.c_int] * len(ints)
                   + [ctypes.c_double] * len(doubles) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    ptrs = [None if t is None else t.data_ptr() for t in tensors]

    def run():
        rc = fn(*ptrs, *ints, *doubles, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"CUDA error {rc}")
    return run


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("needs a CUDA device")
    print(f"[card] {smoke.card_line()}", flush=True)
    libs = build_variants()
    dev = torch.device("cuda")
    args = chain_routes.inputs(268, 16, 10, 1, dev)
    words, xoc, wb, perms, lm, offs, y_std, y_mean = args
    C, d, nb, T, W = 268, 60, 16, 10, 1
    out = torch.empty((C, d + 1, nb, T), dtype=torch.int32, device=dev)
    vals = torch.empty((C, d + 1), dtype=torch.float64, device=dev)
    sp = chain.ordinals_plan(C, d, nb, T, W, n_sms(dev))
    vp = chain.values_plan(C, d, nb, T, W, lm.numel(), n_sms(dev))
    print(f"[plan] staged {sp} values {vp}", flush=True)
    calls = {
        "staged": ("chain_staged_launch", "chain_staged_kernel", (words, xoc, wb, perms, out),
                   (C, d, nb, T, W, sp.trees, sp.groups, chain._THREADS), ()),
        "values": ("chain_values_launch", "chain_values_kernel",
                   (words, xoc, wb, perms, lm, offs, vals),
                   (C, d, nb, T, W, lm.numel(), vp.groups, chain._THREADS), (y_std, y_mean)),
    }
    for label, (symbol, tag, tensors, ints, doubles) in calls.items():
        base = caller(libs["base"], symbol, tensors, ints, doubles)
        # the plan's groups sit at ints[6], the block's threads at ints[7]
        for per_block in (1, 2):
            for threads in (256, 320):
                grid = list(ints)
                grid[6], grid[7] = -(-C // per_block), threads
                fn = caller(libs["base"], symbol, tensors, tuple(grid), doubles)
                print(f"[grid] {label}: {grid[6]} blocks ({per_block} chains a block) of "
                      f"{threads} threads: {smoke.traced_call_ms(fn, [(tag, 1)])[0]} ms",
                      flush=True)
        for name in VARIANTS:
            if name == "base" or (name.startswith(("no_tail", "tail_")) and label != "values"):
                continue
            var = caller(libs[name], symbol, tensors, ints, doubles)
            t = [smoke.traced_call_ms(fn, [(tag, 1)])[0] for fn in (base, var, var, base)]
            print(f"[variant] {label} {name}: turns {t} ms; source "
                  f"{(t[0] + t[3]) / 2:.6f}, variant {(t[1] + t[2]) / 2:.6f}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
