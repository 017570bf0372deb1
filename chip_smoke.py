"""Smoke run of the PyTorch/CUDA port of MFTune on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, in order:

1. the card's name and power limit (``nvidia-smi``);
2. the build of the CUDA kernels from ``src/repro_torch/csrc`` (one
   ``nvcc`` per source, all at once), with the ``-Xptxas -v`` register and
   spill lines; K1's tiled kernel, K2's count and onesweep kernels, K3's
   staged kernel, the fused propose step's Q1 and Q2, the
   wgmma routes of K4, K5 and K6 (at every head dim) and
   of K9 (its prefill kernel and its decode kernel at N = 16, 32 and 64),
   K11's cluster kernel (every dtype pair), K10's resident kernel (every
   dtype pair and row width) and K7's ring kernel (every dtype, lane count
   and row block) must build with no spill and no serialized wgmma;
3. ``tuner``: ``repro_torch.core.MFTune`` on TPC-H 100 GB, hardware A, for
   24 virtual hours against a knowledge base of the other 31 tasks of the
   grid, with every kernel's launch count reset just before the run and
   read just after (each must be > 0, every K1 launch on its ``tiled``
   route, every K2 launch on ``count`` and every K3 launch on ``values``
   or ``staged``); the inputs of each kernel's largest call in the run are
   kept; then the same run again with every chain walk on K3's ``staged``
   route and the torch tail, whose observation stream must be the first
   run's (its wall and ``shapley_attribution`` span beside the first's);
4. ``kernels``: each kernel launched on those inputs and held against its
   plain PyTorch version on the same card (exact equality), then timed with
   CUDA events beside its plain version, a PyTorch library yardstick where
   one exists, and its bound; K1 and K2 also against their first designs
   (the ``gather`` and ``block`` routes) in turns (first, new, new, first), by
   CUDA events and by their kernels' durations in ``torch.profiler``
   traces, beside an empty kernel's trace time (the launch floor); K1's
   kernel time summed over the tuner run for both routes in turns, from a
   profiler trace of each distinct shape times its count; then K1 and K2
   the same way at 131072 candidates, the scale of the fused propose step,
   where K1 must take ``tiled`` and K2 ``onesweep`` (with K2's design
   floor: 8 passes of 24 bytes an element, plus the keys in and the ranks
   out); K3 at the tuner run's largest call: every route of the ordinals
   (``per_chain``, ``staged``, ``staged`` on the chains' rows) and of the
   chain values (``values``, and each ordinals route with the torch tail)
   held to the plain versions bit for bit with no host sync
   (``set_sync_debug_mode("error")``), the ordinals' kernel timed by trace
   in turns (per_chain, staged, staged, per_chain) beside its bound, the
   values kernel beside its own, all kernels of a chain-values call and its
   host clock ending in the copy to the host in turns (per_chain and the
   tail, values, values, per_chain), K3's kernel time summed over the tuner
   run on each route in turns; and K3 the same way at sizes the tuner does
   not reach (a two-word forest, 120 trees tiled, 64 features, 512
   chains);
5. ``propose``: the fused propose step (ROADMAP item 7). The 24 h tuner
   run again with ``acquisition_backend="fused", acquisition_pool="host"``
   from the same knowledge base, which must give the staged run's
   observation stream with every recommend call a CUDA-graph replay (as
   many replays as ``propose_step`` spans, no staged ``acquisition`` span),
   at most one graph more than its pool buckets, launches of Q2 and K2 and
   no plain call (its wall and spans beside the staged run's); then the
   step at 12 sources x 10 trees over the 60-knob space at every pool
   bucket from 256 to 131072, both descents through the engine's graphs
   with no host sync before the result's copy and the counts reset just
   before and read just after (every selection the staged path's; K1, K2,
   Q1 and Q2 each launched), Q1 (``csrc/qs_descent.cu``) and Q2
   (``csrc/combine_ei.cu``) against their plain versions bit for bit at
   every bucket, and at 256 and 131072: Q1 against K1 ``tiled`` by trace in
   turns (K1, Q1, Q1, K1), Q2 against the staged torch combine + EI, each
   beside its bound and the launch floor, the step's device time a call by
   stage and its host clock, graph against eager; the device pool at
   131072 (fresh draws a replay, the same pools from one seed);
6. ``baselines``: the paper's seven baseline tuners (``repro_torch.baselines``:
   random search, vanilla BO, LOCAT, TopTune, Rover, LOFTune, Tuneful) at the
   tuner phase's setting (TPC-H 100 GB, hardware A, the 31-task knowledge
   base, 24 virtual hours, seed 0), each on a knowledge base of the same
   source records and no target record (Rover adds its own), the counts
   reset just before each run and read just after: each must find a finite
   best and reach no plain version, K1 must launch in bo, locat, loftune and
   rover and K2 in rover; each tuner's evaluations, best, wall, host seconds
   by stage and launches, and MFTune's best from the tuner phase beside
   them; the largest K1 and K2 calls of these runs held against their plain
   versions (exact) and timed; Rover's trace exported with the port's
   ``export_perfetto`` and ``export_jsonl``, read back and validated
   against the port's schema; then each tuner, and MFTune with each of the
   four space-compression variants (Box, Decrease, Project, Vote), at 8 h
   on the ``agree`` phase's 2-task knowledge base on ``cuda`` and then on
   ``cpu``, whose observation streams and trajectories must be identical,
   each compressor called;
7. ``serve``: the LM serving path at the full width of llama3-8b (32
   layers, d_model 4096, 32/8 heads of 128, d_ff 14336, vocab 128256,
   bf16, 16 GB of weights drawn on the card from seed 0): a 2 x 4096-token
   prefill through ``repro_torch.models.forward`` with
   ``attn_impl="flash"``, with K4's counts reset just before it and read
   just after (32 launches, no plain call), held against the plain blocked
   route (logits within 5e-2 of their largest magnitude, softmax within
   5e-2); ``ServingEngine`` answering 4 greedy requests of 64 prompt tokens
   with 32 new tokens each; one decode step of the engine's batch, which
   must launch K7 32 times; a 64-token prompt teacher-forced through
   ``decode_step`` against ``forward`` (the same bounds, which must sit 4x
   under what another first context token does to the logits); a
   ``torch.profiler`` breakdown of one prefill and one decode step (kernel
   count, device busy share of the unprofiled wall, the costliest
   kernels); a long-context decode step of 4 rows whose cache holds 4096
   keys each, drawn on the card from seed 6, which must launch K7 32 times
   on its ring route, with logits within 5e-2 of their largest magnitude of
   the first design's, timed by wall and profiled device busy with each K7
   route in turns (first, ring, ring, first); then K4 on the prefill's own
   inputs against its plain version, in bf16 (o within one bf16 step plus
   1e-3) and upcast to float32 (o within 2e-5; lse within 1e-3 in both),
   timed beside it, beside the earlier CUDA-core design of its bf16 route
   in turns (that, this, this, that) and beside ``scaled_dot_product_attention`` with KV expanded to all
   heads (timed only), its float32 route timed too, and K4 at small shapes
   in both dtypes for every mask variant, rows that see no key included;
8. ``train``: the dense training path at llama3-8b's full width with its
   depth cut from 32 to 8 layers (the cut, with its reason, is printed): bf16
   weights drawn on the card from seed 0, float32 AdamW moments, a batch of
   2 x 4096 tokens from ``SyntheticTokenPipeline(seed=0)``, ``attn_impl=
   "flash"``, lr 1e-5. ``Trainer.run(3)`` with the counts of K4, K5 and K6 reset
   just before it and read just after (8 x 3 launches each, no plain call),
   finite losses and a first loss within 1 of ln(128256); three
   ``make_train_step`` steps on one repeated batch, whose loss must fall;
   one ``loss_fn`` gradient through the flash route and the plain ``xla``
   route from the same weights and batch (loss within 1e-2, each gradient
   leaf within 5e-2 relative in L2 and 4x under what another batch does to
   it); a ``torch.profiler`` breakdown of one step; then K5 and K6 on the
   first layer's own inputs against their plain versions (bf16 within one
   bf16 step plus 1e-3 of the largest magnitude, float32 within 2e-5),
   timed beside them, each bf16 route in turns with its CUDA-core design
   (that, this, this, that), beside the backward of
   ``scaled_dot_product_attention`` (timed only), their bounds and their
   own floors (p and ds as hi + lo halves: four products for K5, six for
   K6), their float32 routes timed too, and at small shapes (head dim 80
   among them) in both dtypes for every mask variant; K4 at its
   first call in ``Trainer.run`` as in every path below: against its
   plain version, then timed in turns with the CUDA-core design, beside SDPA
   and its bound;
9. ``moe``: the MoE serving path at mixtral-8x22b's full width with its
   depth cut from 56 to 8 layers (the cut, with its reason, is printed):
   d_model 6144, 48/8 heads of 128, 8 experts top-2 of width 16384, vocab
   32768, window 4096, bf16 weights drawn on the card from seed 0 (40.9
   GB). A 1 x 8192-token prefill through ``forward`` with
   ``attn_impl="flash"``, counts reset just before it and read just after
   (24 K9 launches, all on its wgmma route, and 8 K4 launches, no plain
   call); layer 0's MoE rerun on that
   prefill's own input with K9's plain version (identical routing, output
   within 5e-2 of its largest magnitude); the prefill through the plain
   route (K9's plain version, ``attn_impl="xla"``), its logits within 5e-2
   of their largest magnitude at the sampled positions that both routes
   route alike (the same kept experts at every layer; at least 90 % of the
   positions must); ``ServingEngine`` answering 4 greedy requests of 64
   prompt tokens with 32 new tokens each, and 24 K9 launches (all on its
   wgmma_decode route) and 8 K7 launches in one decode step; a 64-token
   prompt teacher-forced through ``decode_step`` against ``forward`` at a
   capacity that drops nothing (the same bounds, 4x under
   what another first context token does); a profiled prefill and decode
   step; K9 on the first layer's w_gate and w_down inputs against its plain
   version in bf16 (one bf16 step of the largest magnitude) and upcast to
   float32 (2e-5), timed in turns with PR 14's mma.sync design (that, this,
   this, that), beside its plain version, ``torch.bmm`` and its bound, and
   the same at a decode step's w_gate and w_down shapes; then every route
   at small, ragged and decode shapes with group sizes (0, a partial tile,
   past C, NaN past each), the route taken asserted;
   K4 at its first call (window 4096 at 8192 tokens, SDPA with a boolean
   mask);
10. ``ssm``: the SSM serving path at rwkv6-7b's full width and depth (32
   layers, d_model 4096, 64 WKV heads of 64, d_ff 14336, vocab 65536, chunk
   64, bf16 weights drawn on the card from seed 0, 16.1 GB; ``u_bonus`` and
   the token-shift mixes, zero by the init rules, drawn from seed 1). A
   2 x 4096-token prefill through ``forward``, counts reset just before it
   and read just after (32 K12 and 97 K10 launches, no plain call); the
   plain route (K12's and K10's plain versions) beside it, each layer's
   time mix and channel mix held against the plain route on the same input
   within two bf16 steps of their largest magnitude; ``ServingEngine``
   answering 4 greedy requests of 64 prompt tokens with 32 new tokens each
   (97 K10 launches a step, no K12); a 64-token prompt layer by layer, each
   layer's time mix and channel mix through the decode forms (the float32
   recurrence) against the forward's (the chunked K12) on the same input,
   the same bounds; in float32 activations (the bf16 weights upcast) the
   two routes' logits on a 1 x 2048 prefill, and decode teacher-forced
   against ``forward`` with K12 in its float32-products function, each
   within 5e-2 of their largest magnitude, 4x under what another first
   token does to the logits; a profiled prefill and decode step; K12 on
   the first layer's inputs against its plain version in the model's
   function (bf16 intra-chunk operands) and the Pallas kernel's (float32
   products), timed beside it and its bound (float32 operations at the
   float32 rate, the bf16-operand intra-chunk products at the bf16 rate); K10
   and K11 on the prefill's first ln1 input (8192 x 4096 bf16) against
   their plain versions, timed beside ``torch.nn.functional.rms_norm`` and
   its autograd backward, K10 in turns with its first (two-pass) design, K11
   in turns with its first one-block-a-tile design and with its partials'
   sum; then all three at small and ragged shapes
   (K11 on both its layouts). The
   ``serve``, ``train`` and ``moe`` phases count K10 too, and ``train`` K11
   (the backward of every norm), each with its route (K10 resident, K11
   cluster, and K7 ring in every decode step that counts it); a decode step here launches no K7 (no
   attention);
11. ``hybrid``: the hybrid serving path at zamba2-2.7b's full width and depth
   (54 Mamba2 layers, d_model 2560, 80 SSD heads of P = N = 64, conv 4,
   chunk 128; one shared attention + FFN block after every 6 layers, 32
   heads of 80, d_ff 10240; vocab 32000; bf16 weights drawn on the card from
   seed 0, 7.64 GB; D and dt_bias, zero by the init rules, drawn from seed
   1). A 2 x 4096-token prefill through ``forward`` with ``attn_impl=
   "flash"``, counts reset just before it and read just after (54 K8, 9 K4
   at head dim 80 and 127 K10 launches, no plain call); the plain route (K8's
   and K10's plain versions, ``attn_impl="xla"``) beside it, each Mamba2
   block and each shared block's attention and FFN held against the plain
   route on the same input within two bf16 steps of their largest
   magnitude; ``ServingEngine`` answering 4 greedy requests of 64 prompt
   tokens with 32 new tokens each (9 K7 and 127 K10 launches a step, no K8);
   in float32 activations the two routes' logits on a 1 x 2048 prefill, and
   a 64-token prompt teacher-forced through ``decode_step`` (the float32
   recurrence, K7) against ``forward`` (K8), each within 5e-2 of their
   largest magnitude, 4x under what another first token does to the later
   positions; a profiled prefill and decode step; K8 on the first layer's
   inputs against its plain version in the model's function and the Pallas
   kernel's, timed beside it and its bound (float32 operations at the
   float32 rate, the bf16-operand intra-chunk products at the bf16 rate); K7
   at the engine's decode step and at caches of 4 x 4096 keys of zamba2,
   llama3-8b and mixtral-8x22b, both routes against its plain version, the
   ring route timed in turns with the first design (first, ring, ring,
   first), beside the plain version, SDPA and its bound (the bytes of the
   cache); K4 at its first call (head dim 80);
12. ``train_ssm`` and ``train_hybrid``: training of rwkv6-7b with its depth
    cut from 32 to 8 layers and of zamba2-2.7b cut from 54 to 18 (three
    whole groups of 6, so the shared attention block fires), both at full
    width, vocab and sequence (the memory reckoning that sets each cut is
    printed: 2 bf16 weight + 2 bf16 gradient + 8 float32 AdamW moment bytes
    a parameter, before the activations of 2 x 4096 tokens), bf16 weights
    from seed 0 (the zero-initialised u_bonus and mixes, or D and dt_bias,
    drawn from seed 1), ``attn_impl="flash"``. ``Trainer.run(3)`` on 2 x
    4096 tokens, counts reset just before it and read just after: a K12 or
    K8 and a K12b or K8b launch a layer a step, K10 and K11 at every norm,
    the hybrid's K4-K6 once a group a step, no plain call of any kernel; the
    first loss within 1 of ln(vocab); three steps on one repeated batch,
    the loss falling; the kernels' route against the plain route (K12/K8,
    K12b/K8b, K10/K11 plain, ``xla``) from the same weights on one 2048-token
    sequence in float32 activations, losses within 1e-2 and every gradient
    leaf within 5e-2 relative in L2; K12b or K8b on its first layer's
    training inputs against its plain version, in the model's function
    (within two bf16 steps of each gradient's largest magnitude) and upcast
    to float32 in the Pallas kernel's (2e-5), timed by CUDA events beside
    its plain version and its bound; then at small and ragged shapes;
13. ``agree``: a small fixed-seed tuner run on ``cuda`` and on ``cpu`` whose
    observation streams and trajectories must be identical;
14. the seconds of each phase, one JSON line with the kernels' numbers, the
    card line, and as the last line ``{"ok": true, "device": {...}}``.

Any failed phase exits non-zero. Without a CUDA device, or outside a
checkout of the repository, it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12      # H100 SXM HBM3 (NVIDIA data sheet)
FP32_OPS_PER_S = 67e12         # H100 SXM float32 outside the tensor cores
BF16_OPS_PER_S = 989e12        # H100 SXM bf16 tensor cores, dense
FP64_OPS_PER_S = 34e12         # H100 SXM float64 outside the tensor cores (data sheet)


def fail(msg: str) -> "NoReturn":  # noqa: F821
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if out.returncode != 0 or not out.stdout.strip():
        fail(f"nvidia-smi failed: {out.stderr.strip()}")
    return out.stdout.strip().splitlines()[0]


# The sm_90a kernels held to a clean build: per source, each kernel's
# instantiations by template argument ("" for a kernel that is no template)
_TYPE_PAIRS = ("f,f", "f,bf16", "bf16,f", "bf16,bf16")
HOPPER_KERNELS = {
    # K1's tiled route; K2's count and onesweep routes
    "forest_eval": {"forest_eval_tiled": ("",)},
    "radix_rank": {"radix_rank_count": ("",), "onesweep_hist": ("",), "onesweep_pass": ("",)},
    "flash_attn_fwd": {"flash_fwd_hopper": ("16", "32", "64", "80", "128")},
    "flash_attn_bwd": {"flash_dq_hopper": ("16", "32", "64", "80", "128"),
                       "flash_dkv_hopper": ("16", "32", "64", "80", "128")},
    "moe_gmm": {"gmm_prefill_hopper": ("",), "gmm_decode_hopper": ("16", "32", "64")},
    # K10's resident rows: 16-byte vectors a lane by width, at most 16 in
    # float32; K11's cluster route
    "rmsnorm": {"rmsnorm_bwd_cluster": _TYPE_PAIRS,
                "rmsnorm_fwd_resident": tuple(
                    f"{p},{nv}" for p in _TYPE_PAIRS for nv in (4, 8, 16, 24, 32)
                    if p.startswith("bf16") or nv <= 16)},
    # K7's ring route: (dtype, lanes a key, query rows a block); float32
    # always takes 16 lanes
    "flash_decode": {"decode_ring": tuple(
        f"{t},{lanes},{rows}" for t in ("f", "bf16") for lanes in (4, 8, 16)
        for rows in (1, 2, 4, 8) if t == "bf16" or lanes == 16)},
    # K3's staged route (leaf words); its values kernel, which holds the walk
    # and the float tail in 96 registers, spills a word at W = 1 and is left
    # out
    "chain_ordinals": {"chain_staged_kernel": ("1", "2")},
    # the fused propose step's Q1 and Q2
    "qs_descent": {"qs_descent_kernel": ("",)},
    "combine_ei": {"combine_ei_kernel": ("",)},
}


def _template_args(mangled: str, name: str) -> str:
    """The template arguments of ``name``'s instantiation in an Itanium-
    mangled symbol, short: ``Li16E`` -> "16", float and bf16 types -> "f"
    and "bf16" (a repeated type is mangled as a substitution, ``S<n>_``, and
    read back as the previous type), joined by commas; "" for a kernel that
    is no template."""
    import re

    rest = mangled[mangled.index(name) + len(name):]
    if not rest.startswith("I"):
        return ""
    args, types, rest = [], [], rest[1:]
    while rest and rest[0] != "E":
        m = re.match(r"Li(\d+)E|f|13__nv_bfloat16|S\d*_", rest)
        if m is None:
            break
        tok = m.group(0)
        if m.group(1) is not None:
            args.append(m.group(1))
        else:
            types.append("f" if tok == "f" else "bf16" if "bfloat16" in tok else types[-1])
            args.append(types[-1])
        rest = rest[len(tok):]
    return ",".join(args)


def hopper_ptxas(log: str) -> list:
    """(kernel, template arguments, registers, stack frame, spill store and
    spill load bytes) of each instantiation of a kernel in
    ``HOPPER_KERNELS``, from ``-Xptxas -v`` output."""
    import re

    names = sorted({k for ks in HOPPER_KERNELS.values() for k in ks}, key=len, reverse=True)
    out, name = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+?)'", line)
        if m:
            name = next((k for k in names if re.search(rf"\d{k}(?:I|E)", m.group(1))), None)
            if name is not None:
                args, frame = _template_args(m.group(1), name), None
            continue
        if name is None:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            frame, st, ld = (int(x) for x in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and frame is not None:
            out.append((name, args, int(m.group(1)), frame, st, ld))
            name = None
    return out


def check_hopper_build(logs: dict) -> None:
    """Print the registers and spills of every kernel in ``HOPPER_KERNELS``
    (K1's tiled route, K2's count and onesweep routes, the wgmma routes of
    K4-K6 and K9, K11's cluster route, K10's resident route, K7's ring
    route) and fail unless each built every instantiation with no spill and
    no serialized wgmma."""
    for source, kernels in HOPPER_KERNELS.items():
        if logs.get(source, "(cached)") == "(cached)":
            continue
        hop = hopper_ptxas(logs[source])
        for name, args, regs, frame, st, ld in hop:
            print(f"[build] {name}<{args}>: {regs} registers, {frame} bytes stack frame, "
                  f"{st} bytes spill stores, {ld} bytes spill loads", flush=True)
        serialized = "serialized" in logs[source]
        built = {k: sorted(h[1] for h in hop if h[0] == k) for k in kernels}
        if any(built[k] != sorted(v) for k, v in kernels.items()) or serialized or any(
                h[4] or h[5] for h in hop):
            fail(f"{source}'s sm_90a kernels do not build clean: {hop}, wgmma "
                 f"serialized={serialized}")


def cuda_time_ms(fn, reps: int) -> float:
    """Mean ms per call of ``fn`` over ``reps`` calls, after a warm-up, from
    CUDA events on the current stream."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(first, new, reps: int) -> tuple:
    """(first's ms, new's ms, the four turns): each timed by
    :func:`cuda_time_ms` in turns, first, new, new, first, and averaged over
    its two turns."""
    t = tuple(cuda_time_ms(fn, reps) for fn in (first, new, new, first))
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t


def trace_kernels(fn) -> list:
    """(name, start in µs, device µs) of every CUDA kernel that ``fn()`` ran,
    in launch order, from one ``torch.profiler`` trace; [] where the
    profiler saw no device kernel. The trace idles 50 ms on each side of
    ``fn``: traces that stopped right after their calls held fewer
    kernels than the calls launched."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        time.sleep(0.05)
        fn()
        torch.cuda.synchronize()
        time.sleep(0.05)
    kernels = [(e.name, e.time_range.start, e.time_range.elapsed_us()) for e in prof.events()
               if e.device_type == torch.autograd.DeviceType.CUDA]
    return sorted(kernels, key=lambda k: k[1])


def traced_ms(fn, tags, reps: int = 10):
    """Device ms of each of ``fn``'s kernels whose names hold each of
    ``tags`` (one such launch a call), the mean over the launches a trace
    of ``reps`` calls after a warm-up holds; None where it holds none of a
    tag."""
    fn()
    kernels = trace_kernels(lambda: [fn() for _ in range(reps)])
    out, seen = [], []
    for tag in tags:
        mine = [us for name, _, us in kernels if tag in name]
        seen.append(len(mine))
        out.append(sum(mine) / len(mine) / 1e3 if mine else None)
    print(f"[trace] kernels {list(tags)} held by the trace of {reps} calls: {seen}", flush=True)
    return None if None in out else out


def traced_call_ms(fn, groups, reps: int = 10):
    """(device ms a call of ``fn``, kernels held): for each (tag, launches
    a call) of ``groups``, the mean duration of the kernels whose names
    hold the tag in one trace of ``reps`` calls after a warm-up, times its
    launches a call (a count of None: all such kernels over ``reps``),
    summed; None where the trace holds none of a tag."""
    fn()
    kernels = trace_kernels(lambda: [fn() for _ in range(reps)])
    total, held = 0.0, []
    for tag, per_call in groups:
        mine = [us for name, _, us in kernels if tag in name]
        held.append(len(mine))
        if not mine:
            return None, held
        total += sum(mine) / (reps if per_call is None else len(mine) / per_call)
    return total / 1e3, held


def traced_turns(first, new, first_groups, new_groups, reps: int = 10) -> tuple:
    """(first's ms, new's ms, the four turns, kernels held) by
    :func:`traced_call_ms` in turns, first, new, new, first; None where a
    trace held none."""
    runs = [traced_call_ms(fn, g, reps) for fn, g in ((first, first_groups), (new, new_groups),
                                                       (new, new_groups), (first, first_groups))]
    t = [r[0] for r in runs]
    if None in t:
        return None, None, t, [r[1] for r in runs]
    return (t[0] + t[3]) / 2, (t[1] + t[2]) / 2, t, [r[1] for r in runs]


def launch_floor_ms(device, reps: int = 50) -> float:
    """Device ms of an empty kernel (``csrc/launch_floor.cu``), the mean over
    a trace of ``reps`` launches: the least any launch takes."""
    import ctypes

    import torch

    from repro_torch.kernels import build

    fn = build.load("launch_floor").launch_floor_launch
    fn.argtypes, fn.restype = [ctypes.c_void_p], ctypes.c_int

    def one():
        if fn(torch.cuda.current_stream(device).cuda_stream) != 0:
            fail("the empty kernel did not launch")

    ms, held = traced_call_ms(one, [("launch_floor_kernel", 1)], reps)
    print(f"[kernels] launch floor: an empty kernel's trace time {ms} ms "
          f"({held[0]} of {reps} launches held)", flush=True)
    return ms


def bound(n_bytes: float, n_ops: float, ops_per_s: float = FP32_OPS_PER_S,
          bf16_ops: float = 0.0):
    """(bound_ms, bound_by): the larger of bytes over the memory rate and
    operations over the peak rate for their type (``n_ops`` at
    ``ops_per_s``, float32 by default, plus ``bf16_ops`` at the bf16 rate)."""
    b_ms = n_bytes / HBM_BYTES_PER_S * 1e3
    o_ms = (n_ops / ops_per_s + bf16_ops / BF16_OPS_PER_S) * 1e3
    return (b_ms, "bytes") if b_ms >= o_ms else (o_ms, "operations")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


# ---------------------------------------------------------------------------
# knowledge bases
# ---------------------------------------------------------------------------


def build_kb(specs, n_obs: int, device, seed0: int = 0):
    from repro_torch.core import KnowledgeBase
    from repro_torch.sparksim import generate_history

    kb = KnowledgeBase()
    for i, spec in enumerate(specs):
        kb.add_task(generate_history(spec.workload(), n_obs=n_obs, seed=seed0 + i,
                                     device=device), persist=False)
    return kb


TARGET = ("tpch", 100, "A")
KB_OBS = 50  # the paper's historical-data protocol: 50 observations per task


def grid_kb(n_obs: int, device):
    """Histories of the 32-task grid minus the target, one per task."""
    from repro_torch.sparksim import all_task_specs, make_task_id

    target_id = make_task_id(*TARGET)
    specs = [s for s in all_task_specs() if s.task_id != target_id]
    return build_kb(specs, n_obs, device)


# ---------------------------------------------------------------------------
# kernel checks
# ---------------------------------------------------------------------------

SOURCES = {
    "forest_eval": ("src/repro_torch/csrc/forest_eval.cu",
                    "src/repro/kernels/forest_eval/kernel.py:51"),
    "radix_rank": ("src/repro_torch/csrc/radix_rank.cu",
                   "src/repro/kernels/forest_eval/rank.py:324"),
    "chain_ordinals": ("src/repro_torch/csrc/chain_ordinals.cu",
                       "src/repro/kernels/forest_eval/kernel.py:117"),
}


def kernel_fns(name: str):
    """(module, CUDA wrapper name, plain version, work, shape) of a kernel.
    ``work(args)`` counts its operations, ``shape(args)`` describes a call."""
    from repro_torch.kernels.forest_eval import chain, ops, rank

    if name == "forest_eval":
        return (ops, "forest_eval_cuda", lambda *a: ops.forest_eval_plain(*a[:8]),
                lambda a: a[5].numel() * a[6].shape[0] * a[7],
                lambda a: f"trees={a[5].numel()} nodes={a[0].numel()} depth={a[7]} "
                          f"pool={a[6].shape[0]}x{a[6].shape[1]}")
    if name == "radix_rank":
        return (rank, "radix_rank_cuda", rank.radix_rank_plain,
                lambda a: 0, lambda a: f"rows={a[0].shape[0]} n={a[0].shape[1]}")
    return (chain, "chain_values_cuda", chain.chain_values_plain,
            lambda a: (lambda C, d, nb, T, W: C * (d + 1) * nb * T * (W + 1))(*k3_dims(a)),
            lambda a: "chains={} d={} bg={} trees={} words={}".format(*k3_dims(a)))


def k3_dims(args) -> tuple:
    """(C, d, nb, T, W) of a ``chain_values_cuda`` call (word rows, chains'
    rows, background words, permutations, leaf means, offsets, y_std,
    y_mean)."""
    words, _, word_b, perms = args[:4]
    return perms.shape[0], perms.shape[1], word_b.shape[0], words.shape[2], words.shape[3]


def call_size(name: str, args) -> int:
    """Output elements of one call, by which the largest call is chosen."""
    if name == "forest_eval":
        return args[5].numel() * args[6].shape[0]
    if name == "radix_rank":
        return args[0].numel()
    C, d, nb, T, _ = k3_dims(args)
    return C * (d + 1) * nb * T


@contextlib.contextmanager
def capture_calls():
    """While active, every launch of a kernel's CUDA wrapper is tallied by
    shape, and a copy of the inputs of its largest call is kept, and for K1
    and K3 a copy of the inputs of its first call of each shape (K1's node
    table, its ninth argument, by reference: it is never written). K3's
    wrapper is ``chain_values_cuda``, through which every chain walk of the
    path goes. Yields
    ``{name: {"largest": args, "shapes": Counter, "by_shape": {shape:
    args}}}``."""
    import torch

    seen = {name: {"largest": None, "size": -1, "shapes": Counter(), "by_shape": {}}
            for name in SOURCES}
    restore = []
    for name in SOURCES:
        module, attr, _, _, shape = kernel_fns(name)
        launch = getattr(module, attr)

        def wrapped(*args, _name=name, _launch=launch, _shape=shape, **kwargs):
            if _name == "forest_eval":
                args = tuple(args[:8]) + (kwargs.pop("nodes", args[8] if len(args) > 8 else None),)
            rec = seen[_name]
            key = _shape(args)
            rec["shapes"][key] += 1
            if _name in TUNER_SUMMED and key not in rec["by_shape"]:
                rec["by_shape"][key] = tuple(a.clone() if torch.is_tensor(a) else a
                                             for a in args)
            size = call_size(_name, args)
            if size > rec["size"]:
                rec["size"] = size
                rec["largest"] = tuple(a.clone() if torch.is_tensor(a) else a for a in args)
            return _launch(*args, **kwargs)

        setattr(module, attr, wrapped)
        restore.append((module, attr, launch))
    try:
        yield seen
    finally:
        for module, attr, launch in restore:
            setattr(module, attr, launch)


def hold(name: str, args, reps: int, library=None) -> dict:
    """Launch a kernel once on ``args``, require exact equality with its
    plain version (and with ``library()`` where given), then time all of
    them with CUDA events."""
    import torch

    module, attr, plain, work, shape = kernel_fns(name)
    cuda = getattr(module, attr)
    got, want = cuda(*args), plain(*args)
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    match = all(torch.equal(g, w) for g, w in zip(got, want))
    if library is not None:
        match = match and torch.equal(got[0], library())
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    tensors = [a for a in args if torch.is_tensor(a)]
    b_ms, b_by = bound(nbytes(*tensors) + nbytes(*got), work(args))
    source, replaces = SOURCES[name]
    row = dict(
        name=name, source=source, replaces=replaces, shape=shape(args),
        match=match, max_abs_err=err,
        ms=cuda_time_ms(lambda: cuda(*args), reps),
        plain_ms=cuda_time_ms(lambda: plain(*args), max(2, reps // 5)),
        bound_ms=b_ms, bound_by=b_by,
        library_ms=None if library is None else cuda_time_ms(library, reps),
    )
    print(f"[kernels] {name}: {row['shape']} match={match} max_abs_err={err} "
          f"ms={row['ms']:.6f} plain_ms={row['plain_ms']:.6f} library_ms={row['library_ms']} "
          f"bound_ms={row['bound_ms']:.6f} ({b_by})", flush=True)
    return row


def rank_library(keys):
    """One-sort PyTorch yardstick for K2: positions under a stable argsort
    of the keys (bit 63 flipped, so int64 order is the unsigned order)."""
    import torch

    S, N = keys.shape
    iota = torch.arange(N, dtype=torch.float64, device=keys.device).expand(S, N)
    signed = keys ^ (-(1 << 63))
    return lambda: torch.empty_like(iota).scatter_(1, torch.argsort(signed, dim=1, stable=True),
                                                   iota)


# the trace tags of each route's kernels, with their launches a call
ROUTE_TAGS = {
    "forest_eval": {"tiled": [("forest_eval_tiled", 1)], "gather": [("forest_eval_kernel", 1)]},
    "radix_rank": {"count": [("radix_rank_count", 1)],
                   "onesweep": [("onesweep_hist", 1), ("onesweep_pass", 8)],
                   "block": [("radix_rank_kernel", 1)]},
    "chain_ordinals": {"per_chain": [("chain_ordinals_kernel", 1)],
                       "staged": [("chain_staged_kernel", 1)],
                       "values": [("chain_values_kernel", 1)]},
}
FIRST_DESIGN = {"forest_eval": "gather", "radix_rank": "block", "chain_ordinals": "per_chain"}
# the kernels summed over the tuner run: the routes in turns, and the route
# the run takes
TUNER_SUMMED = {
    "forest_eval": (("gather", "tiled", "tiled", "gather"), "tiled"),
    "chain_ordinals": (("per_chain", "staged", "values", "values", "staged", "per_chain"),
                       "values"),
}


def route_taken(name: str, call) -> str:
    """The route a kernel's wrapper takes for ``call()``, from its count."""
    from repro_torch.kernels import counts

    counts.reset()
    call()
    taken = [k.split("/")[1] for k, v in counts.ROUTE_LAUNCHES.items() if v]
    if len(taken) != 1 or taken[0] not in ROUTE_TAGS[name]:
        fail(f"{name} took routes {counts.ROUTE_LAUNCHES}")
    return taken[0]


def design_turns(name: str, args, reps: int, library=None) -> dict:
    """The route a K1 or K2 call takes against its first design
    (``gather``, ``block``) in turns (first, new, new, first): by CUDA events and by the
    kernels' durations in profiler traces; K2's ``argsort`` yardstick traced
    too."""
    module, attr, _, _, _ = kernel_fns(name)
    cuda = getattr(module, attr)
    new_route = route_taken(name, lambda: cuda(*args))
    first = FIRST_DESIGN[name]
    f_ms, n_ms, turns = in_turns(lambda: cuda(*args, route=first),
                                 lambda: cuda(*args, route=new_route), reps)
    tf, tn, tturns, held = traced_turns(lambda: cuda(*args, route=first),
                                        lambda: cuda(*args, route=new_route),
                                        ROUTE_TAGS[name][first], ROUTE_TAGS[name][new_route])
    out = dict(path_route=new_route, first_design=first, first_design_ms=f_ms,
               turns_ms=list(turns), traced_ms=tn, first_design_traced_ms=tf,
               traced_turns_ms=tturns, traced_held=held)
    if library is not None:
        out["library_traced_ms"] = traced_call_ms(library, [("", None)])[0]
    print(f"[kernels] {name}: {new_route} against {first} in turns (first, new, new, first): "
          f"events {list(turns)} ms, traces {tturns} ms (kernels held {held}); "
          f"library trace {out.get('library_traced_ms')}", flush=True)
    return out


def check_main_path(captured, floor_ms: float) -> list:
    """Each kernel at the largest call the tuner run gave it, on a copy of
    that call's inputs; K1 and K2 against their first designs in turns, beside
    the launch floor."""
    rows = []
    for name, rec in captured.items():
        print(f"[kernels] {name}: tuner calls by shape: {dict(rec['shapes'].most_common(6))}",
              flush=True)
        if rec["largest"] is None:
            fail(f"the tuner run never called {name}")
        args = rec["largest"]
        library = rank_library(args[0]) if name == "radix_rank" else None
        rows.append(hold(name, args, reps=200, library=library))
        if name == "chain_ordinals":
            rows[-1].update(k3_turns(args, 200), launch_floor_ms=floor_ms)
        elif name in FIRST_DESIGN:
            rows[-1].update(design_turns(name, args, 200, library), launch_floor_ms=floor_ms)
        if name in TUNER_SUMMED:
            rows[-1].update(tuner_summed(name, rec))
    return rows


def tuner_summed(name: str, rec, reps: int = 3) -> dict:
    """K1's or K3's device time summed over the tuner run's launches, from
    ``torch.profiler`` traces: each distinct shape launched ``reps`` times
    on a copy of its first call's inputs (one kernel a call; a K1 call with
    no tree or no point launches none), each shape's kernel durations
    averaged and multiplied by its count; for each route of
    ``TUNER_SUMMED[name]``, in its turns. None where a trace does not hold
    one kernel a call."""
    module, attr, _, _, _ = kernel_fns(name)
    cuda = getattr(module, attr)
    order, taken = TUNER_SUMMED[name]
    shapes = [(key, n, rec["by_shape"][key]) for key, n in rec["shapes"].items()
              if name != "forest_eval" or (rec["by_shape"][key][5].numel()
                                           and rec["by_shape"][key][6].shape[0])]
    for _, _, args in shapes:
        cuda(*args)

    def summed(route):
        tag = ROUTE_TAGS[name][route][0][0]
        kernels = [us for kname, _, us in trace_kernels(
            lambda: [cuda(*args, route=route) for _, _, args in shapes for _ in range(reps)])
            if tag in kname]
        if len(kernels) != reps * len(shapes):
            print(f"[kernels] {name} summed over the tuner run ({route}): the trace holds "
                  f"{len(kernels)} kernels for {reps * len(shapes)} calls: not measured",
                  flush=True)
            return None, []
        per_shape = []
        for i, (key, n, _) in enumerate(shapes):
            ms = sum(kernels[i * reps:(i + 1) * reps]) / reps / 1e3
            per_shape.append((n * ms, n, ms, key))
        per_shape.sort(reverse=True)
        return sum(p[0] for p in per_shape), per_shape

    turns = [summed(r) for r in order]
    t = [x[0] for x in turns]
    by_route = {r: None if None in [t[i] for i, q in enumerate(order) if q == r] else
                sum(t[i] for i, q in enumerate(order) if q == r) / order.count(r)
                for r in dict.fromkeys(order)}
    first = order[0]
    out = dict(tuner_launches=sum(rec["shapes"].values()), tuner_shapes=len(rec["shapes"]),
               tuner_summed_ms=by_route[taken], tuner_summed_first_design_ms=by_route[first],
               tuner_summed_by_route_ms=by_route, tuner_summed_turns_ms=t)
    print(f"[kernels] {name} summed over the tuner run: {out['tuner_launches']} launches "
          f"of {out['tuner_shapes']} shapes; kernel time (profiler traces: each shape's kernel "
          f"over {reps} launches, times its count) in turns {', '.join(order)}: {t} ms; by "
          f"route {by_route}; largest shares (ms, count, ms a call, shape) {taken}: "
          f"{turns[order.index(taken)][1][:4]}, {first}: {turns[0][1][:4]}", flush=True)
    return out


def k3_turns(args, reps: int) -> dict:
    """K3 at one ``chain_values_cuda`` call: every route of the ordinals
    (``per_chain``, ``staged``, ``staged`` on the chains' rows) and of the
    chain values (``values``, and each ordinals route with the torch tail)
    held to the plain versions bit for bit, every wrapper call under
    ``set_sync_debug_mode("error")``; then by profiler traces, in turns: the
    ordinals' kernel (per_chain, staged, staged, per_chain), beside the
    ordinals' bound; the values kernel, beside its own bound; all kernels
    of a chain-values call (per_chain and the tail, values, values,
    per_chain), and its host clock ending in the copy to the host."""
    import torch

    from repro_torch.kernels.forest_eval import chain
    from repro_torch.kernels.launch import n_sms

    words, xoc, wb, perms = args[:4]
    C, d, nb, T, W = k3_dims(args)
    wx = words[xoc.long()].contiguous()
    want = chain.chain_ordinals_plain(wx, wb, perms)
    want_vals = chain.chain_values_plain(*args)
    plan = chain.values_plan(C, d, nb, T, W, args[4].numel(), n_sms(words.device))
    routes = chain.VALUE_ROUTES if plan.route == "values" else chain.ROUTES
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        got = {r: chain.chain_ordinals_cuda(wx, wb, perms, route=r) for r in chain.ROUTES}
        got["staged_rows"] = chain.chain_ordinals_cuda(words, wb, perms, route="staged",
                                                       x_of_chain=xoc)
        vals = {r: chain.chain_values_cuda(*args, route=r) for r in routes}
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    bad = [r for r, g in got.items() if not torch.equal(g, want)] + [
        f"values/{r}" for r, v in vals.items()
        if not torch.equal(v.view(torch.int64), want_vals.view(torch.int64))]
    if bad:
        fail(f"K3 at chains={C} d={d} bg={nb} trees={T} words={W}: routes {bad} differ from "
             f"their plain versions")
    ordinals = {r: (lambda r=r: chain.chain_ordinals_cuda(wx, wb, perms, route=r))
                for r in chain.ROUTES}
    tags, first = ROUTE_TAGS["chain_ordinals"], FIRST_DESIGN["chain_ordinals"]
    tf, tn, tturns, held = traced_turns(ordinals[first], ordinals["staged"], tags[first],
                                        tags["staged"])
    ef, en, eturns = in_turns(ordinals[first], ordinals["staged"], reps)
    o_ms, o_by = bound(nbytes(wx, wb, perms, want), C * (d + 1) * nb * T * W)
    out = dict(path_route=plan.route, first_design=first, first_design_traced_ms=tf,
               staged_traced_ms=tn, traced_turns_ms=tturns, traced_held=held,
               first_design_ms=ef, staged_ms=en, turns_ms=list(eturns),
               staged_bound_ms=o_ms, staged_bound_by=o_by, values_plan=plan._asdict())
    print(f"[kernels] chain_ordinals: plan {plan}; ordinals bit for bit on {list(got)}, values "
          f"on {list(vals)}, no host sync; ordinals staged against per_chain in turns "
          f"(first, new, new, first): traces {tturns} ms (held {held}), events {list(eturns)} "
          f"ms; the ordinals' bound {o_ms:.6f} ms ({o_by})", flush=True)
    if plan.route == "values":
        call = {r: (lambda r=r: chain.chain_values_cuda(*args, route=r)) for r in routes}
        v_ms = traced_call_ms(call["values"], tags["values"])[0]
        all_f, all_v, all_turns, all_held = traced_turns(call["per_chain"], call["values"],
                                                         [("", None)], [("", None)])

        def host(r, n=50):
            call[r]().cpu()
            t0 = time.perf_counter()
            for _ in range(n):
                call[r]().cpu()
            return (time.perf_counter() - t0) / n * 1e3

        host_turns = [host(r) for r in ("per_chain", "values", "values", "per_chain")]
        out.update(values_traced_ms=v_ms, eval_traced_ms=all_v, eval_per_chain_traced_ms=all_f,
                   eval_traced_turns_ms=all_turns, eval_traced_held=all_held,
                   eval_host_ms=(host_turns[1] + host_turns[2]) / 2,
                   eval_per_chain_host_ms=(host_turns[0] + host_turns[3]) / 2,
                   eval_host_turns_ms=host_turns)
        print(f"[kernels] chain_ordinals: values kernel trace {v_ms} ms; a chain-values call, "
              f"all its kernels by trace, per_chain + tail against values in turns: "
              f"{all_turns} ms (kernels held {all_held}); host clock a call ending in the copy "
              f"to the host, in turns: {host_turns} ms", flush=True)
    return out


def scale_plane(kb, device, n_sources: int = 12):
    """(space, forests, plane): one forest of 10 trees for each of the
    first ``n_sources`` histories of ``kb`` over the tuner's 60-knob space,
    fused: the fused propose step's scale (ROADMAP item 7)."""
    import numpy as np

    from repro_torch.core import make_forest
    from repro_torch.core.surrogate import ForestPlane
    from repro_torch.sparksim import SparkWorkload

    space = SparkWorkload(*TARGET).space
    forests = []
    for i, task in enumerate([kb.get(t) for t in sorted(kb.tasks)][:n_sources]):
        ok = task.successful()
        X = space.encode_many([o.config for o in ok])
        forests.append(make_forest(seed=i, device=device).fit(
            X, np.array([o.performance for o in ok])))
    return space, forests, ForestPlane([f.pack() for f in forests])


def check_at_scale(kb, device, floor_ms: float, pool_n: int = 131072,
                   n_sources: int = 12) -> list:
    """K1 and K2 at the fused-propose scale (ROADMAP item 7): a plane of 12
    sources over a 131072-candidate pool, and their 12 EI rows; each on the
    route it must take there (``tiled``, ``onesweep``), against its first
    design in turns. K2's design floor: 8 passes of 24 bytes an element
    plus the keys in and the ranks out at the memory rate, and the same for
    the passes this data does not skip."""
    import numpy as np
    import torch

    from repro_torch.core.acquisition import ei_matrix
    from repro_torch.kernels.forest_eval import ops, rank

    space, forests, plane = scale_plane(kb, device, n_sources)
    pool = space.sample(np.random.default_rng(7), pool_n).unit_tensor(device)
    args = (plane.feat, plane.thr, plane.child, plane.mean, plane.var, plane.roots, pool,
            plane.depth, plane.node_table())
    if route_taken("forest_eval", lambda: ops.forest_eval_cuda(*args)) != "tiled":
        fail("K1 at 131072 candidates did not take the tiled route")
    rows = [hold("forest_eval", args, reps=20)]
    rows[-1].update(design_turns("forest_eval", args, 20), launch_floor_ms=floor_ms)
    # the EI on the card must equal the host's bit for bit (IEEE sqrt and
    # division)
    means, vars_ = plane.predict(pool)
    bests = [float(f.y_.min()) for f in forests]
    ei = ei_matrix(means, vars_, bests)
    if not torch.equal(ei.cpu(), ei_matrix(means.cpu(), vars_.cpu(), bests)):
        fail("EI on the card differs from EI on the host")
    keys = rank.monotone_keys(ei).contiguous()
    if route_taken("radix_rank", lambda: rank.radix_rank_cuda(keys)) != "onesweep":
        fail("K2 at 131072 candidates did not take the onesweep route")
    library = rank_library(keys)
    rows.append(hold("radix_rank", (keys,), reps=20, library=library))
    rows[-1].update(design_turns("radix_rank", (keys,), 20, library), launch_floor_ms=floor_ms)
    S, N = keys.shape
    digits = torch.stack([(keys >> (8 * p)) & 0xFF for p in range(8)])
    passes = int((~(digits == digits[:, :, :1]).all(2)).sum(0).max())
    rows[-1].update(design_floor_ms=S * N * (8 * 24 + 16) / HBM_BYTES_PER_S * 1e3,
                    design_floor_passes=passes,
                    design_floor_data_ms=S * N * (passes * 24 + 16) / HBM_BYTES_PER_S * 1e3)
    print(f"[kernels] radix_rank at scale: design floor {rows[-1]['design_floor_ms']:.6f} ms "
          f"(8 passes), {rows[-1]['design_floor_data_ms']:.6f} ms ({passes} passes this data "
          f"runs)", flush=True)
    return rows


# ---------------------------------------------------------------------------
# tuner runs
# ---------------------------------------------------------------------------


def tune(kb, device, hours: float, target=TARGET, **options):
    """A fixed-seed MFTune run (``options`` into ``MFTuneOptions``): its
    result, observation stream, trajectory and the ``MFTune`` object."""
    from repro_torch.core import MFTune, MFTuneOptions
    from repro_torch.sparksim import SparkWorkload
    from repro_torch.tuneapi import Budget

    wl = SparkWorkload(*target)
    mft = MFTune(wl, kb, MFTuneOptions(seed=0, **options), device=device)
    res = mft.run(Budget(hours * 3600.0))
    obs = kb.get(wl.task_id).observations
    sig = [(o.performance, o.fidelity, tuple(sorted(o.config.items()))) for o in obs]
    traj = [(p.time, p.best, tuple(sorted(p.config.items()))) for p in res.trajectory]
    return res, sig, traj, mft


def span_seconds(tracer) -> dict:
    """Host-clock seconds per span name (nested spans count in their
    parents too)."""
    out: dict = {}
    for ev in tracer.events:
        if ev.get("type") == "span":
            out[ev["name"]] = out.get(ev["name"], 0.0) + ev["dur"]
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def run_tuner(kb, device):
    """The 24 h tuner run; returns its launch counts, the kernel calls it
    made (see :func:`capture_calls`) and its result, observation stream,
    wall seconds and host seconds by span."""
    import math

    import torch

    from repro_torch import obs
    from repro_torch.kernels import counts

    torch.cuda.reset_peak_memory_stats()
    with capture_calls() as captured:
        counts.reset()
        t0 = time.perf_counter()
        with obs.tracing(name="chip_smoke") as tracer:
            res, sig, *_ = tune(kb, device, hours=24.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(counts.LAUNCHES)
        plain = dict(counts.PLAIN_CALLS)
        routes = dict(counts.ROUTE_LAUNCHES)
    print(f"[tuner] evaluations={res.n_evaluations} full={res.n_full_evaluations} "
          f"best_latency_s={res.best_performance} wall_s={wall:.3f} "
          f"max_memory_allocated={torch.cuda.max_memory_allocated()} "
          f"launches={launches} plain_calls={plain} routes={routes}", flush=True)
    spans = span_seconds(tracer)
    print("[tuner] host seconds by span: " + " ".join(
        f"{k}={v:.3f}" for k, v in spans.items()), flush=True)
    if not (res.n_evaluations > 0 and math.isfinite(res.best_performance)
            and res.best_performance > 0):
        fail("tuner produced no finite best latency")
    if any(v != 0 for v in plain.values()):
        fail(f"the cuda run reached a plain version: {plain}")
    zero = [k for k in SOURCES if launches[k] == 0]
    if zero:
        fail(f"kernels never launched on the tuner path: {zero}")
    # every K1 launch of the run on the tiled route, every K2 launch on
    # count, every K3 launch on values or staged
    if (routes.get("forest_eval/tiled") != launches["forest_eval"]
            or routes.get("radix_rank/count") != launches["radix_rank"]
            or routes.get("chain_ordinals/values", 0) + routes.get("chain_ordinals/staged", 0)
            != launches["chain_ordinals"]):
        fail(f"the tuner's K1, K2 and K3 launches did not all take tiled, count and values or "
             f"staged: {routes}")
    return launches, captured, (res, sig, wall, spans)


def run_tuner_staged(kb, device, first) -> dict:
    """The same 24 h run again with every chain walk on K3's ``staged``
    route and the torch tail (the target's history of the first run taken
    out of ``kb``, so the run starts as the first did): it must give the
    first run's observation stream; its wall, ``shapley_attribution`` span
    and route counts beside the first run's."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import chain
    from repro_torch.sparksim import make_task_id

    res0, sig0, wall0, spans0 = first
    kb.tasks.pop(make_task_id(*TARGET))
    chain._EVAL_ROUTE = "staged"
    try:
        counts.reset()
        t0 = time.perf_counter()
        with obs.tracing(name="chip_smoke_staged") as tracer:
            res, sig, *_ = tune(kb, device, hours=24.0)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    finally:
        chain._EVAL_ROUTE = None
    routes = {k: v for k, v in counts.ROUTE_LAUNCHES.items() if k.startswith("chain_ordinals")}
    spans = span_seconds(tracer)
    out = dict(tuner_staged_wall_s=wall, tuner_values_wall_s=wall0,
               tuner_staged_shapley_s=spans.get("shapley_attribution"),
               tuner_values_shapley_s=spans0.get("shapley_attribution"),
               tuner_staged_routes=routes)
    print(f"[tuner] K3 on staged + the torch tail: evaluations={res.n_evaluations} "
          f"best_latency_s={res.best_performance} wall_s={wall:.3f} (values: {wall0:.3f}) "
          f"shapley_attribution_s={out['tuner_staged_shapley_s']} (values: "
          f"{out['tuner_values_shapley_s']}) routes={routes} "
          f"plain_calls={counts.PLAIN_CALLS['chain_ordinals']}", flush=True)
    if sig != sig0 or res.best_performance != res0.best_performance:
        fail("the tuner run on K3's staged route differs from the run on values")
    if (routes.get("chain_ordinals/staged") != counts.LAUNCHES["chain_ordinals"]
            or counts.PLAIN_CALLS["chain_ordinals"]):
        fail(f"the staged tuner run took other K3 routes: {routes}")
    return out


# ---------------------------------------------------------------------------
# the fused propose step (ROADMAP item 7): Q1, Q2 and one graph a bucket
# ---------------------------------------------------------------------------

PROPOSE_SOURCES = {
    "qs_descent": ("src/repro_torch/csrc/qs_descent.cu",
                   "none: no Pallas original (jnp _qs_leaf_stats, "
                   "src/repro/kernels/forest_eval/propose.py:360)"),
    "combine_ei": ("src/repro_torch/csrc/combine_ei.cu",
                   "none: no Pallas original (jnp _combine_source and the portable ei, "
                   "src/repro/kernels/forest_eval/propose.py:146)"),
}
PROPOSE_BUCKETS = (256, 1024, 4096, 16384, 65536, 131072)
PROPOSE_TIMED = (256, 131072)   # the sweep of scripts/propose_scaling.py, at two sizes
PROPOSE_N = 32                  # candidates a call selects
# float64 operations a (source, candidate) of Q2 at 10 trees a source: the
# combine's 46 adds, subtractions, products and divisions, the EI's about 110
# (two exp64, one ndtr64 with its polynomial ratios)
Q2_OPS = 156


def run_tuner_fused(kb, device, first) -> tuple:
    """The 24 h run again on the fused step (``acquisition_backend="fused",
    acquisition_pool="host"``) from the same knowledge base: it must give
    the first (staged) run's observation stream, every recommend call a
    graph replay (no staged ``acquisition`` span; as many replays as
    ``propose_step`` spans), at most one graph more than the pool buckets it
    saw, no plain call, and launches of Q2 and K2; its wall and spans
    beside the first run's. Returns (numbers, launches)."""
    import torch

    from repro_torch import obs
    from repro_torch.kernels import counts
    from repro_torch.sparksim import make_task_id

    res0, sig0, wall0, spans0 = first
    kb.tasks.pop(make_task_id(*TARGET))
    counts.reset()
    t0 = time.perf_counter()
    with obs.tracing(name="chip_smoke_fused") as tracer:
        res, sig, _, mft = tune(kb, device, hours=24.0, acquisition_backend="fused",
                                acquisition_pool="host")
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(counts.LAUNCHES)
    plain = {k: v for k, v in counts.PLAIN_CALLS.items() if v}
    routes = dict(counts.ROUTE_LAUNCHES)
    eng = mft.gen.propose_engine
    stats = eng.graph_stats()
    steps = sum(1 for e in tracer.events
                if e.get("type") == "span" and e["name"] == "propose_step")
    buckets = sorted({sig_[1] for sig_ in eng.compiled})
    spans = span_seconds(tracer)
    out = dict(propose_tuner_wall_s=wall, propose_tuner_staged_wall_s=wall0,
               propose_tuner_step_s=spans.get("propose_step"),
               propose_tuner_staged_acquisition_s=spans0.get("acquisition"),
               propose_tuner_graphs=stats, propose_tuner_buckets=buckets,
               propose_tuner_steps=steps, propose_tuner_signatures=len(eng.compiled))
    print(f"[propose] the 24 h tuner run on the fused step (host pool): evaluations="
          f"{res.n_evaluations} best_latency_s={res.best_performance} wall_s={wall:.3f} "
          f"(staged: {wall0:.3f}); propose_step_s={out['propose_tuner_step_s']} (staged "
          f"acquisition_s={out['propose_tuner_staged_acquisition_s']}); recommend calls "
          f"{steps}, graphs {stats}, buckets {buckets}, reference signatures "
          f"{len(eng.compiled)}; launches={ {k: v for k, v in launches.items() if v} } "
          f"routes={routes} plain_calls={plain}", flush=True)
    print("[propose] host seconds by span (fused): " + " ".join(
        f"{k}={v:.3f}" for k, v in spans.items()), flush=True)
    if sig != sig0 or res.best_performance != res0.best_performance:
        fail("the tuner run on the fused step differs from the staged run")
    if "acquisition" in spans or steps == 0 or stats["replays"] != steps:
        fail(f"not every recommend call went through a graph replay: {steps} propose steps, "
             f"{stats}, staged acquisition {spans.get('acquisition')}")
    if stats["graphs"] > len(buckets) + 1:
        fail(f"{stats['graphs']} graphs for the buckets {buckets}")
    if plain or not (launches["combine_ei"] and launches["radix_rank"]
                     and launches["forest_eval"] + launches["qs_descent"]):
        fail(f"the fused run launched {launches}, plain calls {plain}")
    out["propose_tuner_last_call"] = hold_last_call(eng)
    return out, launches


def hold_last_call(eng) -> dict:
    """Q1 and Q2 against their plain versions at the shapes of the fused
    run's last call: its plane and its pool, as its graph's buffers hold
    them."""
    import torch

    from repro_torch.kernels.forest_eval import ops
    from repro_torch.kernels.forest_eval import propose as P

    slot = next(iter(eng.graphs.values()))
    entry, X = slot.plane, slot.buf["X"]
    qs, reason = entry.qs()
    p = entry.plane
    meta = slot.buf["meta"]
    m, v = ops.forest_eval_cuda(p.feat, p.thr, p.child, p.mean, p.var, p.roots, X, p.depth,
                                entry.nodes)
    ystats, inc = entry.ystats, slot.buf["small"][3, :entry.S].contiguous()
    q2 = P.combine_ei_cuda(m, v, ystats, inc, meta)
    want2 = P.combine_ei_plain(m, v, ystats, inc, meta)
    same = torch.equal(q2.view(torch.int64), want2.view(torch.int64))
    if qs is not None:   # else a tree has more than 128 leaves: no Q1 there
        q1 = P.qs_leaf_stats_cuda(X, qs)
        want1 = P.qs_leaf_stats_plain(X, qs)
        same &= all(torch.equal(a.view(torch.int64), b.view(torch.int64))
                    for a, b in zip(q1, want1)) and torch.equal(q1[0], m)
    torch.cuda.synchronize()
    shape = (f"sources={entry.S} trees={entry.T} pool={X.shape[0]}x{X.shape[1]} "
             f"valid={int(meta[2])}")
    print(f"[propose] Q1 and Q2 at the fused run's last call ({shape}) against their plain "
          f"versions, bit for bit: {same}{'' if qs is not None else f' (Q2 only: {reason})'}",
          flush=True)
    if not same:
        fail(f"Q1 or Q2 differs from its plain version at the tuner's call {shape}")
    return {"shape": shape, "match": same}


def stage_of(kernel: str) -> str:
    """The step's stage a kernel's name belongs to."""
    for tag, stage in (("forest_eval", "descent"), ("qs_descent", "descent"),
                       ("combine_ei", "combine_ei"), ("radix_rank", "ranks"),
                       ("onesweep", "ranks")):
        if tag in kernel:
            return stage
    return "torch"


def step_profile(fn, reps: int = 5) -> dict:
    """Device ms a call of ``fn`` by stage (and in all), from one trace of
    ``reps`` calls after a warm-up."""
    fn()
    out: dict = {}
    for name, _, us in trace_kernels(lambda: [fn() for _ in range(reps)]):
        st = stage_of(name)
        out[st] = out.get(st, 0.0) + us / 1e3 / reps
    out["all"] = sum(out.values())
    return out


def host_ms(fn, reps: int = 10) -> float:
    """Host-clock ms a call of ``fn`` (which ends in a copy to the host)."""
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) / reps * 1e3


def check_propose_at_scale(kb, device, floor_ms: float) -> tuple:
    """The fused step at 12 sources x 10 trees over the 60-knob space, at
    every pool bucket from 256 to 131072: the engine's graphs (host pool,
    both descents, no host sync before the result's copy) with the counts
    reset just before and read just after, each selection equal to the
    staged path's; Q1 and Q2 against their plain versions bit for bit;
    at two sizes Q1 against K1 ``tiled`` by trace in turns (K1, Q1, Q1,
    K1), Q2 against the staged torch combine + EI, the step's device time
    by stage and its host clock, graph against eager; the device pool's
    draws. Returns (Q1's row, Q2's row, the drive's launches, numbers)."""
    import numpy as np
    import torch

    from repro_torch.core import ProposeEngine, aggregate_ranks, score_sources
    from repro_torch.core.acquisition import ei_matrix
    from repro_torch.core.propose import _PlaneEntry
    from repro_torch.core.surrogate import combine
    from repro_torch.kernels import counts
    from repro_torch.kernels.forest_eval import ops
    from repro_torch.kernels.forest_eval import propose as P

    space, forests, plane = scale_plane(kb, device)
    S, tps = len(forests), plane.uniform_tree_count
    T = S * tps
    incs = [float(f.y_.min()) for f in forests]
    ws = [float(w) for w in np.linspace(1.0, 0.1, S)]
    entry = _PlaneEntry(plane, space.dim)
    qs, reason = entry.qs()
    if qs is None:
        fail(f"no QuickScorer plan for the scale plane: {reason}")
    nodes = plane.node_table()
    rng = np.random.default_rng(7)
    pools = {N: space.sample(rng, N).unit() for N in PROPOSE_BUCKETS}
    staged = {}
    for N, X in pools.items():
        scores = score_sources(forests, torch.from_numpy(X).to(device), incs)
        staged[N] = np.argsort(aggregate_ranks(scores, ws).cpu().numpy(),
                               kind="stable")[:PROPOSE_N]

    # the drive: every bucket, both descents, through the engine's graphs
    eng = ProposeEngine(space, seed=0)
    eng.check_sync = True
    for N, X in pools.items():   # capture first: the counted run only replays
        for d in ("forest", "qs"):
            eng.score_topk(forests, X, incs, ws, PROPOSE_N, descent=d)
    torch.cuda.synchronize()
    counts.reset()
    bad = []
    for N, X in pools.items():
        for d in ("forest", "qs"):
            if not np.array_equal(eng.score_topk(forests, X, incs, ws, PROPOSE_N, descent=d),
                                  staged[N]):
                bad.append((N, d))
    torch.cuda.synchronize()
    launches = dict(counts.LAUNCHES)
    routes = dict(counts.ROUTE_LAUNCHES)
    stats = eng.graph_stats()
    print(f"[propose] the step at 12 x 10 trees, 60 knobs, buckets {list(PROPOSE_BUCKETS)}, "
          f"both descents through the graphs (no host sync before the result's copy): "
          f"launches={ {k: v for k, v in launches.items() if v} } routes={routes} "
          f"graphs={stats}; selections equal to the staged path's except {bad}", flush=True)
    if bad:
        fail(f"the fused step's selections differ from the staged path's at {bad}")
    if not all(launches[k] for k in ("forest_eval", "radix_rank", "qs_descent", "combine_ei")):
        fail(f"the step's drive left a kernel unlaunched: {launches}")
    if stats["graphs"] != 2 * len(PROPOSE_BUCKETS) or routes.get("forest_eval/tiled") != \
            launches["forest_eval"]:
        fail(f"the drive took {stats} graphs and K1 routes {routes}")

    # Q1 and Q2 against their plain versions at every bucket
    ystats = torch.stack([plane.y_means, plane.y_stds, plane.y_std_sqs])
    inc = torch.tensor(incs, dtype=torch.float64, device=device)
    err = {"qs_descent": 0.0, "combine_ei": 0.0}
    match = {"qs_descent": True, "combine_ei": True}
    for N, X in pools.items():
        Xt = torch.from_numpy(X).to(device)
        meta = torch.tensor([S, tps, N - 3], dtype=torch.int32, device=device)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            q1 = P.qs_leaf_stats_cuda(Xt, qs)
            m, v = ops.forest_eval_cuda(plane.feat, plane.thr, plane.child, plane.mean,
                                        plane.var, plane.roots, Xt, plane.depth, nodes)
            q2 = P.combine_ei_cuda(m, v, ystats, inc, meta)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        q1p = P.qs_leaf_stats_plain(Xt, qs)
        q2p = P.combine_ei_plain(m, v, ystats, inc, meta)
        torch.cuda.synchronize()
        for g, w in zip(q1, q1p):
            match["qs_descent"] &= torch.equal(g.view(torch.int64), w.view(torch.int64))
            err["qs_descent"] = max(err["qs_descent"], float((g - w).abs().max()))
        match["qs_descent"] &= torch.equal(q1[0], m) and torch.equal(q1[1], v)
        match["combine_ei"] &= torch.equal(q2.view(torch.int64), q2p.view(torch.int64))
        err["combine_ei"] = max(err["combine_ei"], float((q2 - q2p).abs().max()))
    print(f"[propose] Q1 and Q2 against their plain versions at every bucket (bit for bit, no "
          f"host sync): {match}, max_abs_err {err}; Q1's leaf stats equal K1's", flush=True)
    if not all(match.values()):
        fail(f"Q1 or Q2 differs from its plain version: {match}")

    # timings at two sizes: the kernels in turns, the step by stage and host clock
    numbers, rows = {}, {}
    w_t = torch.tensor(ws, dtype=torch.float64, device=device)
    for N in PROPOSE_TIMED:
        X = pools[N]
        Xt = torch.from_numpy(X).to(device)
        meta = torch.tensor([S, tps, N], dtype=torch.int32, device=device)
        k1 = lambda: ops.forest_eval_cuda(plane.feat, plane.thr, plane.child, plane.mean,
                                          plane.var, plane.roots, Xt, plane.depth, nodes)
        q1 = lambda: P.qs_leaf_stats_cuda(Xt, qs)
        m, v = k1()
        q2 = lambda: P.combine_ei_cuda(m, v, ystats, inc, meta)
        staged_ei = lambda: ei_matrix(*combine(m.view(S, tps, N), v.view(S, tps, N),
                                               plane.y_means, plane.y_stds, plane.y_std_sqs),
                                      incs)
        k1_ms, q1_ms, q1_turns, q1_held = traced_turns(
            k1, q1, [("forest_eval_tiled", 1)], [("qs_descent", 1)])
        st_ms, q2_ms, q2_turns, q2_held = traced_turns(
            staged_ei, q2, [("", None)], [("combine_ei", 1)])
        q1_bound = bound(nbytes(Xt) + 2 * T * N * 8, 0)
        q2_bound = bound(2 * T * N * 8 + S * N * 8, Q2_OPS * S * N, ops_per_s=FP64_OPS_PER_S)
        graph = {}
        for d in ("forest", "qs"):
            run = lambda d=d: eng.score_topk(forests, X, incs, ws, PROPOSE_N, descent=d)

            def eager(d=d):
                Xp = torch.from_numpy(X).to(device)
                return P.propose_step(None, None, entry.arena, entry.ystats, inc, w_t,
                                      n_pool=N, n_sources=S, tps=tps, k=PROPOSE_N, descent=d,
                                      X=Xp, qs=qs if d == "qs" else None)[0].cpu()

            graph[d] = dict(graph_device_ms=step_profile(run), eager_device_ms=step_profile(eager),
                            host_turns_ms=[host_ms(f) for f in (eager, run, run, eager)])
        numbers[N] = dict(k1_traced_ms=k1_ms, q1_traced_ms=q1_ms, q1_turns_ms=q1_turns,
                          q1_held=q1_held, q1_bound_ms=q1_bound[0], staged_ei_traced_ms=st_ms,
                          q2_traced_ms=q2_ms, q2_turns_ms=q2_turns, q2_held=q2_held,
                          q2_bound_ms=q2_bound[0], q2_bound_by=q2_bound[1], step=graph)
        print(f"[propose] N={N}: Q1 against K1 tiled by trace in turns (K1, Q1, Q1, K1): "
              f"{q1_turns} ms (held {q1_held}), bound {q1_bound[0]:.6f} ms ({q1_bound[1]}); "
              f"Q2 against the staged torch combine + EI in turns (staged, Q2, Q2, staged): "
              f"{q2_turns} ms (held {q2_held}), bound {q2_bound[0]:.6f} ms ({q2_bound[1]}); "
              f"launch floor {floor_ms} ms", flush=True)
        for d, g in graph.items():
            print(f"[propose] N={N} descent={d}: the step's device ms a call by stage, graph "
                  f"{g['graph_device_ms']}, eager {g['eager_device_ms']}; host clock a call "
                  f"ending in the copy to the host, in turns (eager, graph, graph, eager): "
                  f"{g['host_turns_ms']} ms", flush=True)
        if N == PROPOSE_TIMED[-1]:
            for name, kernel, plain, turns, bnd in (
                    ("qs_descent", q1, lambda: P.qs_leaf_stats_plain(Xt, qs), q1_turns, q1_bound),
                    ("combine_ei", q2, lambda: P.combine_ei_plain(m, v, ystats, inc, meta),
                     q2_turns, q2_bound)):
                source, replaces = PROPOSE_SOURCES[name]
                rows[name] = dict(
                    name=name, source=source, replaces=replaces,
                    shape=f"sources={S} trees={T} pool={N}x{space.dim}", match=match[name],
                    max_abs_err=err[name], ms=(turns[1] + turns[2]) / 2,
                    events_ms=cuda_time_ms(kernel, 20), plain_ms=cuda_time_ms(plain, 2),
                    bound_ms=bnd[0], bound_by=bnd[1], library_ms=None,
                    launch_floor_ms=floor_ms)
    for name, r in rows.items():
        r["tuner_pool_traced_ms"] = numbers[PROPOSE_TIMED[0]][
            "q1_traced_ms" if name == "qs_descent" else "q2_traced_ms"]

    # the device pool: fresh draws a replay, the same pools from the same seed
    pool_eng = [ProposeEngine(space, seed=0, pool_size=PROPOSE_BUCKETS[-1]) for _ in range(2)]
    draws = [[e.propose(forests, incs, ws, PROPOSE_N) for _ in range(2)] for e in pool_eng]
    same = all(np.array_equal(a[1], b[1]) for a, b in zip(*draws))
    fresh = not np.array_equal(draws[0][0][1], draws[0][1][1])
    ok_rows = all(np.all((d[1] >= 0) & (d[1] <= 1)) and np.all(np.isfinite(d[2]))
                  for d in draws[0])
    dev_prof = step_profile(lambda: pool_eng[0].propose(forests, incs, ws, PROPOSE_N))
    numbers["device_pool"] = dict(device_ms=dev_prof, graphs=pool_eng[0].graph_stats())
    print(f"[propose] device pool at {PROPOSE_BUCKETS[-1]}: same seed same pools {same}, a "
          f"replay draws a fresh pool {fresh}, rows in [0, 1] with finite aggregates {ok_rows}; "
          f"device ms a call by stage {dev_prof}", flush=True)
    if not (same and fresh and ok_rows):
        fail("the device pool's draws are not fresh a replay and equal from one seed")
    return rows["qs_descent"], rows["combine_ei"], launches, numbers


def check_k3_sizes(device) -> None:
    """K3 at the sizes the tuner does not reach: a two-word forest (220
    observations of noise on 5 features), 120 trees (the staged route tiles
    them, the values route declines), 64 features, 512 chains; every route
    held to its plain version bit for bit (``k3_turns``), each route's
    kernel time by trace."""
    import numpy as np
    import torch

    from repro_torch.core.surrogate import make_forest
    from repro_torch.kernels.forest_eval import chain
    from repro_torch.kernels.launch import n_sms

    cases = (("two_words", 220, 5, 10, True, 48, 6), ("trees_120", 50, 60, 120, False, 268, 16),
             ("d_64", 50, 64, 10, False, 268, 16), ("chains_512", 50, 60, 10, False, 512, 16))
    for label, n_obs, d, n_trees, noise, C, nb in cases:
        rng = np.random.default_rng(1)
        X = rng.random((n_obs, d))
        y = rng.normal(size=n_obs) if noise else (
            np.sin(4 * X[:, 0]) + X[:, 1] + 0.1 * rng.standard_normal(n_obs))
        plan, reason = chain.build_chain_plan_ex(
            make_forest(seed=1, device=device, n_trees=n_trees).fit(X, y), d)
        if plan is None:
            fail(f"K3 {label}: no chain plan ({reason})")
        Xc, bg = rng.random((4, d)), rng.random((nb, d))
        perms = np.stack([rng.permutation(d) for _ in range(C)]).astype(np.int32)
        xoc = rng.integers(0, 4, C).astype(np.int32)
        args = (chain.words_tensor(plan.row_words(Xc), device),
                torch.from_numpy(xoc).to(device), chain.words_tensor(plan.row_words(bg), device),
                torch.from_numpy(perms).to(device), plan.leaf_mean, plan.leaf_offs,
                plan.forest.y_std, plan.forest.y_mean)
        shape = (C, d, nb, plan.n_trees, plan.n_words, n_sms(plan.device))
        staged = chain.staged_plan(*shape)
        print(f"[kernels] chain_ordinals {label}: chains={C} d={d} bg={nb} "
              f"trees={plan.n_trees} words={plan.n_words}; ordinals plan "
              f"{chain.ordinals_plan(*shape)}, staged plan {staged}", flush=True)
        if label == "trees_120" and staged.tiles < 2:
            fail("K3's staged route at 120 trees did not tile its trees")
        k3_turns(args, 20)


# ---------------------------------------------------------------------------
# the paper's baseline tuners (ROADMAP item 9) through K1 and K2
# ---------------------------------------------------------------------------

BASELINES = ("RandomSearch", "VanillaBO", "LOCAT", "TopTune", "Rover", "LOFTune", "Tuneful")
BASELINE_K1 = ("VanillaBO", "LOCAT", "LOFTune", "Rover")  # must launch K1 in the grid run
BASELINE_K2 = ("Rover",)                                  # must launch K2 in the grid run
BASELINE_HOURS = 24.0          # the paper's §7.1 budget, every tuner
AGREE_HOURS = 8.0              # the card-against-CPU runs (2-task knowledge base)
COMPRESSORS = ("BoxCompressor", "DecreaseCompressor", "ProjectCompressor", "VoteCompressor")
BASELINE_TRACED = "Rover"      # the tuner whose trace is exported and validated


def fresh_kb(kb):
    """A knowledge base of ``kb``'s source records without the target's:
    the tuners read the sources and never write them, and Rover adds its
    own target record to the knowledge base it is given."""
    from repro_torch.core import KnowledgeBase
    from repro_torch.sparksim import make_task_id

    out = KnowledgeBase()
    target = make_task_id(*TARGET)
    for tid, rec in kb.tasks.items():
        if tid != target:
            out.add_task(rec, persist=False)
    return out


def run_baseline(name: str, kb, device, hours: float) -> dict:
    """One baseline tuner's fixed-seed run on TPC-H 100 GB, hardware A, with
    every kernel's count reset just before ``run`` and read just after."""
    import torch

    from repro_torch import baselines, obs
    from repro_torch.kernels import counts
    from repro_torch.sparksim import SparkWorkload
    from repro_torch.tuneapi import Budget

    tuner = getattr(baselines, name)(SparkWorkload(*TARGET), kb=kb, seed=0, device=device)
    counts.reset()
    t0 = time.perf_counter()
    with obs.tracing(name=f"baseline:{name}") as tracer:
        res = tuner.run(Budget(hours * 3600.0))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    snap = counts.snapshot()
    stream = [(o.performance, o.fidelity, o.failed, tuple(sorted(o.config.items())))
              for o in tuner.obs]
    traj = [(p.time, p.best, tuple(sorted(p.config.items()))) for p in res.trajectory]
    return dict(res=res, stream=stream, traj=traj, wall=wall, tracer=tracer,
                launches={k: v for k, v in snap["launches"].items() if v},
                plain={k: v for k, v in snap["plain_calls"].items() if v})


class CountedCompressor:
    """An ``MFTuneOptions.compressor`` that counts its calls."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def __call__(self, space, weights, tasks, target=None):
        self.calls += 1
        return self.inner(space=space, weights=weights, tasks=tasks, target=target)


def check_trace_export(tracer) -> dict:
    """Export a tuner's trace with the port's exporters, read both files back
    and validate every event against the port's schema."""
    import tempfile

    from repro_torch import obs

    with tempfile.TemporaryDirectory() as td:
        pf, jl = Path(td) / "trace.perfetto.json", Path(td) / "trace.jsonl"
        obs.export_perfetto(tracer, str(pf))
        obs.export_jsonl(tracer, str(jl))
        back_pf, back_jl = obs.read_events(str(pf)), obs.read_events(str(jl))
        out = dict(events=len(back_pf), perfetto_bytes=pf.stat().st_size,
                   violations=len(obs.validate_events(back_pf))
                   + len(obs.validate_events(back_jl)),
                   spans=sum(e["type"] == "span" for e in back_pf))
    print(f"[baselines] trace of {BASELINE_TRACED}: {out['events']} events, {out['spans']} "
          f"spans, perfetto {out['perfetto_bytes']} bytes, schema violations "
          f"{out['violations']}", flush=True)
    if out["violations"] or len(back_pf) != len(back_jl) or not out["spans"]:
        fail(f"the exported baseline trace does not validate: {out}")
    return out


def baselines_agree(specs) -> dict:
    """Each tuner, and MFTune with each space-compression variant, at 8 h on
    the 2-task knowledge base of :func:`run_agreement`, on the card and then
    on the CPU: the observation streams and trajectories must be identical,
    and each compressor called."""
    from repro_torch import baselines

    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        kb = build_kb(specs, 20, dev)
        for name in BASELINES:
            r = run_baseline(name, fresh_kb(kb), dev, AGREE_HOURS)
            if dev == "cuda" and r["plain"]:
                fail(f"{name} on the card reached a plain version: {r['plain']}")
            out[(name, dev)] = (r["stream"], r["traj"], r["res"].best_performance)
        for cname in COMPRESSORS:
            inner = getattr(baselines, cname)
            comp = CountedCompressor(inner(device=dev) if cname == "DecreaseCompressor"
                                     else inner())
            res, sig, traj, _ = tune(fresh_kb(kb), dev, AGREE_HOURS, compressor=comp)
            if comp.calls == 0:
                fail(f"MFTune on {dev} never called {cname}")
            out[(cname, dev)] = (sig, traj, res.best_performance, comp.calls)
        print(f"[baselines] agree: {dev} runs in {time.perf_counter() - t0:.3f} s", flush=True)
    rows = {}
    for name in BASELINES + COMPRESSORS:
        a, b = out[(name, "cuda")], out[(name, "cpu")]
        same = a[0] == b[0] and a[1] == b[1] and a[2] == b[2]
        rows[name] = dict(evaluations=len(a[0]), identical=same, best=a[2],
                          **({"compressor_calls": a[3]} if len(a) > 3 else {}))
        print(f"[baselines] agree {name}: cuda and cpu identical={same} "
              f"observations={len(a[0])} best_latency_s={a[2]}"
              + (f" compressor_calls={a[3]}" if len(a) > 3 else ""), flush=True)
    bad = [n for n, r in rows.items() if not (r["identical"] and r["evaluations"] > 0)]
    if bad:
        fail(f"card and CPU runs disagree: {bad}")
    return rows


def run_baselines(device, mftune_best=None, kb=None) -> tuple:
    """The seven baseline tuners at the paper's §7.1 setting (TPC-H 100 GB on
    hardware A, a knowledge base of the other 31 tasks x 50 observations,
    24 virtual hours, seed 0) on the card, each on a fresh knowledge base;
    the largest K1 and K2 calls of these runs held against their plain
    versions; one tuner's trace exported and validated; then the card
    against the CPU. Returns (K1 and K2's numbers for the kernels line, the
    phase's numbers)."""
    import math

    from repro_torch.sparksim import TaskSpec

    t_phase = time.perf_counter()
    if kb is None:
        t0 = time.perf_counter()
        kb = grid_kb(KB_OBS, device)
        print(f"[baselines] {len(kb.tasks)} histories x {KB_OBS} built in "
              f"{time.perf_counter() - t0:.1f}s", flush=True)
    runs = {}
    with capture_calls() as captured:
        for name in BASELINES:
            r = run_baseline(name, fresh_kb(kb), device, BASELINE_HOURS)
            res = r["res"]
            runs[name] = r
            print(f"[baselines] {name}: hours={BASELINE_HOURS} evaluations={res.n_evaluations} "
                  f"best_latency_s={res.best_performance} wall_s={r['wall']:.3f} "
                  f"launches={r['launches']} plain_calls={r['plain']} overheads_s="
                  + " ".join(f"{k}={v:.3f}" for k, v in res.overheads.items())
                  + " spans_s=" + " ".join(f"{k}={v:.3f}"
                                           for k, v in span_seconds(r["tracer"]).items()),
                  flush=True)
    if mftune_best is not None:
        print(f"[baselines] MFTune (the tuner phase, same setting): best_latency_s={mftune_best}",
              flush=True)
    print("[baselines] table: " + "; ".join(
        f"{n} {r['res'].n_evaluations} evals best {r['res'].best_performance:.3f} s "
        f"wall {r['wall']:.3f} s K1 {r['launches'].get('forest_eval', 0)} "
        f"K2 {r['launches'].get('radix_rank', 0)}" for n, r in runs.items())
        + (f"; MFTune best {mftune_best:.3f} s" if mftune_best is not None else ""), flush=True)
    for name, r in runs.items():
        best = r["res"].best_performance
        if not (math.isfinite(best) and best > 0):
            fail(f"{name} found no finite best latency")
        if r["plain"]:
            fail(f"{name} on the card reached a plain version: {r['plain']}")
    missing = ([f"{n}: forest_eval" for n in BASELINE_K1
                if not runs[n]["launches"].get("forest_eval")]
               + [f"{n}: radix_rank" for n in BASELINE_K2
                  if not runs[n]["launches"].get("radix_rank")])
    if missing:
        fail(f"kernels never launched on the baselines' path: {missing}")
    held = {}
    for name in ("forest_eval", "radix_rank"):
        rec = captured[name]
        print(f"[baselines] {name}: calls by shape: {dict(rec['shapes'].most_common(6))}",
              flush=True)
        row = hold(name, rec["largest"], reps=50)
        if not row["match"]:
            fail(f"{name} disagrees with its plain version at the baselines' largest call")
        held[name] = {k: row[k] for k in ("shape", "match", "max_abs_err", "ms", "plain_ms",
                                          "bound_ms", "bound_by")}
    trace = check_trace_export(runs[BASELINE_TRACED]["tracer"])
    agree = baselines_agree([TaskSpec("tpch", 600, "B"), TaskSpec("tpch", 100, "B")])
    kernel_keys = {
        name: dict(baselines_launches={n: r["launches"].get(name, 0) for n, r in runs.items()},
                   baselines_largest=held[name])
        for name in ("forest_eval", "radix_rank")}
    phase = dict(
        hours=BASELINE_HOURS, mftune_best=mftune_best, trace=trace, agree=agree,
        tuners={n: dict(evaluations=r["res"].n_evaluations, best=r["res"].best_performance,
                        wall_s=r["wall"], overheads=r["res"].overheads,
                        launches=r["launches"]) for n, r in runs.items()},
        seconds=time.perf_counter() - t_phase)
    print(f"[baselines] phase seconds {phase['seconds']:.1f}", flush=True)
    return kernel_keys, phase


def run_agreement() -> None:
    from repro_torch.sparksim import TaskSpec

    specs = [TaskSpec("tpch", 600, "B"), TaskSpec("tpch", 100, "B")]
    out = {}
    for dev in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res, sig, traj, _ = tune(build_kb(specs, 20, dev), dev, hours=8.0)
        out[dev] = (sig, traj)
        print(f"[agree] {dev}: evaluations={res.n_evaluations} "
              f"best_latency_s={res.best_performance} wall_s={time.perf_counter() - t0:.3f}",
              flush=True)
    same_obs = out["cuda"][0] == out["cpu"][0]
    same_traj = out["cuda"][1] == out["cpu"][1]
    print(f"[agree] observations identical={same_obs} trajectory identical={same_traj}",
          flush=True)
    if not (same_obs and same_traj and len(out["cuda"][0]) > 10):
        fail("cuda and cpu runs disagree")


# ---------------------------------------------------------------------------
# LM serving path (llama3-8b at full width)
# ---------------------------------------------------------------------------

LM_ARCH = "llama3-8b"
PREFILL = (2, 4096)           # batch x prompt tokens of the prefill
SERVE_REQS, SERVE_PROMPT, SERVE_NEW, SERVE_MAX_LEN = 4, 64, 32, 128
SOFTMAX_BOUND = 5e-2          # the bound of tests/test_decode_consistency.py
# max |logit diff| / max |logit| between the flash and plain routes and
# between decode and forward: on an H100 the two read 9.7e-3 and 1.4e-2,
# and another first token of a 64-token context moves the last position's
# logits by 1.3
LOGIT_TOL = 5e-2
# K4 against its plain version, (atol, rtol) on o: float32 at the tolerance
# of tests/test_kernels.py (the float32 route computes in float32 on the
# CUDA cores, as the plain version does); bfloat16 within one bf16 rounding
# step (2**-7 relative) of o plus 1e-3: the bf16 route takes both products
# on the tensor cores from the bf16 inputs with float32 sums, and P enters
# P . V as two bf16 halves, hi = bf16(p) and lo = bf16(p - hi), which keep
# about 16 bits of p; one bf16 P (2**-9 relative) puts rows whose output
# cancels to near 0 outside the 1e-3 (tests/test_torch_flash_split.py); lse
# (float32 in both dtypes) within 1e-3 absolute
K4_O_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 8e-3)}
K4_LSE_ATOL = 1e-3
K4_SOURCE = ("src/repro_torch/csrc/flash_attn_fwd.cu", "src/repro/kernels/flash_attn/kernel.py:77")


def logit_errs(a, b) -> tuple:
    """(max |a - b| / max |b|, max abs difference of the softmaxes, largest
    probability of b) over the last axis, in float32."""
    import torch

    a, b = a.float(), b.float()
    pb = torch.softmax(b, -1)
    return (float((a - b).abs().max() / b.abs().max()),
            float((torch.softmax(a, -1) - pb).abs().max()), float(pb.max()))


def k4_errs(o, lse, po, plse) -> tuple:
    """(o within tolerance, max |o - po|, max |lse - plse|) of K4's outputs
    against its plain version's."""
    import torch

    atol, rtol = K4_O_TOL[str(o.dtype)[6:]]
    o_err = float((o.float() - po.float()).abs().max())
    lse_err = float((lse - plse).abs().max())
    ok = bool(torch.allclose(o.float(), po.float(), atol=atol, rtol=rtol)
              and lse_err <= K4_LSE_ATOL)
    return ok, o_err, lse_err


@contextlib.contextmanager
def keep_calls(module, wrapper: str, indices):
    """While active, a copy of the inputs of each listed launch (counted from
    0) of ``module.<wrapper>`` is kept in the yielded dict, as ``{index:
    (args, kwargs)}``."""
    import torch

    kept: dict = {}
    original = getattr(module, wrapper)
    calls = [0]

    def wrapped(*args, **kwargs):
        if calls[0] in indices:
            kept[calls[0]] = (tuple(a.clone() if torch.is_tensor(a) else a for a in args),
                              dict(kwargs))
        calls[0] += 1
        return original(*args, **kwargs)

    setattr(module, wrapper, wrapped)
    try:
        yield kept
    finally:
        setattr(module, wrapper, original)
        torch.cuda.synchronize()


def visible_pairs(Sq: int, Sk: int, causal: bool, window, q_offset: int) -> int:
    """(query, key) pairs the positional mask lets through, per (BH, group)."""
    import numpy as np

    qpos = q_offset + np.arange(Sq, dtype=np.int64)
    hi = np.minimum(qpos + 1, Sk) if causal else np.full(Sq, Sk)
    lo = np.maximum(qpos - window + 1, 0) if window is not None else np.zeros(Sq, np.int64)
    return int(np.maximum(hi - lo, 0).sum())


def sdpa_yardstick(q, k, v, causal: bool = True, window=None):
    """One ``scaled_dot_product_attention`` call on K4's inputs with KV
    expanded to every query head, a boolean mask for a window (timed beside
    K4, never used)."""
    import torch
    import torch.nn.functional as F

    BH, S, G, D = q.shape
    Sk = k.shape[1]
    qs = q.permute(0, 2, 1, 3).contiguous()
    ks, vs = (t[:, None].expand(BH, G, Sk, D).contiguous() for t in (k, v))
    if window is None:
        return lambda: F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)
    qp = torch.arange(S, device=q.device)[:, None]
    kp = torch.arange(Sk, device=q.device)[None, :]
    mask = (qp - kp < window) & ((qp >= kp) if causal else True)
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask)


def k4_bound(q, k, v, kwargs, ops_per_s: float = BF16_OPS_PER_S) -> tuple:
    """(bound_ms, bound_by, flops) of K4 on these inputs: two products over
    the visible (query, key) pairs, q, k and v read once, o (q's dtype) and
    lse (float32) written once."""
    BH, Sq, G, D = q.shape
    pairs = visible_pairs(Sq, k.shape[1], kwargs["causal"], kwargs["window"], kwargs["q_offset"])
    flops = 4.0 * BH * G * D * pairs   # two products, a multiply and an add each
    out_bytes = nbytes(q) + BH * Sq * G * 4
    b_ms, b_by = bound(nbytes(q, k, v) + out_bytes, flops, ops_per_s)
    return b_ms, b_by, flops


def k4_simt(q, k, v, causal: bool, window, q_offset: int):
    """K4 in bf16 through the earlier CUDA-core design, exported as
    ``flash_attn_fwd_bf16_simt`` for this comparison only (the port's
    wrappers never reach it; no launch is counted)."""
    import torch

    from repro_torch.kernels.launch import _fn

    BH, Sq, G, D = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq, G), dtype=torch.float32, device=q.device)
    rc = _fn("flash_attn_fwd", "flash_attn_fwd_bf16_simt", 5, 9, 0)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(), BH, Sq,
        k.shape[1], G, D, int(causal), int(window is not None), window or 0, q_offset,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail(f"K4's CUDA-core design failed to launch: CUDA error {rc}")
    return o, lse


def time_k4_designs(q, k, v, kwargs, reps: int = 10) -> tuple:
    """(ms of the wgmma route, ms of the CUDA-core design, SDPA ms, the four
    turns) on these bf16 inputs, the two designs timed in turns: CUDA
    cores, wgmma, wgmma, CUDA cores, each the mean of ``reps`` calls; the
    means of each pair."""
    from repro_torch.kernels.flash_attn import ops

    new = lambda: ops.flash_fwd_cuda(q, k, v, **kwargs)           # noqa: E731
    old = lambda: k4_simt(q, k, v, **kwargs)                       # noqa: E731
    old_ms, new_ms, turns = in_turns(old, new, reps)
    sdpa = cuda_time_ms(sdpa_yardstick(q, k, v, kwargs["causal"], kwargs["window"]), reps)
    return new_ms, old_ms, sdpa, turns


def hold_k4_path(tag: str, args, kwargs, launches: int) -> dict:
    """K4 on the inputs of a path's first K4 call: against its plain version
    (the bf16 gate), then both designs timed in turns beside SDPA and the
    bound; returns the path's entry of K4's ``by_path``."""
    import torch

    from repro_torch.kernels.flash_attn import ops

    q, k, v = args
    o, lse = ops.flash_fwd_cuda(q, k, v, **kwargs)
    po, plse = ops.flash_fwd_plain(q, k, v, q_block=512, kv_block=1024, **kwargs)
    torch.cuda.synchronize()
    match, o_err, lse_err = k4_errs(o, lse, po, plse)
    del o, lse, po, plse
    ms, simt_ms, sdpa_ms, turns = time_k4_designs(q, k, v, kwargs)
    b_ms, b_by, flops = k4_bound(q, k, v, kwargs)
    row = dict(path=tag, shape=f"q={tuple(q.shape)} kv={tuple(k.shape)} {str(q.dtype)[6:]} "
                               f"causal={kwargs['causal']} window={kwargs['window']}",
               match=match, o_err=o_err, lse_err=lse_err, ms=ms, simt_ms=simt_ms,
               sdpa_ms=sdpa_ms, bound_ms=b_ms, bound_by=b_by, launches=launches)
    print(f"[{tag}] K4 at the first K4 call's inputs: {row['shape']} match={match} o err {o_err} "
          f"lse err {lse_err}; ms={ms:.6f} CUDA-core design ms={simt_ms:.6f} (turns CUDA cores, "
          f"wgmma, wgmma, CUDA cores: {', '.join(f'{t:.6f}' for t in turns)}) "
          f"sdpa_ms={sdpa_ms:.6f} bound_ms={b_ms:.6f} ({b_by}) flops={flops:.4g} "
          f"launches={launches}", flush=True)
    if not match:
        fail(f"K4 disagrees with its plain version at the {tag} path's inputs: o err {o_err}, "
             f"lse err {lse_err}")
    return row


def hold_flash(args, kwargs, launches: int) -> dict:
    """K4 on the prefill's own inputs against its plain version, in their
    dtype (bf16) and upcast to float32 (the float32 route, timed too), then
    both bf16 designs timed beside each other, beside SDPA, and against
    the bound."""
    import torch

    from repro_torch.kernels.flash_attn import ops

    q, k, v = args
    o, lse = ops.flash_fwd_cuda(q, k, v, **kwargs)
    po, plse = ops.flash_fwd_plain(q, k, v, q_block=512, kv_block=1024, **kwargs)
    torch.cuda.synchronize()
    match, o_err, lse_err = k4_errs(o, lse, po, plse)
    err, bf16_errs = max(o_err, lse_err), dict(o_err=o_err, lse_err=lse_err)
    print(f"[serve] K4 vs plain at the prefill's inputs, bf16: max|o|={float(po.abs().max())} "
          f"o err {o_err} lse err {lse_err} match={match}", flush=True)
    del o, lse, po, plse
    q32, k32, v32 = q.float(), k.float(), v.float()
    o, lse = ops.flash_fwd_cuda(q32, k32, v32, **kwargs)
    po, plse = ops.flash_fwd_plain(q32, k32, v32, q_block=512, kv_block=1024, **kwargs)
    torch.cuda.synchronize()
    match32, o_err, lse_err = k4_errs(o, lse, po, plse)
    print(f"[serve] K4 vs plain at the prefill's inputs upcast to float32: max|o|="
          f"{float(po.abs().max())} o err {o_err} lse err {lse_err} match={match32}", flush=True)
    match = match and match32
    del o, lse, po, plse
    f32_ms = cuda_time_ms(lambda: ops.flash_fwd_cuda(q32, k32, v32, **kwargs), 5)
    f32_b_ms, f32_b_by, _ = k4_bound(q32, k32, v32, kwargs, FP32_OPS_PER_S)
    del q32, k32, v32
    ms, simt_ms, sdpa_ms, turns = time_k4_designs(q, k, v, kwargs)
    b_ms, b_by, flops = k4_bound(q, k, v, kwargs)
    row = dict(name="flash_attn_fwd", source=K4_SOURCE[0], replaces=K4_SOURCE[1],
               shape=f"q={tuple(q.shape)} kv={tuple(k.shape)} {str(q.dtype)[6:]} "
                     f"causal={kwargs['causal']}",
               match=match, max_abs_err=err, ms=ms,
               plain_ms=cuda_time_ms(lambda: ops.flash_fwd_plain(
                   q, k, v, q_block=512, kv_block=1024, **kwargs), 3),
               bound_ms=b_ms, bound_by=b_by, library_ms=sdpa_ms,
               float32_ms=f32_ms, float32_bound_ms=f32_b_ms, float32_bound_by=f32_b_by)
    print(f"[serve] K4 at the prefill's inputs: {row['shape']} match={match} max_abs_err={err} "
          f"ms={ms:.6f} CUDA-core design ms={simt_ms:.6f} (turns CUDA cores, wgmma, wgmma, "
          f"CUDA cores: {', '.join(f'{t:.6f}' for t in turns)}) plain_ms={row['plain_ms']:.6f} "
          f"sdpa_ms={sdpa_ms:.6f} bound_ms={b_ms:.6f} ({b_by}) flops={flops:.4g} "
          f"launches={launches}; float32 route ms={f32_ms:.6f} against its bound "
          f"{f32_b_ms:.6f} ({f32_b_by}, float32 at {FP32_OPS_PER_S:.3g} op/s)", flush=True)
    row["by_path"] = [dict(path="serve", shape=row["shape"], match=match, **bf16_errs, ms=ms,
                           simt_ms=simt_ms, sdpa_ms=sdpa_ms, bound_ms=b_ms, bound_by=b_by,
                           launches=launches)]
    return row


def check_flash_small() -> list:
    """K4 against its plain version at small shapes, both dtypes, every
    mask variant; returns the names of the cases that disagree."""
    import torch

    from repro_torch.kernels.flash_attn import ops

    bad, worst = [], {}
    g = torch.Generator(device="cpu").manual_seed(0)
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for BH, Sq, Sk, G, D in [(2, 64, 64, 1, 16), (3, 48, 80, 3, 64), (2, 128, 256, 4, 128)]:
            # (causal, window, q rows, q_offset): the last two cases put the
            # rows at the end of the keys, and past them, where the rows from
            # position Sk + 31 on see no key
            for causal, window, sq, offset in [
                    (True, None, Sq, 0), (False, None, Sq, 0), (True, 32, Sq, 0),
                    (False, 32, Sq, 0), (True, None, Sq // 2, Sk - Sq // 2),
                    (False, 32, Sq, Sk - 16)]:
                q = torch.randn((BH, sq, G, D), generator=g).to("cuda", td)
                k = torch.randn((BH, Sk, D), generator=g).to("cuda", td)
                v = torch.randn((BH, Sk, D), generator=g).to("cuda", td)
                kw = dict(causal=causal, window=window, q_offset=offset)
                o, lse = ops.flash_fwd_cuda(q, k, v, **kw)
                po, plse = ops.flash_fwd_plain(q, k, v, q_block=8, kv_block=16, **kw)
                ok, o_err, lse_err = k4_errs(o, lse, po, plse)
                w = worst.setdefault(dtype, [0.0, 0.0])
                w[0], w[1] = max(w[0], o_err), max(w[1], lse_err)
                if not ok:
                    bad.append(f"{dtype} {(BH, sq, Sk, G, D)} {kw}")
    print(f"[serve] K4 small shapes x masks x dtypes: max abs err [o, lse] {worst} "
          f"disagree={bad}", flush=True)
    return bad


def device_profile(fn, label: str, reps: int, tag: str = "serve") -> dict:
    """Time ``fn`` on the host clock (mean of ``reps`` calls), then run it
    once under ``torch.profiler`` and print the number of CUDA kernels it
    ran, their summed device time, the device busy share of the
    unprofiled wall (the profiler's own wall is longer), the kernels that
    took the most and the device time by class of kernel; returns the wall,
    the busy seconds and share and the ms by class."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / reps
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not kernels:
        print(f"[{tag}] profile {label}: wall_s={wall:.6f}; the profiler saw no device "
              f"kernels (device time not measured)", flush=True)
        return {"wall_s": wall, "busy_s": None, "busy_share": None, "ms_by_class": {}}
    by_name: Counter = Counter()
    by_class: Counter = Counter()
    for e in kernels:
        us = e.time_range.elapsed_us()
        by_name[e.name[:60]] += us
        by_class[kernel_class(e.name)] += us
    busy = sum(by_name.values()) / 1e6
    top = ", ".join(f"{n} {us / 1e3:.3f}ms" for n, us in by_name.most_common(6))
    classes = ", ".join(f"{n} {us / 1e3:.3f}ms" for n, us in by_class.most_common())
    print(f"[{tag}] profile {label}: wall_s={wall:.6f} (mean of {reps}, unprofiled) "
          f"profiled_wall_s={pwall:.6f} kernels={len(kernels)} device_busy_s={busy:.6f} "
          f"busy_share={busy / wall:.4f}; top: {top}; by class: {classes}", flush=True)
    return {"wall_s": wall, "busy_s": busy, "busy_share": busy / wall,
            "ms_by_class": {n: us / 1e3 for n, us in by_class.items()}}


def kernel_class(name: str) -> str:
    """A coarse class of a CUDA kernel, by its name."""
    if any(t in name for t in ("decode_partial", "decode_combine", "decode_ring")):
        return "decode attention K7"
    if any(t in name for t in ("ssd_kernel", "ssd_states", "ssd_out")):
        return "SSD scan K8"
    if "state_pass" in name:
        return "state pass of K8 or K12"
    if "flash_" in name:
        return "attention K4-K6"
    if "gmm_" in name:
        return "expert products K9"
    if "rmsnorm_" in name:
        return "RMSNorm K10/K11"
    if any(t in name for t in ("wkv_kernel", "wkv_states", "wkv_out")):
        return "WKV scan K12"
    if "f32f32" in name or "sgemm" in name:
        return "float32 GEMM"
    if any(t in name for t in ("gemm", "nvjet", "xmma", "cutlass")):
        return "bf16 GEMM"
    if any(t in name for t in ("elementwise", "reduce", "Reduce", "index", "gather", "scatter",
                               "cat", "copy", "fill", "softmax", "norm")):
        return "elementwise, copies and reductions"
    return "other"


LONG_CACHE = 4096             # keys of each row of the long-context decode step


@contextlib.contextmanager
def k7_route(route: str):
    """While active, every K7 call on the card takes ``route``."""
    from repro_torch.kernels.flash_decode import ops

    original = ops.decode_route
    ops.decode_route = lambda D, aligned: route
    try:
        yield
    finally:
        ops.decode_route = original


def run_long_decode(params, cfg, rt, device) -> dict:
    """One decode step of SERVE_REQS rows whose cache holds LONG_CACHE keys
    each, drawn on the card from seed 6 (the step writes the last): K7's
    launches (one a layer, all on the ring route, no plain call), the
    step's logits on the ring route against the first design's (within
    LOGIT_TOL of their largest magnitude), then the step timed by wall and
    by profiled device busy with each route in turns (first, ring, ring,
    first)."""
    import torch

    from repro_torch.kernels import counts
    from repro_torch.models import decode_step, init_cache

    B, S = SERVE_REQS, LONG_CACHE
    cache = init_cache(cfg, rt, B, S, device=device)
    g = torch.Generator(device=device).manual_seed(6)
    cache["k"].normal_(generator=g)
    cache["v"].normal_(generator=g)
    cache["pos"].fill_(S - 1)
    toks = torch.full((B, 1), 7, device=device)
    step = lambda: decode_step(params, cfg, rt, cache, toks)[0]     # noqa: E731
    step()
    counts.reset()
    logits = step()
    torch.cuda.synchronize()
    k7, ring = counts.LAUNCHES["flash_decode"], counts.ROUTE_LAUNCHES.get("flash_decode/ring", 0)
    plain = sum(counts.PLAIN_CALLS.values())
    with k7_route("scalar"):
        first = step()
    rel, err, pmax = logit_errs(logits, first)
    print(f"[serve] long-context decode step, {B} rows of {S} keys: K7 launches={k7} (ring route "
          f"{ring}, want {cfg.n_layers}) plain_calls={plain}; ring vs first design: max|logit "
          f"diff|/max|logit| {rel} (bound {LOGIT_TOL}), softmax max diff {err} beside a largest "
          f"probability of {pmax}", flush=True)
    if k7 != cfg.n_layers or ring != k7 or plain:
        fail(f"the long-context decode step launched K7 {k7} times ({ring} on the ring route, "
             f"want {cfg.n_layers}) and plain versions {plain} times")
    if tuple(logits.shape) != (B, 1, cfg.vocab) or not bool(torch.isfinite(logits).all()) \
            or not rel <= LOGIT_TOL:
        fail(f"the long-context step's logits are not finite or the routes disagree: {rel}")
    turns = []
    for route in ("scalar", "ring", "ring", "scalar"):
        with k7_route(route):
            turns.append(device_profile(step, f"long-context decode step ({B}x{S} keys), K7 on "
                                              f"the {route} route", 10))
    del cache
    torch.cuda.empty_cache()

    def mean(route_turns, key):
        vals = [t[key] for t in route_turns]
        return None if None in vals else sum(vals) / len(vals)

    out = {"rows": B, "keys": S, "logit_rel_diff": rel}
    for route, ts in (("ring", turns[1:3]), ("first", [turns[0], turns[3]])):
        k7_ms = [t["ms_by_class"].get("decode attention K7") for t in ts]
        out[route] = {"wall_ms": mean(ts, "wall_s") * 1e3,
                      "busy_ms": None if mean(ts, "busy_s") is None else mean(ts, "busy_s") * 1e3,
                      "busy_share": mean(ts, "busy_share"),
                      "k7_device_ms": None if None in k7_ms else sum(k7_ms) / len(k7_ms)}
    print(f"[serve] long-context decode step, means of the turns: ring {out['ring']}, first "
          f"design {out['first']}", flush=True)
    return out


def run_serve(device) -> tuple:
    """The ``serve`` phase; returns (K4's row, K4's and K10's launches in the
    prefill, K7's in one decode step, the long-context decode step's
    numbers)."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.models import (Runtime, build_param_specs, decode_step, forward,
                                    init_cache, init_params, param_bytes)
    from repro_torch.serving import Request, ServingEngine

    cfg = get_arch(LM_ARCH)
    rt = Runtime(attn_impl="flash")
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    specs = build_param_specs(cfg, rt)
    params = init_params(specs, torch.Generator(device=device).manual_seed(0), device)
    torch.cuda.synchronize()
    print(f"[serve] {cfg.name}: {cfg.n_layers} layers d_model {cfg.d_model} heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim} d_ff {cfg.d_ff} vocab {cfg.vocab} "
          f"{rt.param_dtype}: {param_bytes(specs)} weight bytes drawn on {device} in "
          f"{time.perf_counter() - t0:.1f}s", flush=True)

    rng = np.random.default_rng(0)
    B, S = PREFILL
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab, (B, S))).to(device)
    with torch.no_grad():
        forward(params, cfg, rt, tokens=tokens[:1, :512])   # warm-up: cuBLAS, K4 load
        torch.cuda.synchronize()
        with keep_calls(flash_ops, "flash_fwd_cuda", (0,)) as kept:
            counts.reset()
            t0 = time.perf_counter()
            logits = forward(params, cfg, rt, tokens=tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            launches = counts.LAUNCHES["flash_attn_fwd"]
            k10 = counts.LAUNCHES["rmsnorm_fwd"]
            k10_resident = counts.ROUTE_LAUNCHES.get("rmsnorm_fwd/resident", 0)
            plain = sum(counts.PLAIN_CALLS.values())
        peak = torch.cuda.max_memory_allocated()
        print(f"[serve] prefill {B}x{S} attn_impl=flash: wall_s={wall:.6f} "
              f"tokens_per_s={B * S / wall:.1f} max_memory_allocated={peak} "
              f"K4 launches={launches} K10 launches={k10} (resident route {k10_resident}) "
              f"plain_calls={plain}", flush=True)
        if launches != cfg.n_layers or k10 != 2 * cfg.n_layers + 1 or plain != 0 \
                or k10_resident != k10:
            fail(f"prefill launched K4 {launches} times (want {cfg.n_layers}), K10 {k10} times "
                 f"(want {2 * cfg.n_layers + 1}, {k10_resident} on the resident route) and "
                 f"plain versions {plain} times (want 0)")
        if tuple(logits.shape) != (B, S, cfg.vocab) or not bool(torch.isfinite(logits).all()):
            fail(f"prefill logits of shape {tuple(logits.shape)} are not finite")
        sample = list(range(0, S, 512)) + [S - 1]
        flash_rows = logits[:, sample].float()
        del logits

        t0 = time.perf_counter()
        plain_logits = forward(params, cfg, dataclasses.replace(rt, attn_impl="xla"),
                               tokens=tokens)
        torch.cuda.synchronize()
        xla_wall = time.perf_counter() - t0
        rel, err, pmax = logit_errs(flash_rows, plain_logits[:, sample])
        del plain_logits
        print(f"[serve] prefill attn_impl=xla (plain blocked route): wall_s={xla_wall:.6f}; "
              f"flash vs xla at positions {sample}: max|logit diff|/max|logit| {rel} "
              f"(bound {LOGIT_TOL}), softmax max diff {err} (bound {SOFTMAX_BOUND}) "
              f"beside a largest probability of {pmax}", flush=True)
        if not (rel <= LOGIT_TOL and err < SOFTMAX_BOUND):
            fail(f"flash and xla routes disagree: logit diff {rel}, softmax diff {err}")

        engine = ServingEngine(params, cfg, rt, batch_size=SERVE_REQS, max_len=SERVE_MAX_LEN)
        reqs = [Request(prompt=rng.integers(2, cfg.vocab, SERVE_PROMPT).astype(np.int32),
                        max_new_tokens=SERVE_NEW) for _ in range(SERVE_REQS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        steps = SERVE_PROMPT + SERVE_NEW - 1
        n_new = sum(len(r.generated) for r in reqs)
        print(f"[serve] ServingEngine batch {SERVE_REQS} max_len {SERVE_MAX_LEN}: "
              f"{SERVE_REQS} greedy requests x {SERVE_PROMPT} prompt tokens, {n_new} new tokens "
              f"in wall_s={swall:.6f} ({steps} decode steps of {SERVE_REQS} slots: "
              f"step_ms={swall / steps * 1e3:.3f}, decode tokens_per_s="
              f"{SERVE_REQS * steps / swall:.1f}, new tokens_per_s={n_new / swall:.1f}); "
              f"first request: {reqs[0].generated[:8]}...", flush=True)
        if any(len(r.generated) != SERVE_NEW or not all(0 <= t < cfg.vocab for t in r.generated)
               for r in reqs):
            fail(f"not every request got {SERVE_NEW} tokens in range")

        prompt = torch.from_numpy(reqs[0].prompt[None].astype(np.int64)).to(device)
        par = forward(params, cfg, rt, tokens=prompt)[0].float()
        cache = init_cache(cfg, rt, 1, SERVE_PROMPT, device=device)
        dec = []
        for t in range(SERVE_PROMPT):
            lg, cache = decode_step(params, cfg, rt, cache, prompt[:, t:t + 1])
            dec.append(lg[0, 0].float())
        rel, derr, pmax = logit_errs(torch.stack(dec), par)
        # what the checks must be able to see: the last position's logits
        # when the first of the 64 context tokens is another one
        moved = prompt.clone()
        moved[0, 0] = 1
        sens = logit_errs(forward(params, cfg, rt, tokens=moved)[0, -1], par[-1])[0]
        print(f"[serve] decode_step teacher-forced over {SERVE_PROMPT} tokens vs forward: "
              f"max|logit diff|/max|logit| {rel} (bound {LOGIT_TOL}), softmax max diff {derr} "
              f"(bound {SOFTMAX_BOUND}) beside a largest probability of {pmax}; another first "
              f"token moves the last position's logits by {sens}", flush=True)
        if not (rel <= LOGIT_TOL and derr < SOFTMAX_BOUND):
            fail(f"decode and forward disagree: logit diff {rel}, softmax diff {derr}")
        if not sens > 4 * LOGIT_TOL:
            fail(f"the logit bound {LOGIT_TOL} is not 4x under the move {sens} that another "
                 f"context token makes")

        # where the time goes, from the profiler: one flash prefill and
        # one decode step of the 4-slot batch
        device_profile(lambda: forward(params, cfg, rt, tokens=tokens), f"prefill {B}x{S}", 2)
        cache = init_cache(cfg, rt, SERVE_REQS, SERVE_MAX_LEN, device=device)
        step_toks = torch.full((SERVE_REQS, 1), 7, device=device)
        for _ in range(SERVE_PROMPT):
            _, cache = decode_step(params, cfg, rt, cache, step_toks)
        counts.reset()
        decode_step(params, cfg, rt, cache, step_toks)
        torch.cuda.synchronize()
        k7, k7_plain = counts.LAUNCHES["flash_decode"], counts.PLAIN_CALLS["flash_decode"]
        k7_ring = counts.ROUTE_LAUNCHES.get("flash_decode/ring", 0)
        print(f"[serve] one decode step of {SERVE_REQS} slots: K7 launches={k7} (want "
              f"{cfg.n_layers}, ring route {k7_ring}) plain_calls={k7_plain}", flush=True)
        if k7 != cfg.n_layers or k7_plain or k7_ring != k7:
            fail(f"a decode step launched K7 {k7} times (want {cfg.n_layers}, {k7_ring} on the "
                 f"ring route)")
        device_profile(lambda: decode_step(params, cfg, rt, cache, step_toks),
                       f"decode step at position {SERVE_PROMPT + 1}", 10)
        del cache
        long_step = run_long_decode(params, cfg, rt, device)

    row = hold_flash(*kept[0], launches)
    bad = check_flash_small()
    if not row["match"] or bad:
        fail(f"K4 disagrees with its plain version: prefill match={row['match']} small={bad}")
    del params, engine, kept
    torch.cuda.empty_cache()
    return row, launches, k10, k7, long_step


# ---------------------------------------------------------------------------
# LM training path (llama3-8b at full width, depth cut to 8 layers)
# ---------------------------------------------------------------------------

TRAIN_LAYERS = 8              # llama3-8b's 32 layers cut to 8 (see run_train)
TRAIN_BATCH = (2, 4096)       # global batch x sequence length
TRAIN_STEPS = 3
TRAIN_KERNELS = ("flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv", "rmsnorm_fwd", "rmsnorm_bwd")
# a step early in a warm-up towards llama3's published peak of 3e-4: at 3e-4
# from initialisation, AdamW's first sign-like step moves every logit by
# about 1 and the loss on the next batch rises from 11.9 to 17 (H100 run)
TRAIN_LR = 1e-5
# |first loss - ln(vocab)|: at initialisation the logits are about unit
# normal, which puts the expected loss near ln(vocab) + 1/2
LOSS_MARGIN = 1.0
# flash vs xla route from the same weights and batch: the loss within 1e-2,
# and each gradient leaf within 5e-2 relative in L2 (bf16 roundings of the
# attention outputs, carried through 8 layers), which must also sit 4x under
# what another batch does to that leaf
ROUTE_LOSS_TOL = 1e-2
ROUTE_GRAD_TOL = 5e-2
# K5/K6 against their plain versions, (atol as a fraction of the plain
# output's largest magnitude, rtol): float32 2e-5 of both (the summation
# order differs); bfloat16 one bf16 rounding step (2**-7 relative: both
# compute in float32 from the same inputs, then round) plus 1e-3 of the
# largest magnitude for values near zero
BWD_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (1e-3, 8e-3)}
K5_SOURCE = ("src/repro_torch/csrc/flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:144")
K6_SOURCE = ("src/repro_torch/csrc/flash_attn_bwd.cu", "src/repro/kernels/flash_attn/kernel.py:211")


def bwd_errs(got, want) -> tuple:
    """(every output within BWD_TOL, max abs error, largest magnitude) of
    K5's or K6's outputs against the plain version's."""
    import torch

    frac, rtol = BWD_TOL[str(want[0].dtype)[6:]]
    ok, err, scale = True, 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        s = float(w.abs().max())
        ok = ok and bool(torch.allclose(g, w, atol=frac * s, rtol=rtol))
        err, scale = max(err, float((g - w).abs().max())), max(scale, s)
    return ok, err, scale


def sdpa_bwd_yardstick(q, k, v, do, batch: int):
    """The backward of one ``scaled_dot_product_attention(is_causal=True)``
    on K5's inputs with KV expanded to every query head: delta, dq, dk and
    dv in one library call (timed beside K5 and K6, never used)."""
    import torch
    import torch.nn.functional as F

    BHkv, S, G, D = q.shape
    Hkv = BHkv // batch

    def heads(t):
        return t.reshape(batch, Hkv, S, G, D).permute(0, 1, 3, 2, 4).reshape(batch, Hkv * G, S, D)

    def expand(t):
        return t.reshape(batch, Hkv, 1, S, D).expand(batch, Hkv, G, S, D).reshape(
            batch, Hkv * G, S, D)

    qs = heads(q).contiguous().requires_grad_(True)
    ks = expand(k).contiguous().requires_grad_(True)
    vs = expand(v).contiguous().requires_grad_(True)
    dos = heads(do).contiguous()
    o = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
    return lambda: torch.autograd.grad(o, (qs, ks, vs), dos, retain_graph=True)


def bwd_simt(name: str, q, k, v, do, lse, delta, causal: bool, window, q_offset: int):
    """K5 (``name`` "flash_attn_dq") or K6 in bf16 through the CUDA-core
    design, exported as ``flash_attn_dq_bf16_simt`` and
    ``flash_attn_dkv_bf16_simt`` for this comparison only (the port's
    wrappers never reach it; no launch is counted)."""
    import torch

    from repro_torch.kernels.launch import _fn

    BH, Sq, G, D = q.shape
    outs = (torch.empty_like(q),) if name == "flash_attn_dq" else (torch.empty_like(k),
                                                                   torch.empty_like(v))
    rc = _fn("flash_attn_bwd", f"{name}_bf16_simt", 6 + len(outs), 9, 0)(
        *(t.data_ptr() for t in (q, k, v, do, lse, delta, *outs)), BH, Sq, k.shape[1], G, D,
        int(causal), int(window is not None), window or 0, q_offset,
        torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        fail(f"{name}'s CUDA-core design failed to launch: CUDA error {rc}")
    return outs


def hold_bwd(call, launches: dict) -> list:
    """K5 and K6 on the first layer's inputs from the training step (``call``,
    the (args, kwargs) of K5's launch there) against their plain versions,
    in bf16 and upcast to float32 (the float32 route, timed too), then each
    timed in turns with its CUDA-core design (that, this, this, that),
    beside SDPA's backward, the bound and the kernel's own floor (its
    tensor-core products with p and ds as hi + lo halves)."""
    import torch

    from repro_torch.kernels.flash_attn import ops

    (q, k, v, do, lse, delta), kw = call
    plain_kw = dict(q_block=512, kv_block=1024, **kw)
    rows = []
    checks = {}
    for label, args in (("bf16", (q, k, v, do)),
                        ("upcast to float32", tuple(t.float() for t in (q, k, v, do)))):
        dq = ops.flash_dq_cuda(*args, lse, delta, **kw)
        pdq = ops.flash_dq_plain(*args, lse, delta, **plain_kw)
        dk, dv = ops.flash_dkv_cuda(*args, lse, delta, **kw)
        pdk, pdv = ops.flash_dkv_plain(*args, lse, delta, **plain_kw)
        torch.cuda.synchronize()
        checks[label] = (bwd_errs((dq,), (pdq,)), bwd_errs((dk, dv), (pdk, pdv)))
        (ok5, e5, s5), (ok6, e6, s6) = checks[label]
        print(f"[train] K5/K6 vs plain at the first layer's inputs, {label}: dq max|plain| {s5} "
              f"err {e5} match={ok5}; dk/dv max|plain| {s6} err {e6} match={ok6}", flush=True)
        del dq, pdq, dk, dv, pdk, pdv
    q32, k32, v32, do32 = (t.float() for t in (q, k, v, do))
    f32_ms = {"flash_attn_dq": cuda_time_ms(
        lambda: ops.flash_dq_cuda(q32, k32, v32, do32, lse, delta, **kw), 3),
              "flash_attn_dkv": cuda_time_ms(
        lambda: ops.flash_dkv_cuda(q32, k32, v32, do32, lse, delta, **kw), 3)}
    del q32, k32, v32, do32
    BH, Sq, G, D = q.shape
    pairs = visible_pairs(Sq, k.shape[1], kw["causal"], kw["window"], kw["q_offset"])
    in_bytes = nbytes(q, k, v, do, lse, delta)
    library_ms = cuda_time_ms(sdpa_bwd_yardstick(q, k, v, do, TRAIN_BATCH[0]), 10)
    shape = f"q={tuple(q.shape)} kv={tuple(k.shape)} {str(q.dtype)[6:]} causal={kw['causal']}"
    # (name, source, the function's products, the kernel's products with
    # p and ds split, output bytes, the wrapper, its plain version, checks)
    for name, source, n_products, n_kernel, out_bytes, fn, plain, ck in (
            ("flash_attn_dq", K5_SOURCE, 3, 4, nbytes(q),
             lambda: ops.flash_dq_cuda(q, k, v, do, lse, delta, **kw),
             lambda: ops.flash_dq_plain(q, k, v, do, lse, delta, **plain_kw), 0),
            ("flash_attn_dkv", K6_SOURCE, 4, 6, nbytes(k, v),
             lambda: ops.flash_dkv_cuda(q, k, v, do, lse, delta, **kw),
             lambda: ops.flash_dkv_plain(q, k, v, do, lse, delta, **plain_kw), 1)):
        flops = 2.0 * n_products * BH * G * D * pairs   # a multiply and an add per term
        b_ms, b_by = bound(in_bytes + out_bytes, flops, BF16_OPS_PER_S)
        floor_ms = bound(in_bytes + out_bytes, flops * n_kernel / n_products, BF16_OPS_PER_S)[0]
        old = lambda _n=name: bwd_simt(_n, q, k, v, do, lse, delta, **kw)   # noqa: E731
        simt_ms, ms, turns = in_turns(old, fn, 5)
        match = all(checks[lb][ck][0] for lb in checks)
        row = dict(name=name, source=source[0], replaces=source[1], shape=shape, match=match,
                   max_abs_err=max(checks[lb][ck][1] for lb in checks),
                   ms=ms, plain_ms=cuda_time_ms(plain, 3), bound_ms=b_ms,
                   bound_by=b_by, library_ms=library_ms,
                   library="backward of scaled_dot_product_attention (delta, dq, dk and dv "
                           "in one call, KV expanded to every head)",
                   simt_ms=simt_ms, simt_turns=list(turns), floor_ms=floor_ms,
                   float32_ms=f32_ms[name])
        print(f"[train] {name} at the first layer's inputs: {shape} match={match} "
              f"max_abs_err={row['max_abs_err']} ms={row['ms']:.6f} CUDA-core design "
              f"ms={row['simt_ms']:.6f} (turns CUDA cores, wgmma, wgmma, CUDA cores: "
              f"{', '.join(f'{t:.6f}' for t in turns)}) plain_ms="
              f"{row['plain_ms']:.6f} sdpa_bwd_ms={library_ms:.6f} bound_ms={b_ms:.6f} ({b_by}) "
              f"floor_ms={floor_ms:.6f} ({n_kernel} products) flops={flops:.4g} "
              f"launches={launches[name]}; float32 route ms={f32_ms[name]:.6f}", flush=True)
        rows.append(row)
    return rows


def check_bwd_small() -> list:
    """K5 and K6 against their plain versions at small shapes, both dtypes,
    every mask variant; returns the names of the cases that disagree."""
    import torch

    from repro_torch.kernels.flash_attn import ops

    bad, worst = [], {}
    g = torch.Generator(device="cpu").manual_seed(1)
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for BH, Sq, Sk, G, D in [(2, 64, 64, 1, 16), (3, 48, 80, 3, 64), (1, 40, 72, 2, 32),
                                 (2, 128, 256, 4, 128), (2, 96, 160, 1, 80)]:
            # (causal, window, q rows, q_offset): the last two put the rows
            # at the end of the keys and past them, where rows see no key
            for causal, window, sq, offset in [
                    (True, None, Sq, 0), (False, None, Sq, 0), (True, 32, Sq, 0),
                    (False, 32, Sq, 0), (True, None, Sq // 2, Sk - Sq // 2),
                    (False, 32, Sq, Sk - 16), (True, 16, Sq, Sk)]:
                q, do = (torch.randn((BH, sq, G, D), generator=g).to("cuda", td)
                         for _ in range(2))
                k, v = (torch.randn((BH, Sk, D), generator=g).to("cuda", td) for _ in range(2))
                kw = dict(causal=causal, window=window, q_offset=offset)
                o, lse = ops.flash_fwd_cuda(q, k, v, **kw)
                delta = (do.float() * o.float()).sum(-1)
                pkw = dict(q_block=sq, kv_block=8, **kw)
                ok5, e5, _ = bwd_errs((ops.flash_dq_cuda(q, k, v, do, lse, delta, **kw),),
                                      (ops.flash_dq_plain(q, k, v, do, lse, delta, **pkw),))
                ok6, e6, _ = bwd_errs(ops.flash_dkv_cuda(q, k, v, do, lse, delta, **kw),
                                      ops.flash_dkv_plain(q, k, v, do, lse, delta, **pkw))
                w = worst.setdefault(dtype, [0.0, 0.0])
                w[0], w[1] = max(w[0], e5), max(w[1], e6)
                if not (ok5 and ok6):
                    bad.append(f"{dtype} {(BH, sq, Sk, G, D)} {kw} dq={ok5} dkv={ok6}")
    print(f"[train] K5/K6 small shapes x masks x dtypes: max abs err [dq, dk/dv] {worst} "
          f"disagree={bad}", flush=True)
    return bad


def grads_of(params, cfg, rt, batch) -> tuple:
    """(loss, gradient leaves) of ``loss_fn`` through autograd."""
    import torch

    from repro_torch.models import loss_fn
    from repro_torch.models.params import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        loss = loss_fn(params, cfg, rt, batch)
        grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return float(loss.detach()), grads


def rel_l2(a, b) -> float:
    """||a - b|| / ||b|| in float32."""
    return float((a.float() - b.float()).norm() / b.float().norm())


def run_train(device) -> tuple:
    """The ``train`` phase; returns (K5's and K6's rows, launches by kernel in
    ``Trainer.run``, K4's entry at its first call)."""
    import dataclasses
    import math

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.models import Runtime, build_param_specs, param_bytes
    from repro_torch.models.params import tree_leaves
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import Trainer

    torch.cuda.empty_cache()
    full = get_arch(LM_ARCH)
    cfg = dataclasses.replace(full, n_layers=TRAIN_LAYERS)
    rt = Runtime(attn_impl="flash", remat="none")
    B, S = TRAIN_BATCH
    n_full, n_cut = (sum(math.prod(s.shape) for s in tree_leaves(build_param_specs(c, rt)))
                     for c in (full, cfg))
    print(f"[train] {cfg.name} cut from {full.n_layers} to {cfg.n_layers} layers: at "
          f"{full.n_layers} layers {n_full / 1e9:.2f} B params x (2 bf16 weight + 2 bf16 grad "
          f"+ 8 float32 AdamW moment) bytes = {n_full * 12 / 1e9:.1f} GB, over the card's 80 GB "
          f"before any activation; at {cfg.n_layers}, {n_cut / 1e9:.2f} B x 12 = "
          f"{n_cut * 12 / 1e9:.1f} GB. Widths as published: d_model {cfg.d_model}, heads "
          f"{cfg.n_heads}/{cfg.n_kv_heads}x{cfg.head_dim}, d_ff {cfg.d_ff}, vocab {cfg.vocab}; "
          f"memory in use before the phase {torch.cuda.memory_allocated()} bytes", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, rt, seq_len=S, global_batch=B, lr=TRAIN_LR, seed=0, device=device)
    torch.cuda.synchronize()
    print(f"[train] {param_bytes(build_param_specs(cfg, rt))} weight bytes ({rt.param_dtype}) and "
          f"{rt.opt_state_dtype} AdamW moments on {device} in {time.perf_counter() - t0:.1f}s; "
          f"batch {B} x {S} from SyntheticTokenPipeline(seed=0), lr {trainer.lr}", flush=True)

    step_s: list = []
    # K5's inputs at layer 0 of the first step (the backward runs the layers
    # in reverse)
    with keep_calls(flash_ops, "flash_dq_cuda", (cfg.n_layers - 1,)) as kept, \
            keep_calls(flash_ops, "flash_fwd_cuda", (0,)) as kept_fwd:
        counts.reset()
        t0 = time.perf_counter()
        losses = trainer.run(TRAIN_STEPS, log_every=1,
                             on_metrics=lambda step, m: step_s.append(m["s_per_step"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(counts.LAUNCHES)
        plain = dict(counts.PLAIN_CALLS)
        norm_routes = {k: v for k, v in counts.ROUTE_LAUNCHES.items()
                       if k.startswith("rmsnorm")}
    peak = torch.cuda.max_memory_allocated()
    steady = sum(step_s[1:]) / max(len(step_s) - 1, 1)
    print(f"[train] Trainer.run({TRAIN_STEPS}): losses {losses}; wall_s={wall:.6f}; step_s "
          f"{step_s} (the first includes warm-up); steady step_ms={steady * 1e3:.3f} "
          f"tokens_per_s={B * S / steady:.1f}; max_memory_allocated={peak}; launches "
          f"{ {k: launches[k] for k in TRAIN_KERNELS} } (K10 and K11 by route {norm_routes}) "
          f"plain_calls {plain}", flush=True)
    # K4-K6 once a layer a step; K10 and K11 twice a layer and at the final
    # norm
    for name in TRAIN_KERNELS:
        want = TRAIN_STEPS * (cfg.n_layers if name.startswith("flash") else 2 * cfg.n_layers + 1)
        if launches[name] != want or plain[name] != 0:
            fail(f"Trainer.run launched {name} {launches[name]} times (want {want}) and its "
                 f"plain version {plain[name]} times (want 0)")
    if norm_routes != {"rmsnorm_fwd/resident": launches["rmsnorm_fwd"],
                       "rmsnorm_bwd/cluster": launches["rmsnorm_bwd"]}:
        fail(f"K10 did not take its resident route or K11 its cluster route at d_model "
             f"{cfg.d_model}: {norm_routes}")
    ln_v = math.log(cfg.vocab)
    if not all(math.isfinite(x) for x in losses) or abs(losses[0] - ln_v) > LOSS_MARGIN:
        fail(f"losses {losses} are not finite or the first is not within {LOSS_MARGIN} of "
             f"ln({cfg.vocab}) = {ln_v}")

    # three steps on one repeated batch, continuing from the trainer's
    # state; the loss must fall, as in the reference's
    # test_train_step_reduces_loss
    batch = {k: torch.from_numpy(v).to(device)
             for k, v in trainer.pipeline.batch_at(TRAIN_STEPS).items()}
    step = make_train_step(cfg, rt, lr=trainer.lr)
    rep = []
    for _ in range(3):
        trainer.params, trainer.opt, m = step(trainer.params, trainer.opt, batch)
        rep.append(float(m["loss"]))
    print(f"[train] make_train_step x 3 on one repeated batch: losses {rep}", flush=True)
    if not rep[-1] < rep[0]:
        fail(f"the loss does not fall on a repeated batch: {rep}")

    # where a step's time goes
    device_profile(lambda: step(trainer.params, trainer.opt, batch),
                   f"train step {B}x{S}", 2, tag="train")

    # the flash route against the plain xla route, from the same weights and
    # batch; the yardstick is what another batch does to the gradients
    del trainer.opt
    torch.cuda.empty_cache()
    names = [".".join(p) for p in _leaf_paths(trainer.params)]
    other = {k: torch.from_numpy(v).to(device)
             for k, v in trainer.pipeline.batch_at(TRAIN_STEPS + 1).items()}
    loss_x, g_x = grads_of(trainer.params, cfg, dataclasses.replace(rt, attn_impl="xla"), batch)
    loss_f, g_f = grads_of(trainer.params, cfg, rt, batch)
    route = [rel_l2(a, b) for a, b in zip(g_f, g_x)]
    del g_x
    loss_o, g_o = grads_of(trainer.params, cfg, rt, other)
    moved = [rel_l2(a, b) for a, b in zip(g_o, g_f)]
    del g_o, g_f
    print(f"[train] loss_fn flash vs xla: losses {loss_f} / {loss_x} (diff "
          f"{abs(loss_f - loss_x)}, bound {ROUTE_LOSS_TOL}); another batch: loss {loss_o}", flush=True)
    for n, r, mv in zip(names, route, moved):
        print(f"[train]   grad {n}: |g_flash - g_xla| / |g_xla| = {r:.6g}; another batch "
              f"moves it by {mv:.6g}", flush=True)
    bad = [n for n, r, mv in zip(names, route, moved)
           if not (r <= ROUTE_GRAD_TOL and 4 * r <= mv)]
    if abs(loss_f - loss_x) > ROUTE_LOSS_TOL or bad:
        fail(f"flash and xla routes disagree: loss diff {abs(loss_f - loss_x)}, leaves {bad}")

    del trainer, batch, other
    torch.cuda.empty_cache()
    rows = hold_bwd(kept[cfg.n_layers - 1], launches)
    del kept
    k4_row = hold_k4_path("train", *kept_fwd[0], launches["flash_attn_fwd"])
    del kept_fwd
    bad = check_bwd_small()
    if not all(r["match"] for r in rows) or bad:
        fail(f"K5/K6 disagree with their plain versions: "
             f"{[(r['name'], r['match']) for r in rows]} small={bad}")
    torch.cuda.empty_cache()
    return rows, launches, k4_row


def _leaf_paths(tree, prefix=()):
    """Key paths of a parameter tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree) for p in _leaf_paths(tree[k], prefix + (k,))]
    return [prefix]


# ---------------------------------------------------------------------------
# MoE serving path (mixtral-8x22b at full width, depth cut to 8 layers)
# ---------------------------------------------------------------------------

MOE_ARCH = "mixtral-8x22b"
MOE_LAYERS = 8                # mixtral-8x22b's 56 layers cut to 8 (see run_moe)
MOE_PREFILL = (1, 8192)       # twice the 4096-token window, so the window masks
K9_SOURCE = ("src/repro_torch/csrc/moe_gmm.cu", "src/repro/kernels/moe_gmm/kernel.py:42")
# K9 against its plain version, (atol as a fraction of the plain output's
# largest magnitude, rtol): bfloat16 one bf16 rounding step (2**-7 relative:
# both sum in float32 from the same inputs, then round); float32 2e-5 of
# both (the summation order differs)
GMM_TOL = {"float32": (2e-5, 2e-5), "bfloat16": (2.0 ** -7, 0.0)}


def kept_experts(route):
    """(B, S) int64 bit masks of the experts that keep each token, from a
    ``moe_route`` result (gate_vals, expert_idx, slot, Cr)."""
    _, expert_idx, slot, Cr = route
    B, S, K = expert_idx.shape
    return ((slot.reshape(B, S, K) < Cr).long() << expert_idx).sum(-1)


@contextlib.contextmanager
def record_routing():
    """While active, the result of every call of ``models.moe.moe_route`` is
    appended to the yielded list, in call order (layer by layer, step by
    step), and the first call's input is kept under ``first["x"]``."""
    from repro_torch.models import moe

    original = moe.moe_route
    rec: list = []
    first: dict = {}

    def wrapped(router, x, cfg, rt):
        route = original(router, x, cfg, rt)
        rec.append(route)
        if "x" not in first:
            first["x"] = x.clone()
        return route

    moe.moe_route = wrapped
    try:
        yield rec, first
    finally:
        moe.moe_route = original


@contextlib.contextmanager
def replay_routing(pick):
    """While active, the n-th call of ``models.moe.moe_route`` computes its
    own routing but returns ``pick(n, own)``, a recorded one: two runs then
    take the same discrete decisions (experts, slots, drops) and the same
    gates, and differ by rounding alone. A token whose router scores sit
    near a tie takes another expert under any rounding difference, and a
    token kept or dropped at an expert's capacity moves with the tokens
    before it. The yielded list gets, per call, the number of tokens whose
    own kept experts differ from the replayed ones."""
    from repro_torch.models import moe

    original = moe.moe_route
    otherwise: list = []

    def wrapped(router, x, cfg, rt):
        own = original(router, x, cfg, rt)
        route = pick(len(otherwise), own)
        otherwise.append(int((kept_experts(own) != kept_experts(route)).sum()))
        return route

    moe.moe_route = wrapped
    try:
        yield otherwise
    finally:
        moe.moe_route = original


@contextlib.contextmanager
def plain_gmm():
    """While active, the MoE layer's expert products take K9's plain version
    (for the comparison route; never the counted run)."""
    from repro_torch.kernels.moe_gmm.ref import gmm_plain
    from repro_torch.models import moe

    original = moe.grouped_matmul
    moe.grouped_matmul = gmm_plain
    try:
        yield
    finally:
        moe.grouped_matmul = original


def gmm_errs(got, want) -> tuple:
    """(within GMM_TOL, max abs error, largest magnitude) of K9's output
    against the plain version's."""
    import torch

    frac, rtol = GMM_TOL[str(want.dtype)[6:]]
    g, w = got.float(), want.float()
    scale = float(w.abs().max())
    return (bool(torch.allclose(g, w, atol=frac * scale, rtol=rtol)),
            float((g - w).abs().max()), scale)


def gmm_bound(x, w):
    """(bound_ms, bound_by, flop) of one grouped matmul on these inputs:
    every row is a product (no group sizes), two flop a multiply-add."""
    E, C, D = x.shape
    flop = 2.0 * E * C * D * w.shape[-1]
    out_bytes = E * C * w.shape[-1] * x.element_size()
    return (*bound(nbytes(x, w) + out_bytes, flop, BF16_OPS_PER_S), flop)


def time_gmm_designs(x, w, reps: int) -> tuple:
    """(ms of the route ``ops.gmm_route`` picks, ms of PR 14's mma.sync
    design, the four turns) on these bf16 inputs, timed in turns: PR 14,
    this, this, PR 14, each the mean of ``reps`` calls; the means of each
    pair."""
    from repro_torch.kernels.moe_gmm import ops

    new = lambda: ops.gmm_cuda(x, w)                       # noqa: E731
    old = lambda: ops.gmm_cuda(x, w, route="mma_sync")     # noqa: E731
    old_ms, new_ms, turns = in_turns(old, new, reps)
    return new_ms, old_ms, turns


def hold_gmm(kept, launches: int, decode_launches: int, decode_x, decode_xd) -> dict:
    """K9 on the first layer's w_gate and w_down inputs from the prefill
    against its plain version, in bf16 and upcast to float32; timed beside
    PR 14's mma.sync design (in turns), the plain version, ``torch.bmm``
    (cuBLAS, bf16) and its bound; then the same at a decode step's w_gate
    and w_down shapes."""
    import torch

    from repro_torch.kernels.moe_gmm import ops

    match, err = True, 0.0
    for label, (x, w, gs) in (("w_gate", kept[0][0]), ("w_down", kept[2][0])):
        for kind, args in (("bf16", (x, w, gs)), ("upcast to float32", (x.float(), w.float(), gs))):
            route = ops.route_of(*args[:2])
            got, want = ops.gmm_cuda(*args), ops.gmm_plain(*args)
            torch.cuda.synchronize()
            ok, e, scale = gmm_errs(got, want)
            print(f"[moe] K9 vs plain at the first layer's {label} product {tuple(x.shape)} x "
                  f"{tuple(w.shape)}, {kind}, route {route}: max|plain| {scale} err {e} "
                  f"match={ok}", flush=True)
            match, err = match and ok, max(err, e)
            del got, want, args
    x, w, gs = kept[0][0]
    b_ms, b_by, flop = gmm_bound(x, w)
    ms, prior_ms, turns = time_gmm_designs(x, w, 5)
    row = dict(name="moe_gmm", source=K9_SOURCE[0], replaces=K9_SOURCE[1],
               shape=f"x={tuple(x.shape)} w={tuple(w.shape)} {str(x.dtype)[6:]} group_sizes=None",
               path_route=ops.route_of(x, w),
               match=match, max_abs_err=err, ms=ms, prior_ms=prior_ms,
               plain_ms=cuda_time_ms(lambda: ops.gmm_plain(x, w), 3),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=cuda_time_ms(lambda: torch.bmm(x, w), 10),
               library="torch.bmm (cuBLAS, bf16)")
    xd, wd, _ = kept[2][0]
    down_ms, down_prior_ms, _ = time_gmm_designs(xd, wd, 5)
    row.update(w_down_shape=f"x={tuple(xd.shape)} w={tuple(wd.shape)}", w_down_ms=down_ms,
               w_down_prior_ms=down_prior_ms,
               w_down_library_ms=cuda_time_ms(lambda: torch.bmm(xd, wd), 10))
    print(f"[moe] K9 at the first layer's w_gate product: {row['shape']} route "
          f"{row['path_route']} "
          f"match={match} max_abs_err={err} ms={ms:.6f} PR 14 design ms={prior_ms:.6f} (turns "
          f"PR 14, this, this, PR 14: {', '.join(f'{t:.6f}' for t in turns)}) plain_ms="
          f"{row['plain_ms']:.6f} bmm_ms={row['library_ms']:.6f} bound_ms={b_ms:.6f} ({b_by}) "
          f"flop={flop:.4g} launches={launches}; its w_down product {row['w_down_shape']}: "
          f"ms={down_ms:.6f} PR 14 design ms={down_prior_ms:.6f} bmm_ms="
          f"{row['w_down_library_ms']:.6f}", flush=True)
    d_ms, d_by, d_flop = gmm_bound(decode_x, w)
    dec_ms, dec_prior_ms, dturns = time_gmm_designs(decode_x, w, 20)
    dd_ms, dd_prior_ms, _ = time_gmm_designs(decode_xd, wd, 20)
    dd_bound, dd_by, _ = gmm_bound(decode_xd, wd)
    row.update(
        decode_shape=f"x={tuple(decode_x.shape)} w={tuple(w.shape)}",
        decode_route=ops.route_of(decode_x, w),
        decode_launches=decode_launches, decode_ms=dec_ms, decode_prior_ms=dec_prior_ms,
        decode_plain_ms=cuda_time_ms(lambda: ops.gmm_plain(decode_x, w), 5),
        decode_bound_ms=d_ms, decode_bound_by=d_by,
        decode_library_ms=cuda_time_ms(lambda: torch.bmm(decode_x, w), 20),
        decode_w_down_shape=f"x={tuple(decode_xd.shape)} w={tuple(wd.shape)}",
        decode_w_down_ms=dd_ms, decode_w_down_prior_ms=dd_prior_ms,
        decode_w_down_bound_ms=dd_bound,
        decode_w_down_library_ms=cuda_time_ms(lambda: torch.bmm(decode_xd, wd), 20))
    print(f"[moe] K9 at a decode step's shape {row['decode_shape']} route {row['decode_route']}: "
          f"ms={dec_ms:.6f} PR 14 design ms={dec_prior_ms:.6f} (turns: "
          f"{', '.join(f'{t:.6f}' for t in dturns)}) plain_ms={row['decode_plain_ms']:.6f} "
          f"bmm_ms={row['decode_library_ms']:.6f} bound_ms={d_ms:.6f} ({d_by}); its w_down "
          f"product {row['decode_w_down_shape']}: ms={dd_ms:.6f} PR 14 design ms="
          f"{dd_prior_ms:.6f} bmm_ms={row['decode_w_down_library_ms']:.6f} bound_ms="
          f"{dd_bound:.6f} ({dd_by}); launches per step={decode_launches}", flush=True)
    return row


# (E, C, D, F) of check_gmm_small: each bf16 route of ops.gmm_route, small
# and at mixtral-8x22b's decode shapes (w_gate and w_down); the prefill
# shape is held in hold_gmm on the path's own inputs
GMM_SMALL = [
    ((2, 32, 48, 24), "wgmma_decode"),     # N = 32
    ((2, 10, 64, 136), "wgmma_decode"),    # N = 16, C off it
    ((2, 40, 64, 72), "wgmma_decode"),     # N = 64
    ((3, 130, 96, 200), "wgmma"),          # C, D and F off the 128 x 256 x 64 tiles
    ((2, 300, 520, 264), "wgmma"),
    ((2, 77, 50, 30), "mma_sync"),         # D, F not multiples of 8: no TMA map
    ((3, 140, 60, 72), "mma_sync"),
    ((8, 16, 6144, 16384), "wgmma_decode"),
    ((8, 16, 16384, 6144), "wgmma_decode"),
]


def check_gmm_small() -> list:
    """K9 against its plain version at small and ragged shapes and at the
    decode shapes, both dtypes, with and without group sizes (0, a partial
    tile, past C, and NaN past every group size), each case on the route
    ``ops.gmm_route`` picks (asserted from the route counts) and, in bf16,
    on PR 14's mma.sync design too; returns the cases that disagree."""
    import torch

    from repro_torch.kernels import counts
    from repro_torch.kernels.moe_gmm import ops

    bad, worst = [], {}
    g = torch.Generator(device="cpu").manual_seed(2)
    for dtype in ("float32", "bfloat16"):
        td = getattr(torch, dtype)
        for (E, C, D, F), bf16_route in GMM_SMALL:
            route = bf16_route if dtype == "bfloat16" else "cuda_core_f32"
            x = torch.randn((E, C, D), generator=g).to("cuda", td)
            w = (torch.randn((E, D, F), generator=g) / D ** 0.5).to("cuda", td)
            for gs in (None, [C] + [C // 2] * (E - 1), [0] + [C + 5] + [min(C, 129)] * (E - 2)):
                xg = x.clone()
                if gs is not None:
                    for e, n in enumerate(gs):
                        xg[e, n:] = float("nan")   # rows past the group size are never used
                    gs = torch.tensor(gs, dtype=torch.int32, device="cuda")
                for forced in (None, "mma_sync") if dtype == "bfloat16" else (None,):
                    counts.reset()
                    got = ops.gmm_cuda(xg, w, gs, route=forced)
                    took = dict(counts.ROUTE_LAUNCHES)
                    ok, e, _ = gmm_errs(got, ops.gmm_plain(x, w, gs))
                    ok = ok and took == {f"moe_gmm/{forced or route}": 1}
                    worst[dtype] = max(worst.get(dtype, 0.0), e)
                    if not ok:
                        bad.append(f"{dtype} {(E, C, D, F)} group_sizes="
                                   f"{None if gs is None else gs.tolist()} routes {took} err {e}")
    torch.cuda.synchronize()
    print(f"[moe] K9 small shapes x dtypes x group sizes x routes: max abs err {worst} "
          f"disagree={bad}", flush=True)
    return bad


def run_moe(device) -> tuple:
    """The ``moe`` phase; returns (K9's row, with its launches per decode
    step, K9's, K4's and K10's launches in the prefill, K7's in one decode
    step, K4's entry at its first call)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.moe_gmm import ops as gmm_ops
    from repro_torch.models import (Runtime, build_param_specs, decode_step, forward,
                                    init_cache, init_params, param_bytes)
    from repro_torch.models import moe
    from repro_torch.serving import Request, ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    full = get_arch(MOE_ARCH)
    cfg = dataclasses.replace(full, n_layers=MOE_LAYERS)
    rt = Runtime(attn_impl="flash")
    b_full, b_cut = (param_bytes(build_param_specs(c, rt)) for c in (full, cfg))
    per_layer = (b_full - b_cut) / (full.n_layers - cfg.n_layers)
    fits = int((80e9 - (b_cut - cfg.n_layers * per_layer)) // per_layer)
    print(f"[moe] {cfg.name} cut from {full.n_layers} to {cfg.n_layers} layers: its bf16 weights "
          f"take {b_full / 1e9:.1f} GB at {full.n_layers} layers ({per_layer / 1e9:.2f} GB a "
          f"layer), and at most {fits} layers fit the card's 80 GB at all, fewer beside a "
          f"prefill's activations; at {cfg.n_layers}, {b_cut / 1e9:.1f} GB. Widths as "
          f"published: d_model {cfg.d_model}, heads {cfg.n_heads}/{cfg.n_kv_heads}x"
          f"{cfg.head_dim}, {cfg.moe.n_experts} experts top-{cfg.moe.top_k} of width "
          f"{cfg.moe.d_ff_expert}, vocab {cfg.vocab}, window {cfg.window}; memory in use before "
          f"the phase {torch.cuda.memory_allocated()} bytes", flush=True)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(build_param_specs(cfg, rt), torch.Generator(device=device).manual_seed(0),
                         device)
    torch.cuda.synchronize()
    print(f"[moe] {b_cut} weight bytes drawn on {device} in {time.perf_counter() - t0:.1f}s",
          flush=True)
    L = cfg.n_layers
    rng = np.random.default_rng(0)
    B, S = MOE_PREFILL
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab, (B, S))).to(device)
    with torch.no_grad():
        forward(params, cfg, rt, tokens=tokens[:, :512])   # warm-up: cuBLAS, K4, K9 load
        torch.cuda.synchronize()
        with record_routing() as (routes, first), \
                keep_calls(gmm_ops, "gmm_cuda", (0, 2)) as kept, \
                keep_calls(flash_ops, "flash_fwd_cuda", (0,)) as kept_k4:
            counts.reset()
            t0 = time.perf_counter()
            logits = forward(params, cfg, rt, tokens=tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k9, k4 = counts.LAUNCHES["moe_gmm"], counts.LAUNCHES["flash_attn_fwd"]
            k10 = counts.LAUNCHES["rmsnorm_fwd"]
            k10_resident = counts.ROUTE_LAUNCHES.get("rmsnorm_fwd/resident", 0)
            plain = {k: v for k, v in counts.PLAIN_CALLS.items() if v}
            k9_routes = {k: v for k, v in counts.ROUTE_LAUNCHES.items() if k.startswith("moe_gmm")}
        dropped = [int((r[2] == r[3]).sum()) for r in routes]
        print(f"[moe] prefill {B}x{S} attn_impl=flash: wall_s={wall:.6f} tokens_per_s="
              f"{B * S / wall:.1f} max_memory_allocated={torch.cuda.max_memory_allocated()} "
              f"K9 launches={k9} ({k9_routes}) K4 launches={k4} K10 launches={k10} "
              f"(resident route {k10_resident}) plain_calls={plain}; of "
              f"{S * cfg.moe.top_k} "
              f"assignments a layer, capacity {routes[0][3]} per expert drops, by layer: "
              f"{dropped}", flush=True)
        if k9 != 3 * L or k4 != L or k10 != 2 * L + 1 or plain or k9_routes != {
                "moe_gmm/wgmma": 3 * L} or k10_resident != k10:
            fail(f"prefill launched K9 {k9} times (want {3 * L}, all on the wgmma route: "
                 f"{k9_routes}), K4 {k4} times (want {L}) and K10 {k10} times (want "
                 f"{2 * L + 1}, all on the resident route: {k10_resident}), plain calls "
                 f"{plain} (want none)")
        if tuple(logits.shape) != (B, S, cfg.vocab) or not bool(torch.isfinite(logits).all()):
            fail(f"prefill logits of shape {tuple(logits.shape)} are not finite")
        sample = list(range(0, S, 512)) + [S - 1]
        k9_rows = logits[0, sample].float()
        del logits

        # layer 0's MoE on the prefill's own input, the expert products
        # through K9's plain version: the routing must be identical
        x0 = first["x"]
        p0 = {k: v[0] for k, v in params["blocks"]["moe"].items()}
        with record_routing() as (again, _):
            out_k9 = moe.moe_apply(p0, x0, cfg, rt)
            with plain_gmm():
                out_plain = moe.moe_apply(p0, x0, cfg, rt)
        same0 = all(torch.equal(a, b) for r in again for a, b in zip(r[1:3], routes[0][1:3]))
        rel0 = float((out_k9.float() - out_plain.float()).abs().max()
                     / out_plain.float().abs().max())
        print(f"[moe] layer 0's MoE on its prefill input, K9 vs plain products: expert_idx and "
              f"slots identical={same0}; max|out diff|/max|out| {rel0} (bound {LOGIT_TOL})",
              flush=True)
        if not (same0 and rel0 <= LOGIT_TOL):
            fail(f"layer 0 with K9 and with its plain version: routing identical={same0}, "
                 f"output diff {rel0}")
        del x0, out_k9, out_plain, first, again

        # the plain route (K9's and K4's plain versions), taking the K9
        # route's routing decisions
        with plain_gmm(), replay_routing(lambda n, own: routes[n]) as otherwise:
            t0 = time.perf_counter()
            plain_logits = forward(params, cfg, dataclasses.replace(rt, attn_impl="xla"),
                                   tokens=tokens)
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - t0
        rel, err, pmax = logit_errs(k9_rows, plain_logits[0, sample])
        del plain_logits, routes
        print(f"[moe] prefill through the plain route (plain K9, attn_impl=xla, the K9 route's "
              f"routing replayed): wall_s={plain_wall:.6f}; K9 route vs plain route at positions "
              f"{sample}: max|logit diff|/max|logit| {rel} (bound {LOGIT_TOL}), softmax max diff "
              f"{err} beside a largest probability of {pmax}; of {S} tokens the plain route's own "
              f"router would keep other experts for, by layer: {otherwise}", flush=True)
        if not rel <= LOGIT_TOL:
            fail(f"the K9 route and the plain route disagree: logit diff {rel}")

        # serving: greedy requests through the engine, then K9's launches in
        # one decode step of the engine's batch
        engine = ServingEngine(params, cfg, rt, batch_size=SERVE_REQS, max_len=SERVE_MAX_LEN)
        reqs = [Request(prompt=rng.integers(2, cfg.vocab, SERVE_PROMPT).astype(np.int32),
                        max_new_tokens=SERVE_NEW) for _ in range(SERVE_REQS)]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        steps = SERVE_PROMPT + SERVE_NEW - 1
        n_new = sum(len(r.generated) for r in reqs)
        print(f"[moe] ServingEngine batch {SERVE_REQS} max_len {SERVE_MAX_LEN}: {SERVE_REQS} "
              f"greedy requests x {SERVE_PROMPT} prompt tokens, {n_new} new tokens in wall_s="
              f"{swall:.6f} ({steps} decode steps of {SERVE_REQS} slots: step_ms="
              f"{swall / steps * 1e3:.3f}, new tokens_per_s={n_new / swall:.1f}); first "
              f"request: {reqs[0].generated[:8]}...", flush=True)
        if any(len(r.generated) != SERVE_NEW or not all(0 <= t < cfg.vocab for t in r.generated)
               for r in reqs):
            fail(f"not every request got {SERVE_NEW} tokens in range")
        cache = init_cache(cfg, rt, SERVE_REQS, SERVE_MAX_LEN, device=device)
        step_toks = torch.full((SERVE_REQS, 1), 7, device=device)
        for _ in range(SERVE_PROMPT):
            _, cache = decode_step(params, cfg, rt, cache, step_toks)
        with keep_calls(gmm_ops, "gmm_cuda", (0, 2)) as kept_dec:
            counts.reset()
            decode_step(params, cfg, rt, cache, step_toks)
            torch.cuda.synchronize()
            dec_k9, dec_k7 = counts.LAUNCHES["moe_gmm"], counts.LAUNCHES["flash_decode"]
            dec_routes = dict(counts.ROUTE_LAUNCHES)
        dec_plain = sum(counts.PLAIN_CALLS.values())
        print(f"[moe] one decode step of {SERVE_REQS} slots: K9 launches={dec_k9} (want {3 * L}, "
              f"routes {dec_routes}) K7 launches={dec_k7} (want {L}) plain_calls={dec_plain}",
              flush=True)
        if dec_k9 != 3 * L or dec_k7 != L or dec_plain or dec_routes.get(
                "moe_gmm/wgmma_decode") != 3 * L or dec_routes.get("flash_decode/ring") != L:
            fail(f"a decode step launched K9 {dec_k9} times (want {3 * L}, all on the "
                 f"wgmma_decode route: {dec_routes}) and K7 {dec_k7} times (want {L}, all on "
                 f"the ring route), plain versions {dec_plain} times")
        decode_x, decode_xd = kept_dec[0][0][0], kept_dec[2][0][0]
        del kept_dec   # its weight copies: hold_gmm takes the prefill's

        # decode against forward on a 64-token prompt, each decode step
        # taking the forward's routing of its token: its experts, its gates,
        # and a drop where the forward's capacity dropped the assignment
        prompt = torch.from_numpy(reqs[0].prompt[None].astype(np.int64)).to(device)
        with record_routing() as (par_routes, _):
            par = forward(params, cfg, rt, tokens=prompt)[0].float()

        def token_route(n, own):
            g, idx, slot, Cr = par_routes[n % L]
            t, K = n // L, idx.shape[-1]
            kept = slot.reshape(1, -1, K)[:, t] < Cr
            return (g[:, t:t + 1], idx[:, t:t + 1], torch.where(kept, 0, own[3]), own[3])

        n_dropped = sum(int((r[2] == r[3]).sum()) for r in par_routes)
        tf_cache = init_cache(cfg, rt, 1, SERVE_PROMPT, device=device)
        dec = []
        with replay_routing(token_route) as otherwise:
            for t in range(SERVE_PROMPT):
                lg, tf_cache = decode_step(params, cfg, rt, tf_cache, prompt[:, t:t + 1])
                dec.append(lg[0, 0].float())
        rel, derr, pmax = logit_errs(torch.stack(dec), par)
        moved = prompt.clone()
        moved[0, 0] = 1
        sens = logit_errs(forward(params, cfg, rt, tokens=moved)[0, -1], par[-1])[0]
        print(f"[moe] decode_step teacher-forced over {SERVE_PROMPT} tokens vs forward (the "
              f"forward's routing replayed; it drops {n_dropped} of "
              f"{SERVE_PROMPT * cfg.moe.top_k * L} assignments at capacity factor "
              f"{cfg.moe.capacity_factor}; decode's own router would keep other experts for "
              f"{sum(otherwise)} token-layers): max|logit diff|/max|logit| {rel} (bound "
              f"{LOGIT_TOL}), softmax max diff {derr} beside a largest probability of {pmax}; "
              f"another first token moves the last position's logits by {sens}", flush=True)
        if not rel <= LOGIT_TOL:
            fail(f"decode and forward disagree: logit diff {rel}")
        if not sens > 4 * LOGIT_TOL:
            fail(f"the logit bound {LOGIT_TOL} is not 4x under the move {sens} that another "
                 f"context token makes")
        del par, dec, par_routes, tf_cache

        device_profile(lambda: forward(params, cfg, rt, tokens=tokens), f"prefill {B}x{S}", 2,
                       tag="moe")
        device_profile(lambda: decode_step(params, cfg, rt, cache, step_toks),
                       f"decode step of {SERVE_REQS} slots at position {SERVE_PROMPT + 1}", 10,
                       tag="moe")

    row = hold_gmm(kept, k9, dec_k9, decode_x, decode_xd)
    del params, engine, cache, kept, decode_x, decode_xd
    gc.collect()
    torch.cuda.empty_cache()
    bad = check_gmm_small()
    if not row["match"] or bad:
        fail(f"K9 disagrees with its plain version: first layer match={row['match']} small={bad}")
    k4_row = hold_k4_path("moe", *kept_k4[0], k4)
    del kept_k4
    torch.cuda.empty_cache()
    return row, k9, k4, k10, dec_k7, k4_row

# ---------------------------------------------------------------------------
# SSM serving path (rwkv6-7b at full width and depth)
# ---------------------------------------------------------------------------

SSM_ARCH = "rwkv6-7b"
SSM_PREFILL = (2, 4096)
K10_SOURCE = ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:29")
K11_SOURCE = ("src/repro_torch/csrc/rmsnorm.cu", "src/repro/kernels/rmsnorm/kernel.py:69")
K12_SOURCE = ("src/repro_torch/csrc/rwkv6_wkv.cu", "src/repro/kernels/rwkv6_wkv/kernel.py:59")
BF16_STEP = 2.0 ** -7
# K12 with the model's bf16 intra-chunk operands, and K8 in the model's
# function on bf16 activations, jump by one bf16 step where the kernel's and
# the plain version's float32 intermediates (a sequential cumsum and expf
# against torch's scan and exp) straddle a rounding boundary: there this
# share of y must sit within the plain bound, and all of it within one more
# bf16 step
FLIP_SHARE = 0.95
# Each of the 32 layers' time-mix and channel-mix outputs, the plain route
# against the kernel route on the same input: within two bf16 steps of the
# output's largest magnitude (each route rounds its output, and the inputs
# of its last projection differ by a rounding) and within half a step in
# relative L2 (on an H100: at most 9.4e-3 and 1.3e-3)
SUBBLOCK_TOL, SUBBLOCK_L2 = 2.0 ** -6, 2.0 ** -8
# rwkv6-7b with random weights carries rounding through 32 layers: in bf16
# activations the two routes' logits differ by 0.115 of their largest
# magnitude on an H100 while every layer agrees within one bf16 step. The
# end-to-end comparisons therefore run in float32 activations (the bf16
# weights upcast), where the routes read 0.0227, and are held to
# LOGIT_TOL; each layer in bf16 is held by SUBBLOCK_TOL and SUBBLOCK_L2.
# The float32 prefill is one sequence of this many tokens
SSM_F32_TOKENS = 2048


# the CUDA wrappers each phase's comparison route swaps for their plain
# versions, as (package under repro_torch.kernels, wrapper stem)
SSM_PLAIN = (("rmsnorm", "rmsnorm_fwd"), ("rwkv6_wkv", "wkv"))
HYB_PLAIN = (("rmsnorm", "rmsnorm_fwd"), ("mamba2_ssd", "ssd"))


@contextlib.contextmanager
def plain_route(*kernels):
    """While active, the CUDA wrapper ``<stem>_cuda`` of each (package, stem)
    in ``kernels`` is replaced by its plain version ``<stem>_plain`` in
    ``repro_torch.kernels.<package>.ops`` (for the comparison route; never
    the counted run)."""
    import importlib

    mods = [(importlib.import_module(f"repro_torch.kernels.{pkg}.ops"), stem)
            for pkg, stem in kernels]
    saved = [getattr(m, f"{stem}_cuda") for m, stem in mods]
    for m, stem in mods:
        setattr(m, f"{stem}_cuda", getattr(m, f"{stem}_plain"))
    try:
        yield
    finally:
        for (m, stem), fn in zip(mods, saved):
            setattr(m, f"{stem}_cuda", fn)


def scan_errs(y, st, py, pst, flips: bool) -> tuple:
    """(within bounds, max abs y error, share of y within the plain bound,
    state error over the state's largest magnitude) of a chunked scan's (K12's
    or K8's) outputs against its plain version's. The state within 2e-5 of
    its largest magnitude; y within one bf16 step (bfloat16 y) or 2e-5
    (float32 y) of its largest magnitude, everywhere, or, where ``flips``
    (a function that rounds to bf16 inside), at FLIP_SHARE of the elements
    and one bf16 step more at all."""
    import torch

    s_err = float((st - pst).abs().max() / pst.abs().max())
    scale = float(py.float().abs().max())
    diff = (y.float() - py.float()).abs()
    tol = BF16_STEP if py.dtype == torch.bfloat16 else 2e-5
    share = float((diff <= tol * scale).float().mean())
    top = float(diff.max()) / scale
    ok_y = top <= (tol + BF16_STEP if flips else tol) and (share >= FLIP_SHARE or not flips)
    return ok_y and s_err <= 2e-5, float(diff.max()), share, s_err


def scan_ops(n: int, f32: int, intra: int, bf16_intra: bool) -> tuple:
    """(float32 operations, bf16-operand operations) of ``n`` (b, h, chunk)
    steps of a chunked scan, each of ``f32`` float32 operations and ``intra``
    intra-chunk ones, on bf16 operands with float32 sums where
    ``bf16_intra``."""
    return float(n * (f32 + (0 if bf16_intra else intra))), float(n * intra if bf16_intra else 0)


@contextlib.contextmanager
def wkv_float32_products():
    """While active, the model's K12 launches take the Pallas kernel's
    function (every product float32, the function the decode recurrence
    computes) instead of the bf16 intra-chunk operands: still the kernel,
    never the counted run."""
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops

    saved = wkv_ops._wkv
    wkv_ops._wkv = lambda r, k, v, w, u, chunk, bf16_intra: saved(r, k, v, w, u, chunk, False)
    try:
        yield
    finally:
        wkv_ops._wkv = saved


def check_layers(params, cfg, rt, tokens, kernel_rows, rows) -> list:
    """The prefill layer by layer through the kernel route, each layer's
    time mix and channel mix recomputed through the plain route on the same
    input; returns the layers whose outputs disagree (SUBBLOCK_TOL,
    SUBBLOCK_L2). The loop is the ssm branch of ``models.forward``: its
    logits must equal ``kernel_rows`` (the counted forward's, at ``rows``)."""
    from repro_torch.models.blocks import rmsnorm
    from repro_torch.models.model import _layer, _logits, _rwkv_cmix
    from repro_torch.models.rwkv6 import rwkv6_apply

    def errs(a, b):
        return logit_errs(a, b)[0], rel_l2(a, b)

    eps = cfg.norm_eps
    x = params["embed"][tokens.long()].to(rt.cdtype)
    bad, worst = [], [0.0, 0.0, 0.0, 0.0]
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        t_k = rwkv6_apply(p["tmix"], rmsnorm(x, p["ln1"], eps), cfg, rt)
        with plain_route(*SSM_PLAIN):
            t_p = rwkv6_apply(p["tmix"], rmsnorm(x, p["ln1"], eps), cfg, rt)
        x = x + t_k
        c_k = _rwkv_cmix(p["cmix"], rmsnorm(x, p["ln2"], eps))
        with plain_route(*SSM_PLAIN):
            c_p = _rwkv_cmix(p["cmix"], rmsnorm(x, p["ln2"], eps))
        x = x + c_k
        e = errs(t_k, t_p) + errs(c_k, c_p)
        worst = [max(w, v) for w, v in zip(worst, e)]
        if not (e[0] <= SUBBLOCK_TOL and e[2] <= SUBBLOCK_TOL and e[1] <= SUBBLOCK_L2
                and e[3] <= SUBBLOCK_L2):
            bad.append(f"layer {i}: {e}")
    same = logit_errs(_logits(params, cfg, x)[:, rows].float(), kernel_rows)[0]
    print(f"[ssm] layer by layer, plain route on the kernel route's inputs: worst time mix "
          f"max|diff|/max {worst[0]} (bound {SUBBLOCK_TOL}) L2 {worst[1]} (bound {SUBBLOCK_L2}); "
          f"worst channel mix {worst[2]} / {worst[3]}; disagree={bad}; the loop's logits vs the "
          f"counted forward's: {same}", flush=True)
    if same != 0.0:
        bad.append(f"the layer loop's logits differ from forward's by {same}")
    return bad


def check_decode_layers(params, cfg, rt, tokens) -> list:
    """``tokens`` (1, S) layer by layer through the forward, each layer's
    time mix and channel mix recomputed token by token through the decode
    forms (the float32 recurrence and the carried shifts) on the same
    input and held against the forward's with K12 in the function the
    recurrence computes (float32 products) within SUBBLOCK_TOL and
    SUBBLOCK_L2; the model's time mix (bf16 intra-chunk operands, which
    the recurrence does not round) is printed beside it. Returns the layers
    that disagree."""
    import torch

    from repro_torch.models.blocks import rmsnorm
    from repro_torch.models.model import _layer, _rwkv_cmix
    from repro_torch.models.rwkv6 import rwkv6_apply, rwkv6_decode_apply, rwkv6_init_state

    def errs(a, b):
        return logit_errs(a, b)[0], rel_l2(a, b)

    eps = cfg.norm_eps
    x = params["embed"][tokens.long()].to(rt.cdtype)
    S = x.shape[1]
    bad, worst, model = [], [0.0] * 4, [0.0] * 2
    for i in range(cfg.n_layers):
        p = _layer(params["blocks"], i)
        h = rmsnorm(x, p["ln1"], eps)
        t_m = rwkv6_apply(p["tmix"], h, cfg, rt)
        with wkv_float32_products():
            t_f = rwkv6_apply(p["tmix"], h, cfg, rt)
        state = rwkv6_init_state(cfg, 1, x.dtype, device=x.device)
        t_d = []
        for t in range(S):
            o, state = rwkv6_decode_apply(p["tmix"], h[:, t:t + 1], state, cfg, rt)
            t_d.append(o)
        t_d = torch.cat(t_d, 1)
        x = x + t_m
        h = rmsnorm(x, p["ln2"], eps)
        c_f = _rwkv_cmix(p["cmix"], h)
        c_d = torch.cat([_rwkv_cmix(p["cmix"], h[:, t:t + 1],
                                    prev=h[:, t - 1:t] if t else torch.zeros_like(h[:, :1]))
                         for t in range(S)], 1)
        x = x + c_f
        e = errs(t_d, t_f) + errs(c_d, c_f)
        worst = [max(w, v) for w, v in zip(worst, e)]
        model = [max(w, v) for w, v in zip(model, errs(t_d, t_m))]
        if not (e[0] <= SUBBLOCK_TOL and e[2] <= SUBBLOCK_TOL and e[1] <= SUBBLOCK_L2
                and e[3] <= SUBBLOCK_L2):
            bad.append(f"layer {i}: {e}")
    print(f"[ssm] layer by layer, decode forms vs forward on the forward's inputs ({S} tokens, "
          f"{str(x.dtype)[6:]}): worst time mix (float32 K12 products) max|diff|/max {worst[0]} "
          f"(bound {SUBBLOCK_TOL}) L2 {worst[1]} (bound {SUBBLOCK_L2}); worst channel mix "
          f"{worst[2]} / {worst[3]}; disagree={bad}; the model's time mix (bf16 intra-chunk "
          f"operands, not gated) {model[0]} / {model[1]}", flush=True)
    return bad


def wkv_op_counts(B: int, S: int, H: int, K: int, c: int, bf16_intra: bool) -> tuple:
    """(float32 operations, bf16-operand operations) of one WKV scan: per
    (b, h) and chunk the state's part and the state update (c K^2
    multiply-adds each), att and the intra-chunk product (K c(c-1)/2 each,
    the strict lower triangle; bf16 operands with float32 sums in the
    model's function), about 16 operations an element for the cumsum, the
    four factors with their exps and the bonus, and the state's decay
    (2 K^2)."""
    intra = 4 * (c * (c - 1) // 2) * K
    return scan_ops(B * H * (S // c), 4 * c * K * K + 16 * c * K + 2 * K * K, intra, bf16_intra)


def hold_wkv(args, launches: int) -> dict:
    """K12 on the first layer's inputs from the prefill against its plain
    version, in the model's function (bf16 intra-chunk operands) and the
    Pallas kernel's (float32 products), by the route the prefill took
    (``chunked``), its final state against the ``serial`` route's (the first
    design) bit for bit; then timed in turns with the first design, each of
    its three launches' kernel time from a profiler trace, beside the plain
    version and the bound."""
    import torch

    from repro_torch.kernels.rwkv6_wkv import ops

    r, k, v, w, u, chunk, _ = args
    B, S, H, K = r.shape
    route = ops.wkv_route(S, chunk, K)
    checks = {}
    for bf16_intra in (True, False):
        a = (r, k, v, w, u, chunk, bf16_intra)
        y, st = ops.wkv_cuda(*a, route=route)
        _, st_serial = ops.wkv_cuda(*a, route="serial")
        py, pst = ops.wkv_plain(*a)
        torch.cuda.synchronize()
        same = bool(torch.equal(st, st_serial))
        ok, err, share, s_err = scan_errs(y, st, py, pst, bf16_intra)
        checks[bf16_intra] = (ok and same, err, share, s_err)
        print(f"[ssm] K12 ({route} route) vs plain at the first layer's inputs, "
              f"{'bf16' if bf16_intra else 'float32'} intra-chunk products: max|y| "
              f"{float(py.float().abs().max())} max err {err}, {share} of y within one bf16 step "
              f"of the largest; state err / max|state| {s_err}; final state equal to the serial "
              f"route's bit for bit: {same} (max diff {float((st - st_serial).abs().max())}) "
              f"match={ok and same}", flush=True)
        del y, st, st_serial, py, pst
    model = (r, k, v, w, u, chunk, True)
    n_bytes = nbytes(r, k, v, w, u, r) + B * H * K * K * 4
    f32_ops, bf16_ops = wkv_op_counts(B, S, H, K, chunk, True)
    b_ms, b_by = bound(n_bytes, f32_ops, bf16_ops=bf16_ops)
    f32_b_ms, f32_b_by = bound(n_bytes, sum(wkv_op_counts(B, S, H, K, chunk, False)))
    first_ms, ms, _ = in_turns(lambda: ops.wkv_cuda(*model, route="serial"),
                               lambda: ops.wkv_cuda(*model, route=route), 10)
    f32 = model[:-1] + (False,)
    f32_first_ms, f32_ms, _ = in_turns(lambda: ops.wkv_cuda(*f32, route="serial"),
                                       lambda: ops.wkv_cuda(*f32, route=route), 10)
    steps = traced_ms(lambda: ops.wkv_cuda(*model, route=route),
                      ("wkv_states", "state_pass", "wkv_out")) if route == "chunked" else None
    row = dict(name="rwkv6_wkv", source=K12_SOURCE[0], replaces=K12_SOURCE[1],
               shape=f"r/k/v={tuple(r.shape)} {str(r.dtype)[6:]} w {str(w.dtype)[6:]} "
                     f"chunk={chunk} bf16 intra-chunk operands",
               path_route=route, match=all(c[0] for c in checks.values()),
               max_abs_err=checks[True][1], ms=ms, first_design_ms=first_ms, step_ms=steps,
               plain_ms=cuda_time_ms(lambda: ops.wkv_plain(*model), 3),
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               library="none: no PyTorch call computes the chunked WKV",
               float32_products_ms=f32_ms, float32_products_first_design_ms=f32_first_ms,
               float32_products_bound_ms=f32_b_ms, float32_products_bound_by=f32_b_by)
    print(f"[ssm] K12 at the first layer's inputs: {row['shape']} route={route} "
          f"match={row['match']} max_abs_err={row['max_abs_err']} ms={ms:.6f} "
          f"first_design_ms={first_ms:.6f} (in turns: first, new, new, first) steps_ms "
          f"(increments, state pass, outputs; kernel time from a profiler trace)={steps} "
          f"plain_ms={row['plain_ms']:.6f} "
          f"bound_ms={b_ms:.6f} ({b_by}: {n_bytes} bytes, {f32_ops:.6g} float32 and "
          f"{bf16_ops:.6g} bf16-operand operations); float32 products ms={f32_ms:.6f} "
          f"first design {f32_first_ms:.6f} bound_ms={f32_b_ms:.6f} ({f32_b_by}); "
          f"launches={launches}", flush=True)
    return row


def hold_rmsnorm(x, w, eps: float, launches: int, train_launches: int) -> tuple:
    """K10 and K11 on the prefill's first ln1 input (and a cotangent drawn
    from seed 3) against their plain versions, timed beside them,
    ``torch.nn.functional.rms_norm`` and its autograd backward (timed, never
    used) and their bounds; K11 also in turns with PR 15's one-block-a-tile
    design (the ``tile`` route) and, like for like with the library's dx
    and whole dw, with the sum of its dw partials. bf16 outputs within one
    bf16 step of their largest magnitude, rstd within 2e-6 relative, the
    float32 dw partials within 1e-5 of their largest magnitude; the tile
    route held the same."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops

    N, D = x.shape
    do = torch.randn(x.shape, generator=torch.Generator(device=x.device).manual_seed(3),
                     device=x.device).to(x.dtype)
    out, rstd = ops.rmsnorm_fwd_cuda(x, w, eps)
    tout, trstd = ops.rmsnorm_fwd_cuda(x, w, eps, route="two_pass")
    pout, prstd = ops.rmsnorm_fwd_plain(x, w, eps)
    dx, parts = ops.rmsnorm_bwd_cuda(x, w, rstd, do)
    tdx, tparts = ops.rmsnorm_bwd_cuda(x, w, rstd, do, route="tile")
    pdx, pparts = ops.rmsnorm_bwd_plain(x, w, rstd, do)
    torch.cuda.synchronize()

    def close(a, b, frac):
        scale = float(b.float().abs().max())
        return bool(torch.allclose(a.float(), b.float(), atol=frac * scale, rtol=0)), \
            float((a.float() - b.float()).abs().max())

    ok10, e10 = close(out, pout, BF16_STEP)
    r_err = float(((rstd - prstd).abs() / prstd).max())
    ok10 = (ok10 and r_err <= 2e-6 and close(tout, pout, BF16_STEP)[0]
            and float(((trstd - prstd).abs() / prstd).max()) <= 2e-6)
    del tout, trstd
    ok11, e11 = close(dx, pdx, BF16_STEP)
    okp, ep = close(parts, pparts, 1e-5)
    ok11 = ok11 and okp and close(tdx, pdx, BF16_STEP)[0] and close(tparts, pparts, 1e-5)[0]
    del tdx, tparts
    print(f"[ssm] K10 vs plain at the prefill's ln1 input {tuple(x.shape)} {str(x.dtype)[6:]}: "
          f"out err {e10} rstd rel err {r_err} match={ok10}; K11: dx err {e11}, dw partials "
          f"err {ep} match={ok11}", flush=True)
    xg, wg = x.detach().clone().requires_grad_(True), w.detach().clone().requires_grad_(True)
    lib_out = F.rms_norm(xg, (D,), wg, eps)
    f_ms, f_by = bound(nbytes(x, w, out, rstd), 4.0 * N * D)
    b_ms, b_by = bound(nbytes(x, w, rstd, do, dx, parts), 10.0 * N * D)
    shape = f"x={tuple(x.shape)} {str(x.dtype)[6:]} w {str(w.dtype)[6:]}"
    fwd_route = ops.rmsnorm_fwd_route(x.dtype, D, x.data_ptr() % 16 == 0)
    f_new = lambda: ops.rmsnorm_fwd_cuda(x, w, eps)                          # noqa: E731
    f_old = lambda: ops.rmsnorm_fwd_cuda(x, w, eps, route="two_pass")        # noqa: E731
    f_prior, f_ms, f_turns = in_turns(f_old, f_new, 50)
    k10 = dict(name="rmsnorm_fwd", source=K10_SOURCE[0], replaces=K10_SOURCE[1], shape=shape,
               path_route=fwd_route, match=ok10, max_abs_err=e10,
               ms=f_ms, prior_ms=f_prior, turns_ms=list(f_turns),
               plain_ms=cuda_time_ms(lambda: ops.rmsnorm_fwd_plain(x, w, eps), 20),
               bound_ms=f_ms, bound_by=f_by,
               library_ms=cuda_time_ms(lambda: F.rms_norm(x, (D,), w, eps), 50),
               library="torch.nn.functional.rms_norm")
    route = ops.rmsnorm_bwd_route(D)
    new = lambda: ops.rmsnorm_bwd_cuda(x, w, rstd, do)                  # noqa: E731
    old = lambda: ops.rmsnorm_bwd_cuda(x, w, rstd, do, route="tile")    # noqa: E731
    prior_ms, ms, turns = in_turns(old, new, 50)

    def with_dw():
        _, p = ops.rmsnorm_bwd_cuda(x, w, rstd, do)
        return p.sum(dim=0).to(w.dtype)

    k11 = dict(name="rmsnorm_bwd", source=K11_SOURCE[0], replaces=K11_SOURCE[1], shape=shape,
               path_route=route, match=ok11, max_abs_err=max(e11, ep), ms=ms,
               prior_ms=prior_ms, with_dw_sum_ms=cuda_time_ms(with_dw, 50),
               plain_ms=cuda_time_ms(lambda: ops.rmsnorm_bwd_plain(x, w, rstd, do), 20),
               bound_ms=b_ms, bound_by=b_by,
               library_ms=cuda_time_ms(lambda: torch.autograd.grad(lib_out, (xg, wg), do,
                                                                   retain_graph=True), 50),
               library="autograd backward of torch.nn.functional.rms_norm (dx and the whole dw)")
    for r, n in ((k10, launches), (k11, train_launches)):
        print(f"[ssm] {r['name']}: {shape} match={r['match']} max_abs_err={r['max_abs_err']} "
              f"ms={r['ms']:.6f} plain_ms={r['plain_ms']:.6f} library_ms={r['library_ms']:.6f} "
              f"bound_ms={r['bound_ms']:.6f} ({r['bound_by']}) launches={n}", flush=True)
    print(f"[ssm] rmsnorm_fwd on the {fwd_route} route: ms={k10['ms']:.6f}, first design "
          f"(two_pass route) ms={k10['prior_ms']:.6f} (turns first, this, this, first: "
          f"{', '.join(f'{t:.6f}' for t in k10['turns_ms'])}); {f_ms / k10['ms']:.4f} of the "
          f"byte bound", flush=True)
    print(f"[ssm] rmsnorm_bwd on the {route} route: ms={k11['ms']:.6f}, PR 15 design (tile "
          f"route) ms={k11['prior_ms']:.6f} (turns PR 15, this, this, PR 15: "
          f"{', '.join(f'{t:.6f}' for t in turns)}); with the partials' sum (dx and the whole "
          f"dw, as the "
          f"library row) ms={k11['with_dw_sum_ms']:.6f}", flush=True)
    return k10, k11


def check_ssm_small() -> list:
    """K12 at small and ragged shapes in both functions, dtypes and decay
    types, and K10/K11 at small and ragged shapes with mixed gain types,
    against their plain versions; returns the cases that disagree."""
    import torch
    import torch.nn.functional as F

    from repro_torch.kernels.rmsnorm import ops as rms
    from repro_torch.kernels.rwkv6_wkv import ops as wkv

    bad = []
    g = torch.Generator(device="cpu").manual_seed(4)
    for B, S, H, K, chunk in [(2, 256, 4, 64, 64), (1, 48, 2, 32, 32), (2, 33, 4, 16, 16),
                              (1, 100, 2, 24, 64)]:
        c = wkv.cut_chunk(chunk, S)
        for dt, wdt in ((torch.float32, torch.float32), (torch.bfloat16, torch.float32),
                        (torch.bfloat16, torch.bfloat16)):
            r, k, v = ((torch.randn((B, S, H, K), generator=g) * 0.5).to("cuda", dt)
                       for _ in range(3))
            w = (-F.softplus(torch.randn((B, S, H, K), generator=g)) - 0.1).clamp_min(-2.0)
            w = w.to("cuda", wdt)
            u = (torch.randn((1, H, K), generator=g) * 0.3).to("cuda")
            for bf16_intra in (True, False):
                a = (r, k, v, w, u, c, bf16_intra)
                ok = scan_errs(*wkv.wkv_cuda(*a), *wkv.wkv_plain(*a), bf16_intra)[0]
                if not ok:
                    bad.append(f"K12 {(B, S, H, K, c)} {dt} w {wdt} bf16_intra={bf16_intra}")
    # K11: (300, 4100) splits its rows over 5 blocks of 824 columns, the
    # last 804; (129, 1030) over 2, unvectorised, with a one-row tile
    for N, D in [(1, 64), (37, 50), (300, 96), (300, 4100), (129, 1030)]:
        for dt, wdt in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                        (torch.bfloat16, torch.float32)):
            x = (torch.randn((N, D), generator=g) * 3).to("cuda", dt)
            w = torch.randn((D,), generator=g).to("cuda", wdt)
            do = torch.randn((N, D), generator=g).to("cuda", dt)
            out, rstd = rms.rmsnorm_fwd_cuda(x, w)
            pout, prstd = rms.rmsnorm_fwd_plain(x, w)
            dx, parts = rms.rmsnorm_bwd_cuda(x, w, rstd, do)
            tdx, tparts = rms.rmsnorm_bwd_cuda(x, w, rstd, do, route="tile")
            pdx, pparts = rms.rmsnorm_bwd_plain(x, w, rstd, do)
            frac = BF16_STEP if dt == torch.bfloat16 else 1e-5
            for a, b, f in ((out, pout, frac), (dx, pdx, frac), (parts, pparts, 1e-5),
                            (rstd, prstd, 2e-6), (tdx, pdx, frac), (tparts, pparts, 1e-5)):
                if not torch.allclose(a.float(), b.float(), atol=f * float(b.float().abs().max()),
                                      rtol=0):
                    bad.append(f"K10/K11 {(N, D)} {dt} w {wdt}")
    torch.cuda.synchronize()
    print(f"[ssm] K12, K10 and K11 at small and ragged shapes: disagree={bad}", flush=True)
    return bad


def run_ssm(device, train_k11: int) -> tuple:
    """The ``ssm`` phase; returns (K12's, K10's and K11's rows, K12's and
    K10's launches in the prefill)."""
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import counts
    from repro_torch.kernels.rmsnorm import ops as rms_ops
    from repro_torch.kernels.rwkv6_wkv import ops as wkv_ops
    from repro_torch.models import (Runtime, build_param_specs, decode_step, forward,
                                    init_cache, init_params, param_bytes)
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Request, ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch(SSM_ARCH)
    rt = Runtime()
    L = cfg.n_layers
    specs = build_param_specs(cfg, rt)
    n_bytes, block_bytes = param_bytes(specs), param_bytes(specs["blocks"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(specs, torch.Generator(device=device).manual_seed(0), device)
    # the init rules set u_bonus and the token-shift mixes to zero; draw them
    # so that the bonus term and the per-channel mixes take part
    g = torch.Generator(device=device).manual_seed(1)
    blocks = params["blocks"]
    for leaf in (blocks["tmix"]["u_bonus"], blocks["tmix"]["mix"], blocks["cmix"]["mix"]):
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=device) * 0.5)
    torch.cuda.synchronize()
    print(f"[ssm] {cfg.name} at full width and depth: {L} layers, d_model {cfg.d_model}, "
          f"{cfg.n_heads} WKV heads of {cfg.d_model // cfg.n_heads}, d_ff {cfg.d_ff}, vocab "
          f"{cfg.vocab}, chunk {cfg.ssm.chunk}, {rt.param_dtype}: {n_bytes} weight bytes "
          f"({block_bytes / L:.0f} a layer, {n_bytes - block_bytes} for the embedding, the "
          f"head and the final norm) drawn on {device} from seed 0 in "
          f"{time.perf_counter() - t0:.1f}s; u_bonus and the mixes, which the init rules set "
          f"to zero, drawn N(0, 0.5^2) from seed 1", flush=True)

    rng = np.random.default_rng(0)
    B, S = SSM_PREFILL
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab, (B, S))).to(device)
    with torch.no_grad():
        forward(params, cfg, rt, tokens=tokens[:, :512])   # warm-up: cuBLAS, K10, K12 load
        torch.cuda.synchronize()
        with keep_calls(wkv_ops, "wkv_cuda", (0,)) as kept_wkv, \
                keep_calls(rms_ops, "rmsnorm_fwd_cuda", (0,)) as kept_rms:
            counts.reset()
            t0 = time.perf_counter()
            logits = forward(params, cfg, rt, tokens=tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k12 = counts.LAUNCHES["rwkv6_wkv"]
            k12_chunked = counts.ROUTE_LAUNCHES.get("rwkv6_wkv/chunked", 0)
            k10 = counts.LAUNCHES["rmsnorm_fwd"]
            k10_resident = counts.ROUTE_LAUNCHES.get("rmsnorm_fwd/resident", 0)
            plain = {k: v for k, v in counts.PLAIN_CALLS.items() if v}
        print(f"[ssm] prefill {B}x{S}: wall_s={wall:.6f} tokens_per_s={B * S / wall:.1f} "
              f"max_memory_allocated={torch.cuda.max_memory_allocated()} K12 launches={k12} "
              f"(chunked route {k12_chunked}) K10 launches={k10} (resident route "
              f"{k10_resident}) plain_calls={plain}", flush=True)
        if k12 != L or k12_chunked != k12 or k10 != 3 * L + 1 or plain or k10_resident != k10:
            fail(f"prefill launched K12 {k12} times (want {L}, {k12_chunked} on the chunked "
                 f"route) and K10 {k10} times (want {3 * L + 1}, {k10_resident} on the resident "
                 f"route), plain calls {plain} (want none)")
        if tuple(logits.shape) != (B, S, cfg.vocab) or not bool(torch.isfinite(logits).all()):
            fail(f"prefill logits of shape {tuple(logits.shape)} are not finite")
        sample = list(range(0, S, 512)) + [S - 1]
        kernel_rows = logits[:, sample].float()
        del logits

        # the plain route: K12's and K10's plain versions; in bf16 activations
        # rounding compounds through 32 layers, so this is held layer by layer
        # and end to end in float32 activations below
        with plain_route(*SSM_PLAIN):
            t0 = time.perf_counter()
            plain_logits = forward(params, cfg, rt, tokens=tokens)
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - t0
        rel16 = logit_errs(kernel_rows, plain_logits[:, sample])[0]
        del plain_logits
        print(f"[ssm] prefill through the plain route (plain K12 and K10): wall_s="
              f"{plain_wall:.6f}; kernel route vs plain route in bf16 at positions {sample}: "
              f"max|logit diff|/max|logit| {rel16} (held per layer and in float32 below)",
              flush=True)
        bad_layers = check_layers(params, cfg, rt, tokens, kernel_rows, sample)
        if bad_layers:
            fail(f"the kernel and plain routes disagree layer by layer: {bad_layers}")

        # serving: greedy requests through the engine, its launches per step
        engine = ServingEngine(params, cfg, rt, batch_size=SERVE_REQS, max_len=SERVE_MAX_LEN)
        reqs = [Request(prompt=rng.integers(2, cfg.vocab, SERVE_PROMPT).astype(np.int32),
                        max_new_tokens=SERVE_NEW) for _ in range(SERVE_REQS)]
        torch.cuda.synchronize()
        counts.reset()
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        steps = SERVE_PROMPT + SERVE_NEW - 1
        n_new = sum(len(r.generated) for r in reqs)
        e10, e12 = counts.LAUNCHES["rmsnorm_fwd"], counts.LAUNCHES["rwkv6_wkv"]
        e_plain = sum(counts.PLAIN_CALLS.values())
        print(f"[ssm] ServingEngine batch {SERVE_REQS} max_len {SERVE_MAX_LEN}: {SERVE_REQS} "
              f"greedy requests x {SERVE_PROMPT} prompt tokens, {n_new} new tokens in wall_s="
              f"{swall:.6f} ({steps} decode steps of {SERVE_REQS} slots: step_ms="
              f"{swall / steps * 1e3:.3f}, new tokens_per_s={n_new / swall:.1f}); K10 launches "
              f"{e10} ({e10 / steps:.1f} a step), K12 launches {e12}, plain calls {e_plain}; "
              f"first request: {reqs[0].generated[:8]}...", flush=True)
        if any(len(r.generated) != SERVE_NEW or not all(0 <= t < cfg.vocab for t in r.generated)
               for r in reqs):
            fail(f"not every request got {SERVE_NEW} tokens in range")
        if e10 != steps * (3 * L + 1) or e12 or e_plain:
            fail(f"the engine launched K10 {e10} times (want {steps * (3 * L + 1)}), K12 {e12} "
                 f"times (want 0), plain versions {e_plain} times (want 0)")

        # decode against forward on a 64-token prompt, layer by layer in bf16:
        # the chunked K12 (bf16 intra-chunk operands) against the float32
        # recurrence
        prompt = torch.from_numpy(reqs[0].prompt[None].astype(np.int64)).to(device)
        bad_dec = check_decode_layers(params, cfg, rt, prompt)
        if bad_dec:
            fail(f"decode and forward disagree layer by layer: {bad_dec}")

        # end to end in float32 activations (the bf16 weights upcast): the
        # two routes on one sequence of SSM_F32_TOKENS, and decode against
        # forward with K12 in the function the recurrence computes (float32
        # products), each within LOGIT_TOL, 4x under what another first
        # token does
        rt32 = Runtime(param_dtype="float32", compute_dtype="float32")
        p32 = tree_map(lambda t: t.float(), params)
        toks32 = tokens[:1, :SSM_F32_TOKENS]
        rows32 = list(range(0, SSM_F32_TOKENS, 512)) + [SSM_F32_TOKENS - 1]
        k32 = forward(p32, cfg, rt32, tokens=toks32)[:, rows32].float()
        with plain_route(*SSM_PLAIN):
            pl32 = forward(p32, cfg, rt32, tokens=toks32)[:, rows32].float()
        rel, err, pmax = logit_errs(k32, pl32)
        print(f"[ssm] float32 activations, 1x{SSM_F32_TOKENS} prefill: kernel route vs plain "
              f"route at positions {rows32}: max|logit diff|/max|logit| {rel} (bound "
              f"{LOGIT_TOL}), softmax max diff {err} beside a largest probability of {pmax}",
              flush=True)
        if not rel <= LOGIT_TOL:
            fail(f"the kernel route and the plain route disagree: logit diff {rel}")
        with wkv_float32_products():
            par = forward(p32, cfg, rt32, tokens=prompt)[0].float()
        par_model = forward(p32, cfg, rt32, tokens=prompt)[0].float()
        tf_cache = init_cache(cfg, rt32, 1, SERVE_PROMPT, device=device)
        dec = []
        for t in range(SERVE_PROMPT):
            lg, tf_cache = decode_step(p32, cfg, rt32, tf_cache, prompt[:, t:t + 1])
            dec.append(lg[0, 0].float())
        dec = torch.stack(dec)
        rel_d, derr, pmax = logit_errs(dec, par)
        rel_m = logit_errs(dec, par_model)[0]
        moved = prompt.clone()
        moved[0, 0] = 1
        with wkv_float32_products():
            mv = forward(p32, cfg, rt32, tokens=moved)[0].float()
        sens = logit_errs(mv, par)[0]
        sens_last = logit_errs(mv[-1], par[-1])[0]
        print(f"[ssm] float32 activations, decode_step teacher-forced over {SERVE_PROMPT} tokens "
              f"vs forward with float32 K12 products: max|logit diff|/max|logit| {rel_d} (bound "
              f"{LOGIT_TOL}), softmax max diff {derr} beside a largest probability of {pmax}; "
              f"vs the model's forward (bf16 intra-chunk operands, not gated) {rel_m}; another "
              f"first token moves the logits by {sens} over the {SERVE_PROMPT} positions and by "
              f"{sens_last} at the last", flush=True)
        if not rel_d <= LOGIT_TOL:
            fail(f"decode and forward disagree: logit diff {rel_d}")
        if not sens > 4 * LOGIT_TOL:
            fail(f"the logit bound {LOGIT_TOL} is not 4x under the move {sens} that another "
                 f"first token makes")
        del p32, k32, pl32, par, par_model, dec, mv, tf_cache
        torch.cuda.empty_cache()

        # one decode step of the engine's batch: its launches, then profiles
        cache = init_cache(cfg, rt, SERVE_REQS, SERVE_MAX_LEN, device=device)
        step_toks = torch.full((SERVE_REQS, 1), 7, device=device)
        for _ in range(SERVE_PROMPT):
            _, cache = decode_step(params, cfg, rt, cache, step_toks)
        counts.reset()
        decode_step(params, cfg, rt, cache, step_toks)
        torch.cuda.synchronize()
        d10, d12 = counts.LAUNCHES["rmsnorm_fwd"], counts.LAUNCHES["rwkv6_wkv"]
        d7 = counts.LAUNCHES["flash_decode"]
        print(f"[ssm] one decode step of {SERVE_REQS} slots: K10 launches={d10} (want "
              f"{3 * L + 1}) K12 launches={d12} (want 0) K7 launches={d7} (want 0: no attention)",
              flush=True)
        if d10 != 3 * L + 1 or d12 or d7:
            fail(f"a decode step launched K10 {d10} times, K12 {d12} times and K7 {d7} times")
        device_profile(lambda: forward(params, cfg, rt, tokens=tokens), f"prefill {B}x{S}", 2,
                       tag="ssm")
        device_profile(lambda: decode_step(params, cfg, rt, cache, step_toks),
                       f"decode step of {SERVE_REQS} slots at position {SERVE_PROMPT + 1}", 10,
                       tag="ssm")

    wkv_row = hold_wkv(kept_wkv[0][0], k12)
    del params, engine, cache, kept_wkv, blocks
    gc.collect()
    torch.cuda.empty_cache()
    x, w, eps = kept_rms[0][0]
    k10_row, k11_row = hold_rmsnorm(x, w, eps, k10, train_k11)
    del kept_rms, x, w
    bad = check_ssm_small()
    rows = (wkv_row, k10_row, k11_row)
    if not all(r["match"] for r in rows) or bad:
        fail(f"K10-K12 disagree with their plain versions: "
             f"{[(r['name'], r['match']) for r in rows]} small={bad}")
    torch.cuda.empty_cache()
    return rows, k12, k10


# ---------------------------------------------------------------------------
# hybrid serving path (zamba2-2.7b at full width and depth)
# ---------------------------------------------------------------------------

HYB_ARCH = "zamba2-2.7b"
HYB_PREFILL = (2, 4096)
HYB_F32_TOKENS = 2048         # the float32 prefill is one sequence of this many tokens
DECODE_CACHE = 4096           # K7 is also held at a cache of 4 rows of this many keys
K7_SOURCE = ("src/repro_torch/csrc/flash_decode.cu", "src/repro/kernels/flash_decode/kernel.py:60")
K8_SOURCE = ("src/repro_torch/csrc/mamba2_ssd.cu", "src/repro/kernels/mamba2_ssd/kernel.py:60")


def check_hybrid_layers(params, cfg, rt, tokens, kernel_rows, rows) -> list:
    """The prefill layer by layer through the kernel route, each Mamba2
    block, and each shared block's attention and FFN, recomputed through the
    plain route (K8's and K10's plain versions, ``attn_impl="xla"``) on the
    same input; returns the sub-blocks whose outputs disagree (SUBBLOCK_TOL,
    SUBBLOCK_L2). The loop is the hybrid branch of ``models.forward``: its
    logits must equal ``kernel_rows`` (the counted forward's, at ``rows``)."""
    import dataclasses

    import torch

    from repro_torch.models.attention import attention_apply
    from repro_torch.models.blocks import ffn_apply, rmsnorm
    from repro_torch.models.mamba2 import mamba2_apply
    from repro_torch.models.model import _groups, _layer, _logits

    def errs(a, b):
        return logit_errs(a, b)[0], rel_l2(a, b)

    eps = cfg.norm_eps
    plain_rt = dataclasses.replace(rt, attn_impl="xla")
    x = params["embed"][tokens.long()].to(rt.cdtype)
    B, S = x.shape[:2]
    pos = torch.arange(S, dtype=torch.int32, device=x.device)[None].expand(B, S)
    sa = params["shared_attn"]
    groups, every = _groups(cfg)
    bad, worst = [], {"mamba": [0.0, 0.0], "attn": [0.0, 0.0], "ffn": [0.0, 0.0]}

    def hold(name, where, got, want):
        e = errs(got, want)
        worst[name] = [max(w, v) for w, v in zip(worst[name], e)]
        if not (e[0] <= SUBBLOCK_TOL and e[1] <= SUBBLOCK_L2):
            bad.append(f"{where} {name}: {e}")

    for g in range(groups):
        for i in range(g * every, (g + 1) * every):
            p = _layer(params["blocks"], i)
            m_k = mamba2_apply(p["mamba"], rmsnorm(x, p["ln"], eps), cfg, rt)
            with plain_route(*HYB_PLAIN):
                m_p = mamba2_apply(p["mamba"], rmsnorm(x, p["ln"], eps), cfg, rt)
            hold("mamba", f"layer {i}", m_k, m_p)
            x = x + m_k
        a_k = attention_apply(sa["attn"], rmsnorm(x, sa["ln1"], eps), cfg, rt, pos, True)
        with plain_route(*HYB_PLAIN):
            a_p = attention_apply(sa["attn"], rmsnorm(x, sa["ln1"], eps), cfg, plain_rt, pos, True)
        hold("attn", f"group {g}", a_k, a_p)
        x = x + a_k
        f_k = ffn_apply(sa["ffn"], rmsnorm(x, sa["ln2"], eps), cfg.act)
        with plain_route(*HYB_PLAIN):
            f_p = ffn_apply(sa["ffn"], rmsnorm(x, sa["ln2"], eps), cfg.act)
        hold("ffn", f"group {g}", f_k, f_p)
        x = x + f_k
    same = logit_errs(_logits(params, cfg, x)[:, rows].float(), kernel_rows)[0]
    print(f"[hybrid] layer by layer, plain route on the kernel route's inputs: worst "
          f"max|diff|/max and L2 by sub-block {worst} (bounds {SUBBLOCK_TOL}, {SUBBLOCK_L2}); "
          f"disagree={bad}; the loop's logits vs the counted forward's: {same}", flush=True)
    if same != 0.0:
        bad.append(f"the layer loop's logits differ from forward's by {same}")
    return bad


def ssd_op_counts(B: int, S: int, H: int, P: int, N: int, c: int, bf16_intra: bool) -> tuple:
    """(float32 operations, bf16-operand operations) of one SSD scan: per
    (b, h) and chunk, with tri = c(c+1)/2 the lower triangle, the scores and
    the intra-chunk product (2 tri N and 2 tri P; bf16 operands with float32
    sums in the model's function on bf16 activations), the mask (3 tri: a
    difference, an exp, a product), the state's part and the state update
    (2 c N P each) and the decay factors (2 c N + 2 P N)."""
    tri = c * (c + 1) // 2
    return scan_ops(B * H * (S // c), 4 * c * N * P + 3 * tri + 2 * c * N + 2 * P * N,
                    2 * tri * (N + P), bf16_intra)


def hold_ssd(args, launches: int) -> dict:
    """K8 on the first layer's inputs from the prefill against its plain
    version, in the model's function and the Pallas kernel's (float32
    products), by the route the prefill took (``chunked``), its final state
    against the ``serial`` route's (the first design) bit for bit; then
    timed in turns with the first design, each of its three launches' kernel
    time from a profiler trace, beside the plain version and the bound."""
    import torch

    from repro_torch.kernels.mamba2_ssd import ops

    x, Bm, Cm, a, chunk, _ = args
    Bt, S, H, P = x.shape
    N = Bm.shape[-1]
    route = ops.ssd_route(S, chunk, P, N)
    checks = {}
    for model in (True, False):
        y, st = ops.ssd_cuda(x, Bm, Cm, a, chunk, model, route=route)
        _, st_serial = ops.ssd_cuda(x, Bm, Cm, a, chunk, model, route="serial")
        py, pst = ops.ssd_plain(x, Bm, Cm, a, chunk, model)
        torch.cuda.synchronize()
        same = bool(torch.equal(st, st_serial))
        ok, err, share, s_err = scan_errs(y, st, py, pst, model and x.dtype == torch.bfloat16)
        checks[model] = (ok and same, err, share, s_err)
        print(f"[hybrid] K8 ({route} route) vs plain at the first layer's inputs, "
              f"{'model' if model else 'Pallas (float32 products)'} function: max|y| "
              f"{float(py.float().abs().max())} max err {err}, {share} of y within one bf16 step "
              f"of the largest; state err / max|state| {s_err}; final state equal to the serial "
              f"route's bit for bit: {same} (max diff {float((st - st_serial).abs().max())}) "
              f"match={ok and same}", flush=True)
        del y, st, st_serial, py, pst
    n_bytes = nbytes(x, Bm, Cm, a, x) + Bt * H * P * N * 4
    f32_ops, bf16_ops = ssd_op_counts(Bt, S, H, P, N, chunk, x.dtype == torch.bfloat16)
    b_ms, b_by = bound(n_bytes, f32_ops, bf16_ops=bf16_ops)
    f32_b_ms, f32_b_by = bound(n_bytes, sum(ssd_op_counts(Bt, S, H, P, N, chunk, False)))
    first_ms, ms, _ = in_turns(lambda: ops.ssd_cuda(x, Bm, Cm, a, chunk, True, route="serial"),
                               lambda: ops.ssd_cuda(x, Bm, Cm, a, chunk, True, route=route), 10)
    f32_first_ms, f32_ms, _ = in_turns(
        lambda: ops.ssd_cuda(x, Bm, Cm, a, chunk, False, route="serial"),
        lambda: ops.ssd_cuda(x, Bm, Cm, a, chunk, False, route=route), 10)
    steps = traced_ms(lambda: ops.ssd_cuda(x, Bm, Cm, a, chunk, True, route=route),
                      ("ssd_states", "state_pass", "ssd_out")) if route == "chunked" else None
    row = dict(name="mamba2_ssd", source=K8_SOURCE[0], replaces=K8_SOURCE[1],
               shape=f"x={tuple(x.shape)} B/C={tuple(Bm.shape)} {str(x.dtype)[6:]} a "
                     f"{str(a.dtype)[6:]} chunk={chunk} model function",
               path_route=route, match=all(c[0] for c in checks.values()),
               max_abs_err=checks[True][1], ms=ms, first_design_ms=first_ms, step_ms=steps,
               plain_ms=cuda_time_ms(lambda: ops.ssd_plain(x, Bm, Cm, a, chunk, True), 3),
               bound_ms=b_ms, bound_by=b_by, library_ms=None,
               library="none: no PyTorch call computes the chunked SSD scan",
               float32_products_ms=f32_ms, float32_products_first_design_ms=f32_first_ms,
               float32_products_bound_ms=f32_b_ms, float32_products_bound_by=f32_b_by)
    print(f"[hybrid] K8 at the first layer's inputs: {row['shape']} route={route} "
          f"match={row['match']} max_abs_err={row['max_abs_err']} ms={ms:.6f} "
          f"first_design_ms={first_ms:.6f} (in turns: first, new, new, first) steps_ms "
          f"(increments, state pass, outputs; kernel time from a profiler trace)={steps} "
          f"plain_ms={row['plain_ms']:.6f} "
          f"bound_ms={b_ms:.6f} ({b_by}: {n_bytes} bytes, {f32_ops:.6g} float32 and "
          f"{bf16_ops:.6g} bf16-operand operations); float32 products ms={f32_ms:.6f} "
          f"first design {f32_first_ms:.6f} bound_ms={f32_b_ms:.6f} ({f32_b_by}); "
          f"launches={launches}", flush=True)
    return row


def decode_sdpa(q, k, v, lengths):
    """One ``scaled_dot_product_attention`` call on K7's inputs (q as one
    query row per head, the cache moved to (B, H, S, D) beforehand, keys past
    each row's length masked), timed beside K7 and never used."""
    import torch
    import torch.nn.functional as F

    B, Hkv, G, D = q.shape
    S = k.shape[1]
    qs = q.reshape(B, Hkv * G, 1, D).contiguous()
    ks, vs = (t.permute(0, 2, 1, 3).contiguous() for t in (k, v))
    mask = (torch.arange(S, device=q.device)[None, :] < lengths[:, None].long())[:, None, None]
    return lambda: F.scaled_dot_product_attention(qs, ks, vs, attn_mask=mask, enable_gqa=True)


def decode_need(q, k, lengths) -> tuple:
    """(bytes, operations) that decode attention needs on these inputs: q,
    the lengths and o once, each row's first min(len, S) keys of K and of V,
    and for a row of length 0, whose output is the mean of V over every key,
    all S keys of V; 2 flop a needed K or V element for each query row."""
    B, Hkv, G, D = q.shape
    S = k.shape[1]
    lens = lengths.tolist()
    k_keys = sum(min(n, S) for n in lens)
    v_keys = sum(min(n, S) if n > 0 else S for n in lens)
    n_bytes = nbytes(q, lengths) + q.numel() * q.element_size()
    n_bytes += (k_keys + v_keys) * Hkv * D * k.element_size()
    return n_bytes, 2.0 * (k_keys + v_keys) * Hkv * G * D


def hold_decode_one(q, k, v, lengths, label: str) -> dict:
    """K7 on one set of inputs on both routes, each against its plain
    version at the reference's plan (o within one bf16 step of its largest
    magnitude in bfloat16, 2e-5 in float32); then the ring route timed in
    turns with the first design (scalar, ring, ring, scalar) beside the
    plain version and SDPA; the bound is what ``decode_need`` counts, the
    bytes at the memory rate and the flop at the float32 rate."""
    import torch

    from repro_torch.kernels.flash_decode import ops

    B, Hkv, G, D = q.shape
    S = k.shape[1]
    splits, block = ops.split_plan(S, 4, 128)
    route = ops.route_of(q, k, v)
    new = lambda: ops.decode_cuda(q, k, v, lengths)                                 # noqa: E731
    old = lambda: ops.decode_cuda(q, k, v, lengths, splits, route="scalar")         # noqa: E731
    po = ops.decode_plain(q, k, v, lengths, splits, block)
    scale = float(po.float().abs().max())
    tol = BF16_STEP if q.dtype == torch.bfloat16 else 2e-5
    errs = {name: float((f().float() - po.float()).abs().max())
            for name, f in (("new", new), ("old", old))}
    torch.cuda.synchronize()
    match = all(e <= tol * scale for e in errs.values())
    need_bytes, need_ops = decode_need(q, k, lengths)
    b_ms, b_by = bound(need_bytes, need_ops)
    prior_ms, ms, turns = in_turns(old, new, 50)
    plan = (ops.ring_plan(S, B * Hkv * -(-G // ops.ring_rows(G)), torch.cuda.get_device_properties(
        q.device).multi_processor_count) if route == "ring" else (splits, S // splits))
    r = dict(shape=f"q={tuple(q.shape)} cache={tuple(k.shape)} {str(q.dtype)[6:]} "
                   f"lengths={lengths.tolist()}",
             path_route=route, splits=plan[0], split_len=plan[1],
             match=match, max_abs_err=errs["new"], prior_max_abs_err=errs["old"],
             ms=ms, prior_ms=prior_ms, turns_ms=list(turns),
             plain_ms=cuda_time_ms(lambda: ops.decode_plain(q, k, v, lengths, splits, block), 5),
             bound_ms=b_ms, bound_by=b_by,
             library_ms=cuda_time_ms(decode_sdpa(q, k, v, lengths), 50))
    print(f"[hybrid] K7 {label}: {r['shape']} match={match} max_abs_err={errs} (max|o| {scale}) "
          f"{route} route, {plan[0]} splits of {plan[1]} keys: ms={r['ms']:.6f}, first design "
          f"ms={r['prior_ms']:.6f} (turns first, {route}, {route}, first: "
          f"{', '.join(f'{t:.6f}' for t in r['turns_ms'])}); plain_ms={r['plain_ms']:.6f} sdpa_ms="
          f"{r['library_ms']:.6f} bound_ms={b_ms:.6f} ({b_by}: {need_bytes} bytes, "
          f"{need_ops:.6g} flop)", flush=True)
    return r


def hold_decode(args, launches: int, per_step: dict) -> dict:
    """K7 at the engine's decode shape (the inputs of one decode step's first
    launch), then at a cache of 4 rows of DECODE_CACHE keys for zamba2-2.7b
    (32 KV heads of 80, G = 1), llama3-8b (8 of 128, G = 4) and mixtral-8x22b
    (8 of 128, G = 6), all rows full, from seed 5."""
    import torch

    q, k, v, lengths = args[:4]
    row = dict(name="flash_decode", source=K7_SOURCE[0], replaces=K7_SOURCE[1],
               library="torch.nn.functional.scaled_dot_product_attention (enable_gqa, a length "
                       "mask)", launches_per_step_by_phase=per_step)
    row.update(hold_decode_one(q, k, v, lengths, "at the engine's step"))
    g = torch.Generator(device="cuda").manual_seed(5)
    for name, Hkv, G, D in (("zamba2", 32, 1, 80), ("llama3", 8, 4, 128), ("mixtral", 8, 6, 128)):
        B, S = 4, DECODE_CACHE
        qq = torch.randn((B, Hkv, G, D), generator=g, device="cuda").to(torch.bfloat16)
        kk, vv = (torch.randn((B, S, Hkv, D), generator=g, device="cuda").to(torch.bfloat16)
                  for _ in range(2))
        lens = torch.full((B,), S, dtype=torch.int32, device="cuda")
        r = hold_decode_one(qq, kk, vv, lens, f"at a {name} cache of {B} x {S}")
        row[f"cache_{DECODE_CACHE}_{name}"] = r
        row["match"] = row["match"] and r["match"]
        del qq, kk, vv
    print(f"[hybrid] K7 launches: {launches} in the engine run; per decode step by phase "
          f"{per_step}", flush=True)
    return row


def run_hybrid(device, per_step: dict, long_step: dict = None) -> tuple:
    """The ``hybrid`` phase; ``per_step`` holds K7's launches in one decode
    step of the earlier phases, ``long_step`` the serve phase's long-context
    decode step, which K7's row carries. Returns (K8's and K7's rows, K8's launches in
    the prefill, K7's in the engine run, K4's and K10's in the prefill, K4's
    entry at its first call)."""
    import dataclasses
    import gc

    import numpy as np
    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import counts
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_decode import ops as decode_ops
    from repro_torch.kernels.mamba2_ssd import ops as ssd_ops
    from repro_torch.models import (Runtime, build_param_specs, decode_step, forward,
                                    init_cache, init_params, param_bytes)
    from repro_torch.models.params import tree_map
    from repro_torch.serving import Request, ServingEngine

    gc.collect()
    torch.cuda.empty_cache()
    cfg = get_arch(HYB_ARCH)
    rt = Runtime(attn_impl="flash")
    L = cfg.n_layers
    groups = L // cfg.attn_every
    specs = build_param_specs(cfg, rt)
    n_bytes, block_bytes = param_bytes(specs), param_bytes(specs["blocks"])
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    params = init_params(specs, torch.Generator(device=device).manual_seed(0), device)
    # the init rules set D and dt_bias to zero; draw them so that the skip
    # term and the step bias take part
    g = torch.Generator(device=device).manual_seed(1)
    mamba = params["blocks"]["mamba"]
    for leaf in (mamba["D"], mamba["dt_bias"]):
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=device) * 0.5)
    torch.cuda.synchronize()
    di = cfg.ssm.expand * cfg.d_model
    print(f"[hybrid] {cfg.name} at full width and depth: {L} Mamba2 layers, d_model "
          f"{cfg.d_model}, d_inner {di}, {di // cfg.ssm.head_dim} SSD heads of P = "
          f"{cfg.ssm.head_dim}, N = {cfg.ssm.d_state}, conv {cfg.ssm.conv_dim}, chunk "
          f"{cfg.ssm.chunk}; a shared attention + FFN block after every {cfg.attn_every} layers "
          f"({groups} calls of one set of weights: {cfg.n_heads}/{cfg.n_kv_heads} heads of "
          f"{cfg.head_dim}, d_ff {cfg.d_ff}), vocab {cfg.vocab}, {rt.param_dtype}: {n_bytes} "
          f"weight bytes ({block_bytes / L:.0f} a Mamba2 layer, {param_bytes(specs['shared_attn'])} "
          f"for the shared block) drawn on {device} from seed 0 in "
          f"{time.perf_counter() - t0:.1f}s; D and dt_bias, which the init rules set to zero, "
          f"drawn N(0, 0.5^2) from seed 1", flush=True)

    rng = np.random.default_rng(0)
    B, S = HYB_PREFILL
    tokens = torch.from_numpy(rng.integers(2, cfg.vocab, (B, S))).to(device)
    with torch.no_grad():
        forward(params, cfg, rt, tokens=tokens[:, :512])   # warm-up: cuBLAS, K4, K8, K10 load
        torch.cuda.synchronize()
        with keep_calls(ssd_ops, "ssd_cuda", (0,)) as kept_ssd, \
                keep_calls(flash_ops, "flash_fwd_cuda", (0,)) as kept_k4:
            counts.reset()
            t0 = time.perf_counter()
            logits = forward(params, cfg, rt, tokens=tokens)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            k8, k4 = counts.LAUNCHES["mamba2_ssd"], counts.LAUNCHES["flash_attn_fwd"]
            k8_chunked = counts.ROUTE_LAUNCHES.get("mamba2_ssd/chunked", 0)
            k10 = counts.LAUNCHES["rmsnorm_fwd"]
            k10_resident = counts.ROUTE_LAUNCHES.get("rmsnorm_fwd/resident", 0)
            plain = {k: v for k, v in counts.PLAIN_CALLS.items() if v}
        want_k10 = 2 * L + 2 * groups + 1
        print(f"[hybrid] prefill {B}x{S} attn_impl=flash: wall_s={wall:.6f} tokens_per_s="
              f"{B * S / wall:.1f} max_memory_allocated={torch.cuda.max_memory_allocated()} "
              f"K8 launches={k8} (chunked route {k8_chunked}) K4 launches={k4} K10 launches="
              f"{k10} (resident route {k10_resident}) plain_calls={plain}", flush=True)
        if (k8 != L or k8_chunked != k8 or k4 != groups or k10 != want_k10 or plain
                or k10_resident != k10):
            fail(f"prefill launched K8 {k8} times (want {L}, {k8_chunked} on the chunked "
                 f"route), K4 {k4} times (want {groups}) and K10 {k10} times (want {want_k10}), "
                 f"plain calls {plain} (want none)")
        if tuple(logits.shape) != (B, S, cfg.vocab) or not bool(torch.isfinite(logits).all()):
            fail(f"prefill logits of shape {tuple(logits.shape)} are not finite")
        sample = list(range(0, S, 512)) + [S - 1]
        kernel_rows = logits[:, sample].float()
        del logits

        # the plain route: K8's and K10's plain versions and attn_impl="xla";
        # rounding compounds through 54 layers in bf16, so this is held layer
        # by layer and end to end in float32 activations below
        plain_rt = dataclasses.replace(rt, attn_impl="xla")
        with plain_route(*HYB_PLAIN):
            t0 = time.perf_counter()
            plain_logits = forward(params, cfg, plain_rt, tokens=tokens)
            torch.cuda.synchronize()
            plain_wall = time.perf_counter() - t0
        rel16 = logit_errs(kernel_rows, plain_logits[:, sample])[0]
        del plain_logits
        print(f"[hybrid] prefill through the plain route (plain K8 and K10, attn_impl=xla): "
              f"wall_s={plain_wall:.6f}; kernel route vs plain route in bf16 at positions "
              f"{sample}: max|logit diff|/max|logit| {rel16} (held per layer and in float32 "
              f"below)", flush=True)
        bad_layers = check_hybrid_layers(params, cfg, rt, tokens, kernel_rows, sample)
        if bad_layers:
            fail(f"the kernel and plain routes disagree layer by layer: {bad_layers}")

        # serving: greedy requests through the engine, its launches per step
        engine = ServingEngine(params, cfg, rt, batch_size=SERVE_REQS, max_len=SERVE_MAX_LEN)
        reqs = [Request(prompt=rng.integers(2, cfg.vocab, SERVE_PROMPT).astype(np.int32),
                        max_new_tokens=SERVE_NEW) for _ in range(SERVE_REQS)]
        torch.cuda.synchronize()
        counts.reset()
        t0 = time.perf_counter()
        engine.generate(reqs)
        torch.cuda.synchronize()
        swall = time.perf_counter() - t0
        steps = SERVE_PROMPT + SERVE_NEW - 1
        n_new = sum(len(r.generated) for r in reqs)
        e7, e8 = counts.LAUNCHES["flash_decode"], counts.LAUNCHES["mamba2_ssd"]
        e10, e_plain = counts.LAUNCHES["rmsnorm_fwd"], sum(counts.PLAIN_CALLS.values())
        print(f"[hybrid] ServingEngine batch {SERVE_REQS} max_len {SERVE_MAX_LEN}: {SERVE_REQS} "
              f"greedy requests x {SERVE_PROMPT} prompt tokens, {n_new} new tokens in wall_s="
              f"{swall:.6f} ({steps} decode steps of {SERVE_REQS} slots: step_ms="
              f"{swall / steps * 1e3:.3f}, new tokens_per_s={n_new / swall:.1f}); K7 launches "
              f"{e7} ({e7 / steps:.1f} a step), K10 launches {e10} ({e10 / steps:.1f} a step), "
              f"K8 launches {e8}, plain calls {e_plain}; first request: "
              f"{reqs[0].generated[:8]}...", flush=True)
        if any(len(r.generated) != SERVE_NEW or not all(0 <= t < cfg.vocab for t in r.generated)
               for r in reqs):
            fail(f"not every request got {SERVE_NEW} tokens in range")
        if e7 != steps * groups or e10 != steps * want_k10 or e8 or e_plain:
            fail(f"the engine launched K7 {e7} times (want {steps * groups}), K10 {e10} times "
                 f"(want {steps * want_k10}), K8 {e8} times (want 0), plain versions {e_plain} "
                 f"times (want 0)")

        # end to end in float32 activations (the bf16 weights upcast): the
        # two routes on one sequence of HYB_F32_TOKENS, and decode (the float32
        # recurrence, K7) teacher-forced against forward (K8), each within
        # LOGIT_TOL, 4x under what another first token does to the later
        # positions
        rt32 = Runtime(param_dtype="float32", compute_dtype="float32", attn_impl="flash")
        p32 = tree_map(lambda t: t.float(), params)
        toks32 = tokens[:1, :HYB_F32_TOKENS]
        rows32 = list(range(0, HYB_F32_TOKENS, 512)) + [HYB_F32_TOKENS - 1]
        k32 = forward(p32, cfg, rt32, tokens=toks32)[:, rows32].float()
        with plain_route(*HYB_PLAIN):
            pl32 = forward(p32, cfg, dataclasses.replace(rt32, attn_impl="xla"),
                           tokens=toks32)[:, rows32].float()
        rel, err, pmax = logit_errs(k32, pl32)
        print(f"[hybrid] float32 activations, 1x{HYB_F32_TOKENS} prefill: kernel route vs plain "
              f"route at positions {rows32}: max|logit diff|/max|logit| {rel} (bound "
              f"{LOGIT_TOL}), softmax max diff {err} beside a largest probability of {pmax}",
              flush=True)
        if not rel <= LOGIT_TOL:
            fail(f"the kernel route and the plain route disagree: logit diff {rel}")
        prompt = torch.from_numpy(reqs[0].prompt[None].astype(np.int64)).to(device)
        par = forward(p32, cfg, rt32, tokens=prompt)[0].float()
        tf_cache = init_cache(cfg, rt32, 1, SERVE_PROMPT, device=device)
        dec = []
        for t in range(SERVE_PROMPT):
            lg, tf_cache = decode_step(p32, cfg, rt32, tf_cache, prompt[:, t:t + 1])
            dec.append(lg[0, 0].float())
        rel_d, derr, pmax = logit_errs(torch.stack(dec), par)
        moved = prompt.clone()
        moved[0, 0] = 1
        mv = forward(p32, cfg, rt32, tokens=moved)[0].float()
        sens = logit_errs(mv[1:], par[1:])[0]
        sens_last = logit_errs(mv[-1], par[-1])[0]
        print(f"[hybrid] float32 activations, decode_step teacher-forced over {SERVE_PROMPT} "
              f"tokens vs forward: max|logit diff|/max|logit| {rel_d} (bound {LOGIT_TOL}), softmax "
              f"max diff {derr} beside a largest probability of {pmax}; another first token "
              f"moves the logits of positions 1-{SERVE_PROMPT - 1} by {sens} and of the last by "
              f"{sens_last}", flush=True)
        if not rel_d <= LOGIT_TOL:
            fail(f"decode and forward disagree: logit diff {rel_d}")
        if not sens > 4 * LOGIT_TOL:
            fail(f"the logit bound {LOGIT_TOL} is not 4x under the move {sens} that another "
                 f"first token makes")
        del p32, k32, pl32, par, dec, mv, tf_cache
        torch.cuda.empty_cache()

        # one decode step of the engine's batch: its launches, then profiles
        cache = init_cache(cfg, rt, SERVE_REQS, SERVE_MAX_LEN, device=device)
        step_toks = torch.full((SERVE_REQS, 1), 7, device=device)
        for _ in range(SERVE_PROMPT):
            _, cache = decode_step(params, cfg, rt, cache, step_toks)
        with keep_calls(decode_ops, "decode_cuda", (0,)) as kept_dec:
            counts.reset()
            decode_step(params, cfg, rt, cache, step_toks)
            torch.cuda.synchronize()
            d7, d8 = counts.LAUNCHES["flash_decode"], counts.LAUNCHES["mamba2_ssd"]
            d10 = counts.LAUNCHES["rmsnorm_fwd"]
            d7_ring = counts.ROUTE_LAUNCHES.get("flash_decode/ring", 0)
        print(f"[hybrid] one decode step of {SERVE_REQS} slots: K7 launches={d7} (want {groups}, "
              f"ring route {d7_ring}) K10 launches={d10} (want {want_k10}) K8 launches={d8} "
              f"(want 0)", flush=True)
        if d7 != groups or d10 != want_k10 or d8 or d7_ring != d7:
            fail(f"a decode step launched K7 {d7} times, K10 {d10} times and K8 {d8} times")
        device_profile(lambda: forward(params, cfg, rt, tokens=tokens), f"prefill {B}x{S}", 2,
                       tag="hybrid")
        device_profile(lambda: decode_step(params, cfg, rt, cache, step_toks),
                       f"decode step of {SERVE_REQS} slots at position {SERVE_PROMPT + 1}", 10,
                       tag="hybrid")

    del params, engine, cache, mamba
    gc.collect()
    torch.cuda.empty_cache()
    rows = (hold_ssd(kept_ssd[0][0], k8), hold_decode(kept_dec[0][0], e7, dict(per_step,
                                                                              hybrid=d7)))
    if long_step is not None:
        rows[1]["long_context_step"] = long_step
    del kept_ssd, kept_dec
    torch.cuda.empty_cache()
    if not all(r["match"] for r in rows):
        fail(f"K7 and K8 disagree with their plain versions: "
             f"{[(r['name'], r['match']) for r in rows]}")
    k4_row = hold_k4_path("hybrid", *kept_k4[0], k4)
    del kept_k4
    torch.cuda.empty_cache()
    return rows, k8, e7, k4, k10, k4_row


# ---------------------------------------------------------------------------
# SSM and hybrid training (rwkv6-7b with 8 of 32 layers, zamba2-2.7b with 18
# of 54 layers, both at full width), through K12b and K8b
# ---------------------------------------------------------------------------

# (arch, layers kept, the reason printed with the reckoning)
FAMILY_TRAIN = {
    "ssm": (SSM_ARCH, 8, "as llama3-8b and mixtral-8x22b were cut"),
    "hybrid": (HYB_ARCH, 18, "three whole groups of attn_every = 6, so the shared attention "
                             "block fires 3 times (K4-K6 at head dim 80)"),
}
FAMILY_STEPS = 3
K12B_SOURCE = ("src/repro_torch/csrc/rwkv6_wkv_bwd.cu",
               "none: no Pallas original; the reference's backward is jax.vjp of wkv_ref "
               "(src/repro/kernels/rwkv6_wkv/ops.py:30)")
K8B_SOURCE = ("src/repro_torch/csrc/mamba2_ssd_bwd.cu",
              "none: no Pallas original; the reference's backward is jax.vjp of ssd_ref "
              "(src/repro/kernels/mamba2_ssd/ops.py:31)")
# the route comparison runs in float32 activations (the bf16 weights
# upcast) on one sequence of this many tokens, where bf16 roundings do not
# compound through the layers (the ssm and hybrid phases' account)
FAMILY_ROUTE_TOKENS = 2048


def family_reckoning(cfg, n_full: int, n_cut: int, tag: str, why: str) -> None:
    """Print the memory reckoning that sets the cut: 2 bf16 weight, 2 bf16
    gradient and 8 float32 AdamW moment bytes a parameter."""
    print(f"[{tag}] {cfg.name} cut to {cfg.n_layers} layers ({why}): at full depth "
          f"{n_full / 1e9:.2f} B params x (2 bf16 weight + 2 bf16 grad + 8 float32 AdamW "
          f"moment) bytes = {n_full * 12 / 1e9:.1f} GB before the activations of 2 x 4096 "
          f"tokens; at {cfg.n_layers} layers {n_cut / 1e9:.2f} B x 12 = {n_cut * 12 / 1e9:.1f} "
          f"GB. Widths, vocab and sequence as published: d_model {cfg.d_model}, vocab "
          f"{cfg.vocab}", flush=True)


def grad_close(got, want, exact: bool) -> tuple:
    """(within bounds, max abs error, largest magnitude) of a backward
    kernel's outputs against its plain version's: each within 2e-5 of its
    largest magnitude where the function rounds nothing to bf16 (``exact``),
    else within two bf16 steps of it."""
    import torch

    ok, err, scale = True, 0.0, 0.0
    for g, w in zip(got, want):
        g, w = g.float(), w.float()
        s = max(float(w.abs().max()), 1e-30)
        e = float((g - w).abs().max())
        ok = ok and bool(torch.isfinite(g).all()) and e <= (2e-5 if exact else 2 * BF16_STEP) * s
        err, scale = max(err, e), max(scale, s)
    return ok, err, scale


def wkv_bwd_op_counts(B: int, S: int, H: int, K: int, c: int, bf16_intra: bool) -> tuple:
    """(float32 operations, bf16-operand operations) of K12b's function: per
    (b, h) and chunk the state recomputed and the four state products (c K^2
    multiply-adds each), the five intra-chunk products over the strict lower
    triangle (K c(c-1)/2 each; bf16 operands in the model's function), about
    40 operations an element for the exps and the gradients' sums, and dS's
    decay and row sums (4 K^2)."""
    intra = 2 * 5 * (c * (c - 1) // 2) * K
    return scan_ops(B * H * (S // c), 2 * 5 * c * K * K + 40 * c * K + 4 * K * K, intra,
                    bf16_intra)


def ssd_bwd_op_counts(B: int, S: int, H: int, P: int, N: int, c: int, model_bf16: bool) -> tuple:
    """(float32 operations, bf16-operand operations) of K8b's function: per
    (b, h) and chunk the state recomputed and the four state products (c P N
    multiply-adds each), the five intra-chunk products over the lower
    triangle (c(c+1)/2 times N, P, N, N, P), about 10 operations a (q, s)
    pair for the decay mask and its gradients, 20 an element of x, B, C."""
    tri = c * (c + 1) // 2
    intra = 2 * tri * (3 * N + 2 * P)
    return scan_ops(B * H * (S // c), 2 * 5 * c * P * N + 10 * tri + 20 * c * (P + 2 * N), intra,
                    model_bf16)


def hold_scan_bwd(family: str, call, launches: int) -> dict:
    """K12b or K8b on its first layer's training inputs (``call``, the args
    of the layer's backward launch) against its plain version, in the
    model's function and upcast to float32 in the Pallas kernel's (every
    product float32), timed by CUDA events beside the plain version and the
    bound; no PyTorch call computes it (``library_ms`` None)."""
    import torch

    if family == "ssm":
        from repro_torch.kernels.rwkv6_wkv import ops

        r, k, v, w, u, dy, dstate, chunk, bf16_intra = call[0]
        fn, plain, name, src = ops.wkv_bwd_cuda, ops.wkv_bwd_plain, "rwkv6_wkv_bwd", K12B_SOURCE
        model = (r, k, v, w, u, dy, dstate, chunk, bf16_intra)
        f32 = tuple(t.float() for t in (r, k, v, w)) + (u, dy.float(), dstate, chunk, False)
        B, S, H, K = r.shape
        n_in = 5
        ops_model = wkv_bwd_op_counts(B, S, H, K, chunk, True)
        ops_f32 = sum(wkv_bwd_op_counts(B, S, H, K, chunk, False))
        shape = (f"r/k/v/dy={tuple(r.shape)} {str(r.dtype)[6:]} w {str(w.dtype)[6:]} "
                 f"chunk={chunk} bf16 intra-chunk operands")
    else:
        from repro_torch.kernels.mamba2_ssd import ops

        x, Bm, Cm, a, dy, dstate, chunk, mdl = call[0]
        fn, plain, name, src = ops.ssd_bwd_cuda, ops.ssd_bwd_plain, "mamba2_ssd_bwd", K8B_SOURCE
        model = (x, Bm, Cm, a, dy, dstate, chunk, mdl)
        f32 = tuple(t.float() for t in (x, Bm, Cm)) + (a, dy.float(), dstate, chunk, False)
        B, S, H, P = x.shape
        N = Bm.shape[-1]
        n_in = 4
        ops_model = ssd_bwd_op_counts(B, S, H, P, N, chunk, x.dtype == torch.bfloat16)
        ops_f32 = sum(ssd_bwd_op_counts(B, S, H, P, N, chunk, False))
        shape = (f"x/dy={tuple(x.shape)} B/C={tuple(Bm.shape)} (views of one row) "
                 f"{str(x.dtype)[6:]} chunk={chunk} the model's function")
    tag = "train_" + family
    checks = {}
    for label, args, exact in (("the model's function", model, False),
                               ("upcast to float32, float32 products", f32, True)):
        got = fn(*args)
        want = plain(*args)
        torch.cuda.synchronize()
        checks[label] = grad_close(got, want, exact)
        ok, err, scale = checks[label]
        print(f"[{tag}] {name} vs plain at the first layer's inputs, {label}: largest "
              f"|plain| {scale} max err {err} match={ok}", flush=True)
        del got, want
    def moved(args):   # every input read once, each input's gradient written once
        return (nbytes(*(t for t in args if torch.is_tensor(t)))
                + nbytes(*(t for t in args[:n_in] if torch.is_tensor(t))))

    n_bytes = moved(model)
    b_ms, b_by = bound(n_bytes, ops_model[0], bf16_ops=ops_model[1])
    f32_b_ms, f32_b_by = bound(moved(f32), ops_f32)
    ms = cuda_time_ms(lambda: fn(*model), 5)
    f32_ms = cuda_time_ms(lambda: fn(*f32), 3)
    row = dict(name=name, source=src[0], replaces=src[1], shape=shape,
               match=all(c[0] for c in checks.values()),
               max_abs_err=max(c[1] for c in checks.values()), ms=ms,
               plain_ms=cuda_time_ms(lambda: plain(*model), 2), bound_ms=b_ms, bound_by=b_by,
               library_ms=None, library="none: no PyTorch call computes it",
               float32_products_ms=f32_ms, float32_products_bound_ms=f32_b_ms,
               float32_products_bound_by=f32_b_by)
    print(f"[{tag}] {name} at the first layer's inputs: {shape} match={row['match']} "
          f"max_abs_err={row['max_abs_err']} ms={ms:.6f} plain_ms={row['plain_ms']:.6f} "
          f"bound_ms={b_ms:.6f} ({b_by}: {n_bytes} bytes, {ops_model[0]:.6g} "
          f"float32 and {ops_model[1]:.6g} bf16-operand operations); float32 products "
          f"ms={f32_ms:.6f} bound_ms={f32_b_ms:.6f} ({f32_b_by}); launches in "
          f"Trainer.run={launches}", flush=True)
    return row


def check_scan_bwd_small(family: str) -> list:
    """K12b or K8b against its plain version at small and ragged shapes, in
    both functions and dtypes, with the final state's gradient; returns the
    cases that disagree."""
    import torch

    bad = []
    g = torch.Generator(device="cpu").manual_seed(3)
    if family == "ssm":
        from repro_torch.kernels.rwkv6_wkv import ops

        for B, S, H, K, chunk in [(2, 128, 2, 64, 64), (1, 48, 3, 32, 32), (2, 33, 2, 16, 16),
                                  (1, 96, 3, 24, 64)]:
            for dt in (torch.float32, torch.bfloat16):
                for bf16_intra in (False, True):
                    r, k, v, dy = (torch.randn((B, S, H, K), generator=g).to("cuda", dt) * 0.5
                                   for _ in range(4))
                    w = (-torch.nn.functional.softplus(torch.randn((B, S, H, K), generator=g))
                         - 0.1).clamp_min(-2.0).to("cuda")
                    u = (torch.randn((1, H, K), generator=g) * 0.3).to("cuda")
                    ds = torch.randn((B, H, K, K), generator=g).to("cuda")
                    c = ops.cut_chunk(chunk, S)
                    a = (r, k, v, w, u, dy, ds, c, bf16_intra)
                    ok = grad_close(ops.wkv_bwd_cuda(*a), ops.wkv_bwd_plain(*a),
                                    dt == torch.float32 and not bf16_intra)[0]
                    if not ok:
                        bad.append(f"{(B, S, H, K, chunk)} {dt} bf16_intra={bf16_intra}")
    else:
        from repro_torch.kernels.mamba2_ssd import ops

        for B, S, H, P, N, chunk in [(2, 256, 2, 64, 64, 128), (1, 64, 3, 32, 16, 32),
                                     (2, 200, 2, 24, 40, 128), (1, 100, 2, 32, 16, 128)]:
            for dt in (torch.float32, torch.bfloat16):
                for mdl in (False, True):
                    x, dy = (torch.randn((B, S, H, P), generator=g).to("cuda", dt) * 0.5
                             for _ in range(2))
                    Bm, Cm = (torch.randn((B, S, H, N), generator=g).to("cuda", dt) * 0.5
                              for _ in range(2))
                    a = -torch.nn.functional.softplus(torch.randn((B, S, H), generator=g)).to(
                        "cuda")
                    ds = torch.randn((B, H, P, N), generator=g).to("cuda")
                    c = ops.cut_chunk(chunk, S)
                    args = (x, Bm, Cm, a, dy, ds, c, mdl)
                    ok = grad_close(ops.ssd_bwd_cuda(*args), ops.ssd_bwd_plain(*args),
                                    dt == torch.float32)[0]
                    if not ok:
                        bad.append(f"{(B, S, H, P, N, chunk)} {dt} model={mdl}")
    torch.cuda.synchronize()
    print(f"[train_{family}] {'K12b' if family == 'ssm' else 'K8b'} small and ragged shapes x "
          f"dtypes x functions: disagree={bad}", flush=True)
    return bad


def run_train_family(device, family: str) -> tuple:
    """The ``train_ssm`` or ``train_hybrid`` phase; returns (the backward
    kernel's row, launches by kernel in ``Trainer.run``)."""
    import dataclasses
    import gc
    import math

    import torch

    from repro_torch.configs import get_arch
    from repro_torch.kernels import counts
    from repro_torch.models import Runtime, build_param_specs
    from repro_torch.models.params import tree_leaves, tree_map
    from repro_torch.train import make_train_step
    from repro_torch.train.trainer import Trainer

    tag = "train_" + family
    gc.collect()
    torch.cuda.empty_cache()
    arch, layers, why = FAMILY_TRAIN[family]
    full = get_arch(arch)
    cfg = dataclasses.replace(full, n_layers=layers)
    rt = Runtime(attn_impl="flash", remat="none")
    B, S = TRAIN_BATCH
    L = cfg.n_layers
    n_full, n_cut = (sum(math.prod(s.shape) for s in tree_leaves(build_param_specs(c, rt)))
                     for c in (full, cfg))
    family_reckoning(cfg, n_full, n_cut, tag, why)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = Trainer(cfg, rt, seq_len=S, global_batch=B, lr=TRAIN_LR, seed=0, device=device)
    # the leaves the init rules set to zero, drawn so that every term takes
    # part (the serving phases' draws)
    g = torch.Generator(device=device).manual_seed(1)
    blocks = trainer.params["blocks"]
    drawn = ((blocks["tmix"]["u_bonus"], blocks["tmix"]["mix"], blocks["cmix"]["mix"])
             if family == "ssm" else (blocks["mamba"]["D"], blocks["mamba"]["dt_bias"]))
    for leaf in drawn:
        leaf.copy_(torch.randn(leaf.shape, generator=g, device=device) * 0.5)
    torch.cuda.synchronize()
    print(f"[{tag}] weights and AdamW moments on {device} in {time.perf_counter() - t0:.1f}s "
          f"(weights from seed 0, {'u_bonus and the mixes' if family == 'ssm' else 'D and dt_bias'}"
          f" drawn N(0, 0.5^2) from seed 1); batch {B} x {S} from SyntheticTokenPipeline(seed=0)"
          f", lr {trainer.lr}", flush=True)

    if family == "ssm":
        from repro_torch.kernels.rwkv6_wkv import ops as scan_ops_mod
        scan, bwd = "rwkv6_wkv", "rwkv6_wkv_bwd"
        kernels = (scan, bwd, "rmsnorm_fwd", "rmsnorm_bwd")
        norms = 3 * L + 1
        want = {scan: L, bwd: L, "rmsnorm_fwd": norms, "rmsnorm_bwd": norms}
        plain_kernels = SSM_PLAIN + (("rmsnorm", "rmsnorm_bwd"), ("rwkv6_wkv", "wkv_bwd"))
        wrapper = "wkv_bwd_cuda"
    else:
        from repro_torch.kernels.mamba2_ssd import ops as scan_ops_mod
        scan, bwd = "mamba2_ssd", "mamba2_ssd_bwd"
        groups = L // cfg.attn_every
        kernels = (scan, bwd, "flash_attn_fwd", "flash_attn_dq", "flash_attn_dkv",
                   "rmsnorm_fwd", "rmsnorm_bwd")
        norms = 2 * L + 2 * groups + 1
        want = {scan: L, bwd: L, "flash_attn_fwd": groups, "flash_attn_dq": groups,
                "flash_attn_dkv": groups, "rmsnorm_fwd": norms, "rmsnorm_bwd": norms}
        plain_kernels = HYB_PLAIN + (("rmsnorm", "rmsnorm_bwd"), ("mamba2_ssd", "ssd_bwd"))
        wrapper = "ssd_bwd_cuda"

    step_s: list = []
    # the backward runs the layers in reverse: the last launch is layer 0's
    with keep_calls(scan_ops_mod, wrapper, (L - 1,)) as kept:
        counts.reset()
        t0 = time.perf_counter()
        losses = trainer.run(FAMILY_STEPS, log_every=1,
                             on_metrics=lambda step, m: step_s.append(m["s_per_step"]))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(counts.LAUNCHES)
        plain = {k: v for k, v in counts.PLAIN_CALLS.items() if v}
    peak = torch.cuda.max_memory_allocated()
    steady = sum(step_s[1:]) / max(len(step_s) - 1, 1)
    print(f"[{tag}] Trainer.run({FAMILY_STEPS}): losses {losses}; wall_s={wall:.6f}; step_s "
          f"{step_s} (the first includes warm-up); steady step_ms={steady * 1e3:.3f} "
          f"tokens_per_s={B * S / steady:.1f}; max_memory_allocated={peak}; launches "
          f"{ {k: launches[k] for k in kernels} } plain_calls {plain}", flush=True)
    for name in kernels:
        if launches[name] != FAMILY_STEPS * want[name]:
            fail(f"{tag}: Trainer.run launched {name} {launches[name]} times (want "
                 f"{FAMILY_STEPS * want[name]})")
    if plain:
        fail(f"{tag}: Trainer.run called plain versions {plain} (want none)")
    ln_v = math.log(cfg.vocab)
    if not all(math.isfinite(x) for x in losses) or abs(losses[0] - ln_v) > LOSS_MARGIN:
        fail(f"{tag}: losses {losses} are not finite or the first is not within {LOSS_MARGIN} "
             f"of ln({cfg.vocab}) = {ln_v}")

    batch = {k: torch.from_numpy(v).to(device)
             for k, v in trainer.pipeline.batch_at(FAMILY_STEPS).items()}
    step = make_train_step(cfg, rt, lr=trainer.lr)
    rep = []
    for _ in range(3):
        trainer.params, trainer.opt, m = step(trainer.params, trainer.opt, batch)
        rep.append(float(m["loss"]))
    print(f"[{tag}] make_train_step x 3 on one repeated batch: losses {rep}", flush=True)
    if not rep[-1] < rep[0]:
        fail(f"{tag}: the loss does not fall on a repeated batch: {rep}")

    # the kernels' route against the plain route (K12/K8, K12b/K8b, K10/K11
    # plain and xla attention) from the same weights and batch, in float32
    # activations on one sequence (the account at FAMILY_ROUTE_TOKENS)
    del trainer.opt
    gc.collect()
    torch.cuda.empty_cache()
    params32 = tree_map(lambda t: t.float(), trainer.params)
    del trainer
    gc.collect()
    torch.cuda.empty_cache()
    rt32 = dataclasses.replace(rt, param_dtype="float32", compute_dtype="float32")
    one = {k: t[:1, :FAMILY_ROUTE_TOKENS] for k, t in batch.items()}
    counts.reset()
    loss_k, g_k = grads_of(params32, cfg, rt32, one)
    k_launches = {k: v for k, v in counts.LAUNCHES.items() if v}
    with plain_route(*plain_kernels):
        loss_p, g_p = grads_of(params32, cfg, dataclasses.replace(rt32, attn_impl="xla"), one)
    names = [".".join(p) for p in _leaf_paths(params32)]
    route = [rel_l2(a, b) for a, b in zip(g_k, g_p)]
    del g_k, g_p, params32
    print(f"[{tag}] loss_fn, kernels' route (launches {k_launches}) vs plain route, float32 "
          f"activations on 1 x {FAMILY_ROUTE_TOKENS}: losses {loss_k} / {loss_p} (diff "
          f"{abs(loss_k - loss_p)}, bound {ROUTE_LOSS_TOL}); largest |g_kernels - g_plain| / "
          f"|g_plain| over the leaves {max(route):.6g} (bound {ROUTE_GRAD_TOL})", flush=True)
    for n, r in zip(names, route):
        print(f"[{tag}]   grad {n}: {r:.6g}", flush=True)
    bad = [n for n, r in zip(names, route) if not r <= ROUTE_GRAD_TOL]
    if abs(loss_k - loss_p) > ROUTE_LOSS_TOL or bad:
        fail(f"{tag}: the kernels' and plain routes disagree: loss diff "
             f"{abs(loss_k - loss_p)}, leaves {bad}")
    del batch, one
    gc.collect()
    torch.cuda.empty_cache()

    row = hold_scan_bwd(family, kept[L - 1], launches[bwd])
    del kept
    small = check_scan_bwd_small(family)
    if not row["match"] or small:
        fail(f"{tag}: {bwd} disagrees with its plain version: match={row['match']} "
             f"small={small}")
    torch.cuda.empty_cache()
    return row, launches


def main() -> int:
    argparse.ArgumentParser(description=__doc__.split("\n\n")[0]).parse_args()

    if not (ROOT / "src" / "repro_torch" / "csrc").is_dir():
        fail(f"no repro_torch checkout beside {Path(__file__).name}")
    sys.path.insert(0, str(ROOT / "src"))
    import torch

    if not torch.cuda.is_available():
        fail("torch.cuda.is_available() is False")
    device = "cuda"
    card = card_line()
    print(f"[card] {card}", flush=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} "
          f"cuda {torch.version.cuda}", flush=True)

    from repro_torch.kernels import build

    t0 = time.perf_counter()
    logs = build.build_all()
    print(f"[build] {len(logs)} kernels in {time.perf_counter() - t0:.1f}s", flush=True)
    for name, text in logs.items():
        print(f"[build] {name}: nvcc {' '.join(build.NVCC_FLAGS)}", flush=True)
        for line in text.splitlines():
            if "ptxas" in line or "error" in line.lower():
                print(f"[build] {name}: {line.strip()}", flush=True)
    check_hopper_build(logs)

    phase_s = {}
    t0 = time.perf_counter()
    kb = grid_kb(KB_OBS, device)
    print(f"[kb] {len(kb.tasks)} histories x {KB_OBS} observations built on "
          f"{device} in {time.perf_counter() - t0:.1f}s", flush=True)
    launches, captured, first = run_tuner(kb, device)
    staged_run = run_tuner_staged(kb, device, first)
    floor_ms = launch_floor_ms(torch.device(device))
    main_rows = check_main_path(captured, floor_ms)
    main_rows[[r["name"] for r in main_rows].index("chain_ordinals")].update(staged_run)
    check_k3_sizes(device)
    scale_rows = check_at_scale(kb, device, floor_ms)
    bad = [f"{r['name']} ({r['shape']})" for r in main_rows + scale_rows if not r["match"]]
    if bad:
        fail(f"kernels disagree with their plain versions: {bad}")
    phase_s["tuner"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    fused, fused_launches = run_tuner_fused(kb, device, first)
    q1_row, q2_row, step_launches, step_numbers = check_propose_at_scale(kb, device, floor_ms)
    for row in (q1_row, q2_row):
        launches[row["name"]] = step_launches[row["name"]]
        row["tuner_launches"] = fused_launches[row["name"]]
        main_rows.append(row)
    for row in main_rows[:3]:
        if row["name"] in ("forest_eval", "radix_rank"):
            row["propose_launches"] = step_launches[row["name"]]
            row["propose_tuner_launches"] = fused_launches[row["name"]]
    phase_s["propose"] = time.perf_counter() - t0
    print(f"[propose] phase seconds {phase_s['propose']:.1f}", flush=True)
    t0 = time.perf_counter()
    baseline_keys, baselines_phase = run_baselines(device, first[0].best_performance, kb)
    for row in main_rows[:3]:
        row.update(baseline_keys.get(row["name"], {}))
    phase_s["baselines"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    k4_row, k4_launches, serve_k10, serve_k7, long_step = run_serve(device)
    phase_s["serve"] = time.perf_counter() - t0
    launches["flash_attn_fwd"] = k4_launches
    main_rows.append(k4_row)
    t0 = time.perf_counter()
    bwd_rows, train_launches, train_k4 = run_train(device)
    phase_s["train"] = time.perf_counter() - t0
    for name in ("flash_attn_dq", "flash_attn_dkv", "rmsnorm_bwd"):
        launches[name] = train_launches[name]
    main_rows.extend(bwd_rows)
    t0 = time.perf_counter()
    k9_row, launches["moe_gmm"], moe_k4, moe_k10, moe_k7, moe_k4_row = run_moe(device)
    phase_s["moe"] = time.perf_counter() - t0
    main_rows.append(k9_row)
    t0 = time.perf_counter()
    ssm_rows, launches["rwkv6_wkv"], launches["rmsnorm_fwd"] = run_ssm(
        device, train_launches["rmsnorm_bwd"])
    phase_s["ssm"] = time.perf_counter() - t0
    print(f"[ssm] phase seconds {phase_s['ssm']:.1f}", flush=True)
    main_rows.extend(ssm_rows)
    t0 = time.perf_counter()
    (hyb_rows, launches["mamba2_ssd"], launches["flash_decode"], hyb_k4, hyb_k10,
     hyb_k4_row) = run_hybrid(device, {"serve": serve_k7, "moe": moe_k7}, long_step)
    k4_row["by_path"] += [train_k4, moe_k4_row, hyb_k4_row]
    phase_s["hybrid"] = time.perf_counter() - t0
    print(f"[hybrid] phase seconds {phase_s['hybrid']:.1f}", flush=True)
    main_rows.extend(hyb_rows)
    family_launches = {}
    for family in ("ssm", "hybrid"):
        t0 = time.perf_counter()
        bwd_row, family_launches[family] = run_train_family(device, family)
        phase_s["train_" + family] = time.perf_counter() - t0
        print(f"[train_{family}] phase seconds {phase_s['train_' + family]:.1f}", flush=True)
        launches[bwd_row["name"]] = family_launches[family][bwd_row["name"]]
        main_rows.append(bwd_row)
    t0 = time.perf_counter()
    run_agreement()
    phase_s["agree"] = time.perf_counter() - t0
    print("[time] seconds by phase: " + " ".join(f"{k}={v:.1f}" for k, v in phase_s.items()),
          flush=True)

    def line(r, n_launches):
        out = {"name": r["name"], "route": "cuda", "source": r["source"],
               "replaces": r["replaces"], "launches": n_launches, "shape": r["shape"],
               "max_abs_err": r["max_abs_err"], "match": r["match"], "ms": r["ms"],
               "plain_ms": r["plain_ms"], "bound_ms": r["bound_ms"],
               "bound_by": r["bound_by"], "library_ms": r["library_ms"]}
        out.update({k: v for k, v in r.items()
                    if k.startswith(("library", "decode_", "float32_", "cache_", "launches_",
                                     "by_path", "simt_", "floor_", "prior_", "path_route",
                                     "w_down_", "with_dw_", "turns_", "split", "long_",
                                     "first_design", "step_", "tuner_", "traced_",
                                     "launch_floor", "design_floor", "staged_", "values_",
                                     "eval_", "events_", "propose_", "baselines_"))
                    and k not in out})
        if r["name"] == "flash_attn_fwd" and n_launches is not None:
            out["train_launches"] = train_launches["flash_attn_fwd"]
            out["moe_launches"] = moe_k4
            out["hybrid_launches"] = hyb_k4
        if r["name"] == "rmsnorm_fwd":
            out["launches_by_phase"] = {"serve": serve_k10, "moe": moe_k10,
                                        "train": train_launches["rmsnorm_fwd"],
                                        "ssm": n_launches, "hybrid": hyb_k10}
        return out

    # "kernels": K1-K3 at the largest call of the tuner run, with the run's
    # launch counts; K4 at the serve phase's prefill with its launch count
    # there (and its counts in the train phase's Trainer.run and the moe
    # phase's prefill beside it; its float32 route at the same inputs; in
    # "by_path", each path's first K4 call with the CUDA-core design timed in
    # turns beside it); K5 and K6 at the train phase's first layer
    # with their counts in Trainer.run; K9 at the moe phase's
    # first layer with its launches in that prefill (its launches per
    # decode step and its times at a decode step's shape beside them); K12
    # at the ssm phase's first layer with its launches in that prefill; K10
    # and K11 at the ssm prefill's first ln1 input, K10 with its launches in
    # that prefill (and in each phase's counted run beside them), K11 with
    # its launches in the train phase's Trainer.run, the path that runs it;
    # K8 at the hybrid phase's first layer with its launches in that
    # prefill; K12b and K8b at the train_ssm and train_hybrid phases' first
    # layers with their launches in that phase's Trainer.run; K7 at the hybrid engine's decode step (and at caches of 4 x
    # 4096 keys) with its launches in the hybrid engine run (and per decode
    # step in each phase beside them);
    # K1 and K2 also with their launches in each baseline tuner's 24 h run
    # and their largest call there ("baselines_launches", "baselines_largest");
    # "at_scale": K1 and K2 at 131072 candidates, which the tuner run does
    # not reach (no launch count)
    print(json.dumps({"kernels": [line(r, launches[r["name"]]) for r in main_rows],
                      "at_scale": [line(r, None) for r in scale_rows],
                      "propose": {"tuner": fused, "step": step_numbers},
                      "baselines": baselines_phase}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
