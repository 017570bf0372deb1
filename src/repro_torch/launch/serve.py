"""Serving launcher: batched generation with random weights from a seed.

    python -m repro_torch.launch.serve --arch llama3-8b [--full] [--device cpu]
    python -m repro_torch.launch.serve --arch zamba2-2.7b [--full] [--device cpu]
    python -m repro_torch.launch.serve --arch seamless-m4t-medium [--full] [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given. The model is
``reduced(get_arch(arch))``, as in the reference's launcher, unless
``--full`` asks for the architecture at its published width (llama3-8b:
16 GB of bf16 weights, drawn on the card; rwkv6-7b: 16.1 GB; zamba2-2.7b:
7.64 GB; seamless-m4t-medium: 1.96 GB; mixtral-8x22b's 281 GB and
deepseek-v3-671b's do not fit one card). An enc-dec model is served as the
reference serves it: its decoder attends over an encoder cache of
``max_len`` zero rows. Prints each request's tokens, then the serving time
on the host clock.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--full", action="store_true",
                    help="the architecture at its published width instead of reduced()")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..configs import get_arch, reduced
    from ..device import resolve_device
    from ..models import Runtime, build_param_specs, init_params
    from ..serving import Request, ServingEngine

    dev = resolve_device(args.device)
    cfg = get_arch(args.arch) if args.full else reduced(get_arch(args.arch))
    rt = Runtime(remat="none", attn_chunk=64)
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    params = init_params(build_param_specs(cfg, rt), gen, dev)
    engine = ServingEngine(params, cfg, rt, batch_size=min(args.requests, 4),
                           max_len=128)
    rng = np.random.default_rng(args.seed)
    reqs = [
        Request(prompt=rng.integers(2, cfg.vocab, args.prompt_len).astype(np.int32),
                max_new_tokens=args.max_new)
        for _ in range(args.requests)
    ]
    t0 = time.perf_counter()
    engine.generate(reqs)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    wall = time.perf_counter() - t0
    for i, r in enumerate(reqs):
        print(f"req {i}: generated {len(r.generated)} tokens: {r.generated[:12]}...")
    n_new = sum(len(r.generated) for r in reqs)
    print(f"{cfg.name} ({'full' if args.full else 'reduced'}) on {dev}: {len(reqs)} requests, "
          f"{n_new} new tokens in {wall:.3f} s (host clock, prompt steps included)")


if __name__ == "__main__":
    main()
