"""Training launcher, the reference's ``launch/train.py`` on PyTorch:

    python -m repro_torch.launch.train --arch llama3-8b --reduced --steps 200 [--device cpu]

Runs on the CUDA card unless ``--device cpu`` is given. Without
``--reduced`` the model is the architecture at its published width.
Prints the final loss beside the first.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="llama3-8b")
    ap.add_argument("--reduced", action="store_true")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from ..configs import get_arch, reduced
    from ..models import Runtime
    from ..train.trainer import Trainer

    cfg = get_arch(args.arch)
    if args.reduced:
        cfg = reduced(cfg)
    rt = Runtime(remat="none", scan_layers=True, attn_chunk=min(256, args.seq_len))
    trainer = Trainer(cfg, rt, seq_len=args.seq_len, global_batch=args.batch,
                      lr=args.lr, seed=args.seed, ckpt_dir=args.ckpt_dir, device=args.device)
    losses = trainer.run(args.steps)
    print(f"final loss: {losses[-1]:.4f} (start {losses[0]:.4f})")


if __name__ == "__main__":
    main()
