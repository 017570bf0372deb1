"""Training loop: steps, checkpoints, preemption safety, metrics.

The reference's ``train/trainer.py`` on PyTorch. ``Trainer.run`` resumes
exactly from the newest checkpoint (params, optimizer state, data cursor),
saves every ``save_every`` steps asynchronously, and installs a SIGTERM
hook that stops the loop and commits a final checkpoint (preemption
safety). Parameters are drawn by ``init_params`` from a
``torch.Generator(device).manual_seed(seed)``, so they differ from the
reference's ``PRNGKey(seed)`` draws; to start both packages from the same
weights, set ``trainer.params`` and ``trainer.opt`` from the reference's
through ``repro_torch.convert``. Runs on the card unless ``device="cpu"``.
"""

from __future__ import annotations

import signal
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from ..configs.base import ArchConfig
from ..data import SyntheticTokenPipeline
from ..device import DeviceLike, resolve_device
from ..models import Runtime, build_param_specs, init_params
from ..models.runtime import torch_dtype
from ..optim import adamw_init
from .checkpoint import CheckpointManager
from .step import make_train_step

__all__ = ["Trainer"]


class Trainer:
    def __init__(
        self,
        cfg: ArchConfig,
        rt: Runtime,
        seq_len: int = 256,
        global_batch: int = 8,
        lr: float = 3e-4,
        seed: int = 0,
        ckpt_dir: Optional[str] = None,
        save_every: int = 50,
        device: DeviceLike = None,
    ):
        self.cfg = cfg
        self.rt = rt
        self.lr = lr
        self.save_every = save_every
        self.device = resolve_device(device)
        self.pipeline = SyntheticTokenPipeline(cfg.vocab, seq_len, global_batch, seed=seed)
        gen = torch.Generator(device=self.device).manual_seed(seed)
        self.params = init_params(build_param_specs(cfg, rt), gen, self.device)
        self.opt = adamw_init(self.params, dtype=torch_dtype(rt.opt_state_dtype))
        self.step_fn = make_train_step(cfg, rt, lr=lr)
        self.ckpt = CheckpointManager(ckpt_dir) if ckpt_dir else None
        self.step = 0
        self._preempted = False

    # ----------------------------------------------------------- persistence
    def _state(self) -> Dict[str, Any]:
        return {"params": self.params, "opt": self.opt}

    def maybe_resume(self) -> bool:
        if self.ckpt is None or self.ckpt.latest_step() is None:
            return False
        state, extra = self.ckpt.restore(self._state(), device=self.device)
        self.params, self.opt = state["params"], state["opt"]
        self.step = int(extra["step"])
        self.pipeline.restore(extra["data"])
        return True

    def save(self, block: bool = False) -> None:
        if self.ckpt is None:
            return
        self.ckpt.save(
            self.step, self._state(),
            extra={"step": self.step, "data": self.pipeline.state()},
            block=block,
        )

    def _install_preemption_hook(self) -> None:
        def handler(signum, frame):
            self._preempted = True

        try:
            signal.signal(signal.SIGTERM, handler)
        except ValueError:
            pass  # not the main thread

    # ------------------------------------------------------------------ run
    def run(self, steps: int, log_every: int = 10,
            on_metrics: Optional[Callable[[int, Dict[str, float]], None]] = None):
        self._install_preemption_hook()
        self.maybe_resume()
        losses = []
        t0 = time.perf_counter()
        target = self.step + steps
        while self.step < target and not self._preempted:
            batch = next(self.pipeline)
            batch = {k: torch.from_numpy(v).to(self.device) for k, v in batch.items()}
            self.params, self.opt, metrics = self.step_fn(self.params, self.opt, batch)
            self.step += 1
            losses.append(float(metrics["loss"]))
            if self.step % log_every == 0:
                dt = (time.perf_counter() - t0) / log_every
                m = {"loss": float(np.mean(losses[-log_every:])), "s_per_step": dt}
                if on_metrics:
                    on_metrics(self.step, m)
                else:
                    print(f"step {self.step}: loss={m['loss']:.4f} ({dt:.2f}s/step)", flush=True)
                t0 = time.perf_counter()
            if self.ckpt is not None and self.step % self.save_every == 0:
                self.save()
        if self.ckpt is not None:
            self.save(block=True)
            self.ckpt.wait()
        return losses
