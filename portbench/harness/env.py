"""Where a run starts from: the checkout's paths, the cache directories,
the process's start time, and the check that nothing of JAX or of the JAX
package was loaded.

Importing this module changes nothing; :func:`prepare` does, once, at the
start of a run.
"""

from __future__ import annotations

import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]          # the checkout
BENCH = ROOT / "portbench"
SRC = ROOT / "src"
PACKAGE = SRC / "repro_torch"
# every cache a run fills, at fixed paths inside the checkout (git-ignored)
CACHE = ROOT / ".cache" / "portbench"

# top-level module names that may not be loaded in a run, compared whole:
# ``repro_torch`` is the program, ``repro`` the JAX package it was ported from
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def process_start() -> float:
    """The wall-clock time at which this process started (Linux), or the
    time of the first call where /proc cannot say."""
    try:
        with open("/proc/self/stat") as f:
            fields = f.read().rsplit(")", 1)[1].split()
        start_ticks = int(fields[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, StopIteration, IndexError):
        return time.time()


def prepare() -> None:
    """Put ``src/`` and the checkout on ``sys.path`` and point the program's
    caches at fixed directories inside the checkout."""
    for p in (str(SRC), str(ROOT)):
        if p not in sys.path:
            sys.path.insert(0, p)
    CACHE.mkdir(parents=True, exist_ok=True)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ.setdefault("USE_FLAX", "0")
    os.environ.setdefault("USE_JAX", "0")


def forbidden_modules() -> list:
    """The loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({name for name in list(sys.modules) if name.split(".", 1)[0] in FORBIDDEN})
