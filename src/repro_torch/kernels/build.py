"""Build and load the port's CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into its own shared
library with a plain C interface and loaded with ``ctypes`` (no PyTorch
headers, so a build takes seconds). Builds happen at first use, into
``_build/`` beside this package (listed in ``.gitignore``); a library is
named by the hash of its source, the ``csrc/*.cuh`` headers the source
includes and the flags, so an edited source or header rebuilds.
:func:`build_all` starts one ``nvcc`` per source at once.

``--fmad=false`` keeps every multiply and add a separate IEEE operation,
as the numpy reference computes them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, List, Tuple

__all__ = ["KERNEL_SOURCES", "NVCC_FLAGS", "build_all", "load", "nvcc_path", "source_path"]

_PKG = Path(__file__).resolve().parent.parent
_CSRC = _PKG / "csrc"
_BUILD = _PKG / "_build"

KERNEL_SOURCES = (
    "forest_eval", "radix_rank", "chain_ordinals", "flash_attn_fwd", "flash_attn_bwd", "moe_gmm",
    "rmsnorm", "rwkv6_wkv", "mamba2_ssd", "flash_decode", "launch_floor", "qs_descent",
    "combine_ei", "rwkv6_wkv_bwd", "mamba2_ssd_bwd", "moe_gmm_bwd",
)

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "--fmad=false",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def source_path(name: str) -> Path:
    return _CSRC / f"{name}.cu"


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")
    return found


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _lib_path(name: str) -> Path:
    text = source_path(name).read_bytes()
    h = hashlib.sha256(text)
    for header in sorted(set(_INCLUDE.findall(text))):
        h.update(header + b"\0" + (_CSRC / header.decode()).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return _BUILD / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str) -> Tuple[Path, Path, "subprocess.Popen[str]"]:
    out = _lib_path(name)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(source_path(name))]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def build_all(names=KERNEL_SOURCES) -> Dict[str, str]:
    """Compile every named kernel that has no library yet, all ``nvcc``
    processes at once. Returns ``{name: compiler output}`` (the
    ``-Xptxas -v`` register and spill lines); raises if a build fails."""
    _BUILD.mkdir(parents=True, exist_ok=True)
    logs: Dict[str, str] = {}
    running: List[Tuple[str, Path, Path, "subprocess.Popen[str]"]] = []
    for name in names:
        if _lib_path(name).exists():
            logs[name] = "(cached)"
            continue
        running.append((name, *_start(name)))
    failed = []
    for name, out, tmp, proc in running:
        text, _ = proc.communicate()
        logs[name] = text
        if proc.returncode != 0:
            failed.append(f"{name} (exit {proc.returncode}):\n{text}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("nvcc failed for " + "\n".join(failed))
    return logs


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            build_all((name,))
            lib = ctypes.CDLL(str(_lib_path(name)))
            _LIBS[name] = lib
        return lib
