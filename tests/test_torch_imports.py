"""The port imports neither JAX nor anything of the reference package."""
from __future__ import annotations

import ast
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module


def _forbidden(mod: str) -> bool:
    top = mod.split(".")[0]
    return top in ("jax", "jaxlib", "repro")


def test_scan_covers_the_package():
    names = {p.name for p in FILES}
    assert {"chip_smoke.py", "surrogate.py", "chain.py", "rank.py", "mftune.py"} <= names
    rel = {str(p.relative_to(ROOT)) for p in FILES}
    assert {"src/repro_torch/models/attention.py", "src/repro_torch/models/model.py",
            "src/repro_torch/serving/engine.py", "src/repro_torch/launch/serve.py",
            "src/repro_torch/kernels/flash_attn/ops.py",
            "src/repro_torch/kernels/flash_attn/ref.py",
            "src/repro_torch/optim/adamw.py", "src/repro_torch/optim/schedules.py",
            "src/repro_torch/data/pipeline.py", "src/repro_torch/train/step.py",
            "src/repro_torch/train/checkpoint.py", "src/repro_torch/train/trainer.py",
            "src/repro_torch/launch/train.py", "src/repro_torch/convert.py",
            "src/repro_torch/models/moe.py", "src/repro_torch/kernels/moe_gmm/ops.py",
            "src/repro_torch/kernels/moe_gmm/ref.py", "src/repro_torch/models/rwkv6.py",
            "src/repro_torch/kernels/rmsnorm/ops.py", "src/repro_torch/kernels/rmsnorm/ref.py",
            "src/repro_torch/kernels/rwkv6_wkv/ops.py",
            "src/repro_torch/kernels/rwkv6_wkv/ref.py", "src/repro_torch/models/mamba2.py",
            "src/repro_torch/kernels/mamba2_ssd/ops.py",
            "src/repro_torch/kernels/mamba2_ssd/ref.py",
            "src/repro_torch/kernels/flash_decode/ops.py",
            "src/repro_torch/kernels/flash_decode/ref.py",
            "src/repro_torch/baselines/__init__.py", "src/repro_torch/baselines/common.py",
            "src/repro_torch/baselines/locat.py", "src/repro_torch/baselines/loftune.py",
            "src/repro_torch/baselines/rover.py", "src/repro_torch/baselines/sc_variants.py",
            "src/repro_torch/baselines/toptune.py", "src/repro_torch/baselines/tuneful.py",
            "src/repro_torch/obs/export.py", "src/repro_torch/obs/report.py",
            "src/repro_torch/obs/selfcheck.py"} <= rel
    assert len(FILES) > 50


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_imports(path):
    bad = [m for m in _imported_modules(path) if _forbidden(m)]
    assert not bad, f"{path.relative_to(ROOT)} imports {bad}"


def test_scanner_flags_forbidden_imports():
    assert _forbidden("jax.numpy") and _forbidden("repro.core") and _forbidden("repro")
    assert not _forbidden("repro_torch.core") and not _forbidden("torch")
