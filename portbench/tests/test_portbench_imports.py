"""Nothing the harness runs on the chip imports JAX or the JAX package
(``repro``), compared by whole top-level names, since the port's name,
``repro_torch``, begins with the JAX package's; the references import
nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest

from portbench.harness import env

FILES = sorted(p for p in env.BENCH.rglob("*.py") if "tests" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(env.BENCH)))
def test_no_jax_or_jax_package(path):
    assert not set(_imports(path)) & set(env.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((env.BENCH / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_references_import_nothing_of_the_program(path):
    assert not {"repro_torch", "portbench"} & set(_imports(path))


def test_forbidden_names_are_compared_whole():
    mods = dict(sys.modules)
    try:
        sys.modules["repro_torch_fake"] = sys
        sys.modules["jaxlike"] = sys
        assert env.forbidden_modules() == []
        sys.modules["repro.core"] = sys
        assert env.forbidden_modules() == ["repro.core"]
    finally:
        sys.modules.clear()
        sys.modules.update(mods)


def test_a_whole_cpu_run_loads_no_jax():
    code = (
        "import sys, json, torch; sys.path[:0] = [%r, %r];"
        "from portbench.harness import env; env.prepare();"
        "sys.path.insert(0, %r); from conftest import _tiny_cell;"
        "from portbench.harness.cell import run;"
        "r = run(_tiny_cell('mixtral-prefill'), 1, 0.5, False, torch.device('cpu'), 0.0);"
        "print(json.dumps(env.forbidden_modules()))"
    ) % (str(env.ROOT), str(env.SRC), str(env.BENCH / "tests"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300,
                         cwd=str(env.ROOT))
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []


def test_run_refuses_without_a_card_or_outside_a_checkout(tmp_path):
    import shutil

    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    out = subprocess.run([sys.executable, str(env.BENCH / "run.py"), "--workload",
                          "mixtral-prefill", "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=str(env.ROOT))
    assert out.returncode != 0 and out.stdout.strip() == ""
    # a directory with only BENCHMARK.json and the benchmark's files
    shutil.copy(env.ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    shutil.copytree(env.BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "portbench/run.py", "--workload", "mixtral-prefill",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=120, cwd=str(tmp_path))
    assert out.returncode != 0 and out.stdout.strip() == ""
