"""BENCHMARK.json against the benchmark's contract, and every file it names
found by name: names and units in the allowed characters, each cell's
configuration, mix and limits, each per-layer metric's reader, and every
cell a per-layer metric lists reporting the end-to-end metric it moves."""

import json
import re

import pytest

from portbench.harness import env, manifest

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
M = manifest.manifest()


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys_and_sizes():
    assert set(M) == TOP
    assert (env.ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(M["paths"]) <= 16 and all(PATH.match(p) and ".." not in p for p in M["paths"])
    assert 1 <= len(M["command"]) <= 32 and all(_line(w) for w in M["command"])
    assert isinstance(M["run_seconds"], int) and 1 <= M["run_seconds"] <= 51


def test_entries_have_just_their_keys():
    for c in M["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in M["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
    for m in M["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
    for m in M["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}


def test_names_units_and_lines():
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in M[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
            for k in ("why", "source", "layer"):
                if k in e and group != "end_to_end" and group != "per_layer" or k == "layer" and k in e:
                    assert _line(e[k]), (e["name"], k)
            if "unit" in e:
                assert UNIT.match(e["unit"]), e["unit"]
            if "better" in e:
                assert e["better"] in ("lower", "higher")
    assert len(names) == len(set(names))
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(metric_names) == len(set(metric_names))
    for w in M["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and _line(w["why"])
        assert w["chips"] in (1, 4)
    for c in M["configs"]:
        assert len(c["reduced"]) <= 16 and all(NAME.match(k) for k in c["reduced"])


def test_every_cell_finds_its_files_by_name():
    used = set()
    for w in M["workloads"]:
        cell = manifest.cell(w["name"])
        assert cell.config["name"] == w["config"]
        kind = manifest.kind(cell.traffic["kind"])
        assert callable(kind.drive) and callable(kind.check_numbers)
        assert callable(manifest.family_work(cell.config["arch"]["family"],
                                             cell.traffic["kind"]))
        assert cell.limits["numbers"]
        used.add(w["config"])
    for c in M["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        cfg = json.loads((env.ROOT / c["file"]).read_text())
        assert sorted(cfg["reduced"]) == sorted(c["reduced"])
        assert (env.BENCH / "reference" / f"{cfg['reference']}.py").exists()


def test_no_width_is_reduced():
    widths = re.compile(r"(hidden|intermediate|latent|state|proj|head|_dim$|_rank$|expan|d_model|"
                        r"d_ff|top_k|per_tok)")
    for c in M["configs"]:
        assert not [k for k in c["reduced"] if widths.search(k)], c["reduced"]


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in M["workloads"]:
        cell = manifest.cell(w["name"])
        e2e = {m["name"] for m in cell.end_to_end}
        assert "setup_s" in e2e and len(e2e) >= 2
        assert cell.per_layer


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in M["end_to_end"]}
    cells = {w["name"] for w in M["workloads"]}
    for m in M["per_layer"]:
        assert m["moves"] in e2e
        for w in m.get("workloads", sorted(cells)):
            assert w in cells
            moved = e2e[m["moves"]]
            assert "workloads" not in moved or w in moved["workloads"], (m["name"], w)
        manifest.reader(m["name"])           # its reader is found by name


def test_shares_use_percent_and_rooflines_are_named_for_their_kernel():
    for m in M["per_layer"]:
        if "roofline" in m["name"]:
            assert re.match(r"^[a-z0-9]+_roofline(\.|$)", m["name"]) and m["unit"] == "%"
        if "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_bounds():
    for m in M["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in M["end_to_end"])


def test_at_most_a_quarter_of_cells_ask_for_four_chips():
    four = sum(w["chips"] == 4 for w in M["workloads"])
    assert four <= max(1, len(M["workloads"]) // 4)


@pytest.mark.parametrize("name", [m["name"] for m in M["per_layer"]])
def test_a_reader_that_finds_nothing_returns_nothing(name):
    from portbench.harness.cell import Window
    from portbench.harness.work import Work

    class Empty:
        window_s, busy_s, class_s = 1.0, 0.0, {}

    value = manifest.reader(name)(Window(1.0, Empty(), Work()))
    if "roofline" in name or "mfu" in name or "_ms" in name:
        assert value is None
