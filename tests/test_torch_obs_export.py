"""The port's trace exporters, schema, report and self-check against the
JAX package's (``repro.obs``)."""
from __future__ import annotations

import json

import pytest

import repro.obs as Robs
import repro_torch.baselines as PB
import repro_torch.core as P
import repro_torch.obs as Pobs
import repro_torch.sparksim as PS
from repro_torch.tuneapi import Budget


@pytest.fixture(scope="module")
def tracer():
    """A port trace on the CPU: VanillaBO for 3 virtual hours, then MFTune
    for 4 on the self-check's warm history (TPC-H 100 GB on hardware A, 12
    observations), where MFO activates at once."""
    kb = P.KnowledgeBase()
    kb.add_task(PS.generate_history(PS.TaskSpec("tpch", 100, "A").workload(), n_obs=12,
                                    n_init=5, seed=3, device="cpu"), persist=False)
    wl = PS.SparkWorkload("tpch", 100, "A")
    tr = Pobs.Tracer("export")
    with Pobs.tracing(tr):
        PB.VanillaBO(wl, kb=kb, seed=0, device="cpu").run(Budget(3 * 3600.0))
        P.MFTune(wl, kb, P.MFTuneOptions(seed=0), device="cpu").run(Budget(4 * 3600.0))
    return tr


def test_schema_equals_the_reference():
    assert Pobs.load_schema() == Robs.load_schema()
    with open(Pobs.SCHEMA_PATH) as a, open(Robs.SCHEMA_PATH) as b:
        assert json.load(a) == json.load(b)


def test_trace_validates_in_both_packages(tracer):
    events = Pobs.trace_events(tracer)
    assert Pobs.validate_events(events) == []
    assert Robs.validate_events(events) == []
    names = {e["name"] for e in events if e["type"] == "span"}
    assert {"bo_recommend", "acquisition", "rung_eval", "workload_eval"} <= names
    scopes = {e.get("scope") for e in events if e["type"] == "counter"}
    assert "bo:tpch-100gb-A" in scopes


def _untimed_snapshots(path):
    """The events of a JSONL file, the time stamps of the global metric
    snapshots (taken at export) left out."""
    out = []
    for line in path.read_text().splitlines():
        ev = json.loads(line)
        if ev["type"] in ("counter", "gauge", "histogram") and ev.get("scope") == "global":
            ev.pop("ts")
        out.append(ev)
    return out


def test_jsonl_export_equals_the_reference(tracer, tmp_path):
    a, b = tmp_path / "port.jsonl", tmp_path / "ref.jsonl"
    Pobs.export_jsonl(tracer, str(a))
    Robs.export_jsonl(tracer, str(b))
    assert _untimed_snapshots(a) == _untimed_snapshots(b)
    assert len(a.read_text().splitlines()) > 100


def test_round_trip_through_both_exporters(tracer, tmp_path):
    canonical = Pobs.trace_events(tracer)
    pf, jl = tmp_path / "t.perfetto.json", tmp_path / "t.jsonl"
    doc = Pobs.export_perfetto(tracer, str(pf))
    Pobs.export_jsonl(tracer, str(jl))
    assert json.loads(pf.read_text()) == doc
    for path in (pf, jl):
        back = Pobs.read_events(str(path))
        assert Pobs.validate_events(back) == []
        assert back == Robs.read_events(str(path))
        assert len(back) == len(canonical)
        key = lambda e: (e["name"], round(e["ts"], 6), e["id"], e["parent"])
        assert (sorted(key(e) for e in back if e["type"] == "span")
                == sorted(key(e) for e in canonical if e["type"] == "span"))


def test_validator_flags_what_the_reference_flags():
    bad = [
        {"type": "span", "name": "x"},
        {"type": "instant", "name": 3, "ts": 0.0, "tid": 1, "args": {}},
        {"type": "nope", "name": "x"},
        {"type": "span", "name": "x", "ts": 0.0, "dur": -1.0, "id": 1,
         "parent": -1, "tid": 1, "args": {}},
    ]
    for ev in bad:
        assert Pobs.validate_events([ev]) == Robs.validate_events([ev]) != []


def test_summary_equals_the_reference(tracer, tmp_path):
    events = Pobs.trace_events(tracer)
    text = Pobs.summarize(events)
    assert text == Robs.summarize(events)
    assert "stage time breakdown" in text and "rung survival funnel" in text
    pf = tmp_path / "t.perfetto.json"
    Pobs.export_perfetto(tracer, str(pf))
    back = Pobs.read_events(str(pf))
    assert Pobs.summarize(back) == Robs.summarize(back)


def test_selfcheck_passes_on_the_cpu(capsys):
    from repro_torch.obs import selfcheck

    assert selfcheck.main(["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "selfcheck: OK" in out and "0 schema violations" in out


def test_selfcheck_needs_a_card_by_default():
    import torch

    from repro_torch.obs import selfcheck

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        selfcheck.main([])
