"""Trace exporters: JSONL event log + Chrome/Perfetto ``trace_event`` JSON.

The JSONL format is the source of truth (one event dict per line, the
exact schema in ``trace_schema.json``). The Perfetto export is a lossless
re-encoding of the same events into the Chrome trace_event format so a
run opens directly in https://ui.perfetto.dev — :func:`read_events`
round-trips either file back to the canonical event list.

Port of ``repro.obs.export``, with its own copy of the schema beside it,
so a trace of the port (MFTune's or a baseline's) is exported and checked
without the reference package.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict, List, Optional

import numpy as np

from .trace import Tracer

__all__ = [
    "trace_events", "export_jsonl", "export_perfetto", "read_events",
    "load_schema", "validate_events", "SCHEMA_PATH",
]

SCHEMA_PATH = os.path.join(os.path.dirname(__file__), "trace_schema.json")


def _json_default(o: Any) -> Any:
    if isinstance(o, np.integer):
        return int(o)
    if isinstance(o, np.floating):
        return float(o)
    if isinstance(o, np.ndarray):
        return o.tolist()
    if isinstance(o, (set, frozenset, tuple)):
        return list(o)
    return str(o)


def _normalize(ev: Dict[str, Any]) -> Dict[str, Any]:
    """Round-trip through json to coerce numpy scalars etc. to plain types."""
    return json.loads(json.dumps(ev, default=_json_default))


def trace_events(tracer: Tracer) -> List[Dict[str, Any]]:
    """The canonical event list for a tracer: one ``meta`` header, the
    buffered span/instant events, then the tracer's own (global-scope)
    metric snapshots."""
    meta = {
        "type": "meta",
        "name": tracer.name,
        "epoch": tracer.epoch,
        "wall_epoch": tracer.wall_epoch,
        "dropped": tracer.dropped,
    }
    n0 = len(tracer.events)
    tracer.emit_metrics(tracer.metrics, scope="global")
    metric_evs = tracer.events[n0:]
    del tracer.events[n0:]  # keep the buffer re-exportable
    return [_normalize(e) for e in [meta] + tracer.events + metric_evs]


def export_jsonl(tracer: Tracer, path: str) -> List[Dict[str, Any]]:
    events = trace_events(tracer)
    with open(path, "w") as f:
        for ev in events:
            f.write(json.dumps(ev) + "\n")
    return events


# --------------------------------------------------------------------------
# Chrome/Perfetto trace_event encoding
# --------------------------------------------------------------------------

def _tid_map(events: List[Dict[str, Any]]) -> Dict[int, int]:
    """Remap raw thread idents to small stable ints for display."""
    out: Dict[int, int] = {}
    for ev in events:
        tid = ev.get("tid")
        if tid is not None and tid not in out:
            out[tid] = len(out)
    return out


def export_perfetto(tracer: Tracer, path: str) -> Dict[str, Any]:
    """Write ``{"traceEvents": [...]}`` JSON openable in ui.perfetto.dev.

    Encoding (lossless — ``read_events`` inverts it):
      span      -> "X" complete event, ts/dur in microseconds; the event
                   id/parent ride along inside ``args``.
      instant   -> "i" instant event (scope "t").
      counter/gauge -> "C" counter samples.
      histogram -> "i" instant carrying the full snapshot in args.
      meta      -> a process_name "M" metadata record + one instant
                   ("trace_meta") holding the epoch timestamps.
    """
    events = trace_events(tracer)
    tids = _tid_map(events)
    pid = 1
    out: List[Dict[str, Any]] = [
        {"ph": "M", "pid": pid, "tid": 0, "name": "process_name",
         "args": {"name": f"repro_torch.obs:{tracer.name}"}},
    ]
    for raw, small in tids.items():
        out.append({"ph": "M", "pid": pid, "tid": small, "name": "thread_name",
                    "args": {"name": f"thread-{small}"}})
    for ev in events:
        t = ev["type"]
        if t == "meta":
            out.append({"ph": "i", "pid": pid, "tid": 0, "ts": 0.0, "s": "p",
                        "name": "trace_meta",
                        "args": {k: ev[k] for k in ev if k != "type"}})
        elif t == "span":
            out.append({
                "ph": "X", "pid": pid, "tid": tids.get(ev["tid"], 0),
                "name": ev["name"],
                "ts": ev["ts"] * 1e6, "dur": ev["dur"] * 1e6,
                "args": dict(ev["args"], id=ev["id"], parent=ev["parent"]),
            })
        elif t == "instant":
            out.append({
                "ph": "i", "pid": pid, "tid": tids.get(ev["tid"], 0),
                "s": "t", "name": ev["name"], "ts": ev["ts"] * 1e6,
                "args": ev["args"],
            })
        elif t in ("counter", "gauge"):
            out.append({
                "ph": "C", "pid": pid, "tid": 0, "name": ev["name"],
                "ts": ev["ts"] * 1e6,
                "args": {"value": ev["value"], "scope": ev["scope"],
                         "kind": t},
            })
        elif t == "histogram":
            out.append({
                "ph": "i", "pid": pid, "tid": 0, "s": "p",
                "name": f"histogram:{ev['name']}", "ts": ev["ts"] * 1e6,
                "args": {k: ev[k] for k in ev if k != "type"},
            })
    doc = {"traceEvents": out, "displayTimeUnit": "ms"}
    with open(path, "w") as f:
        json.dump(doc, f)
    return doc


def read_events(path: str) -> List[Dict[str, Any]]:
    """Load a trace file back into canonical events. Auto-detects format:
    a JSON object with ``traceEvents`` is decoded from the Perfetto
    encoding; anything else is treated as JSONL."""
    with open(path) as f:
        text = f.read()
    try:
        doc = json.loads(text)
    except json.JSONDecodeError:
        doc = None  # multiple lines -> JSONL
    if isinstance(doc, dict) and "traceEvents" in doc:
        return _decode_perfetto(doc)
    if isinstance(doc, dict):
        return [doc]  # single-event JSONL
    return [json.loads(line) for line in text.splitlines() if line.strip()]


def _decode_perfetto(doc: Dict[str, Any]) -> List[Dict[str, Any]]:
    events: List[Dict[str, Any]] = []
    for ev in doc.get("traceEvents", []):
        ph = ev.get("ph")
        name = ev.get("name", "")
        if ph == "M":
            continue
        if ph == "i" and name == "trace_meta":
            events.append(dict({"type": "meta"}, **ev["args"]))
        elif ph == "X":
            args = dict(ev["args"])
            eid = args.pop("id")
            parent = args.pop("parent")
            events.append({
                "type": "span", "name": name,
                "ts": ev["ts"] / 1e6, "dur": ev["dur"] / 1e6,
                "id": eid, "parent": parent, "tid": ev["tid"], "args": args,
            })
        elif ph == "C":
            args = ev["args"]
            events.append({
                "type": args.get("kind", "counter"), "name": name,
                "ts": ev["ts"] / 1e6, "scope": args.get("scope", "global"),
                "value": args["value"],
            })
        elif ph == "i" and name.startswith("histogram:"):
            rest = dict(ev["args"])
            events.append(dict({"type": "histogram"}, **rest))
        elif ph == "i":
            events.append({
                "type": "instant", "name": name, "ts": ev["ts"] / 1e6,
                "tid": ev["tid"], "args": ev.get("args", {}),
            })
    return events


# --------------------------------------------------------------------------
# Schema validation (minimal subset validator — no external deps)
# --------------------------------------------------------------------------

def load_schema(path: str = SCHEMA_PATH) -> Dict[str, Any]:
    with open(path) as f:
        return json.load(f)


_TYPES = {
    "object": dict,
    "array": list,
    "string": str,
    "number": (int, float),
    "integer": int,
    "boolean": bool,
}


def _check(value: Any, spec: Dict[str, Any], where: str,
           errors: List[str]) -> None:
    t = spec.get("type")
    if t is not None:
        py = _TYPES[t]
        ok = isinstance(value, py)
        if t in ("number", "integer") and isinstance(value, bool):
            ok = False
        if not ok:
            errors.append(f"{where}: expected {t}, got {type(value).__name__}")
            return
    if "enum" in spec and value not in spec["enum"]:
        errors.append(f"{where}: {value!r} not in {spec['enum']}")
    if "minimum" in spec and isinstance(value, (int, float)) \
            and not isinstance(value, bool) and value < spec["minimum"]:
        errors.append(f"{where}: {value} < minimum {spec['minimum']}")
    if t == "object":
        for req in spec.get("required", []):
            if req not in value:
                errors.append(f"{where}: missing required key {req!r}")
        props = spec.get("properties", {})
        for k, v in value.items():
            if k in props:
                _check(v, props[k], f"{where}.{k}", errors)
            elif spec.get("additionalProperties") is False:
                errors.append(f"{where}: unexpected key {k!r}")
    elif t == "array" and "items" in spec:
        for i, item in enumerate(value):
            _check(item, spec["items"], f"{where}[{i}]", errors)


def validate_events(events: List[Dict[str, Any]],
                    schema: Optional[Dict[str, Any]] = None) -> List[str]:
    """Validate events against the checked-in schema; returns a list of
    human-readable violations (empty = valid)."""
    if schema is None:
        schema = load_schema()
    kinds = schema["eventTypes"]
    errors: List[str] = []
    for i, raw in enumerate(events):
        ev = _normalize(raw)
        t = ev.get("type")
        if t not in kinds:
            errors.append(f"event[{i}]: unknown type {t!r}")
            continue
        _check(ev, kinds[t], f"event[{i}]({t})", errors)
    return errors
