"""repro_torch.obs — the tuner loop's tracing & metrics plane, ported.

A copy of the reference package's tracing core (``trace.py``), metrics
registry (``metrics.py``), exporters (``export.py``, with the schema
``trace_schema.json``) and report (``report.py``), with the same span and
counter names, so traces taken from either package compare name for name:

    from repro_torch import obs

    with obs.tracing(name="tpch-run") as tr:
        result = MFTune(wl, kb, opts).run(budget)
    obs.export_perfetto(tr, "run.perfetto.json")   # ui.perfetto.dev
    obs.export_jsonl(tr, "run.trace.jsonl")

``python -m repro_torch.obs.selfcheck`` checks the whole plane end to end.
"""

from .metrics import Counter, Gauge, Histogram, Metrics
from .trace import (
    Span, Tracer, get_tracer, set_tracer, tracing,
    span, instant, count, gauge, observe,
)
from .export import (
    trace_events, export_jsonl, export_perfetto, read_events,
    load_schema, validate_events, SCHEMA_PATH,
)
from .report import summarize

__all__ = [
    "Counter", "Gauge", "Histogram", "Metrics",
    "Span", "Tracer", "get_tracer", "set_tracer", "tracing",
    "span", "instant", "count", "gauge", "observe",
    "trace_events", "export_jsonl", "export_perfetto", "read_events",
    "load_schema", "validate_events", "SCHEMA_PATH",
    "summarize",
]
