"""repro_torch.obs — the tuner loop's span and counter vocabulary.

A copy of the reference package's tracing core (``trace.py``) and metrics
registry (``metrics.py``), with the same span and counter names, so traces
taken from either package compare name for name:

    from repro_torch import obs

    with obs.span("surrogate_fit", rung=r) as sp:
        ...
    obs.count("surrogate_store/hits")

The exporters and the report live only in the reference package.
"""

from .metrics import Counter, Gauge, Histogram, Metrics
from .trace import (
    Span, Tracer, get_tracer, set_tracer, tracing,
    span, instant, count, gauge, observe,
)

__all__ = [
    "Counter", "Gauge", "Histogram", "Metrics",
    "Span", "Tracer", "get_tracer", "set_tracer", "tracing",
    "span", "instant", "count", "gauge", "observe",
]
