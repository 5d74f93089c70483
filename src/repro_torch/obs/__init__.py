"""repro_torch.obs — tracing, metrics, and superstep telemetry (a copy of
``repro.obs``).

Leaf package by design: nothing here imports from ``repro_torch.core``,
``repro_torch.engine``, or ``repro_torch.serve``, so any of those layers can depend
on it (the driver attaches :class:`SuperstepTelemetry`, the service
wires a :class:`Tracer` and a :class:`MetricsRegistry`) without cycles.
Stdlib + numpy only — no torch at import time.
"""

from .export import MetricsServer, PROM_CONTENT_TYPE
from .metrics import (Counter, DEFAULT_BUCKETS_MS, Gauge, Histogram,
                      MetricsRegistry, default_registry, parse_prometheus)
from .telemetry import (HostTelemetryCollector, SuperstepTelemetry,
                        TELEMETRY_MAX_SUPERSTEPS)
from .trace import Span, Trace, Tracer, render_span_tree

__all__ = [
    "Counter",
    "DEFAULT_BUCKETS_MS",
    "Gauge",
    "Histogram",
    "HostTelemetryCollector",
    "MetricsRegistry",
    "MetricsServer",
    "PROM_CONTENT_TYPE",
    "Span",
    "SuperstepTelemetry",
    "TELEMETRY_MAX_SUPERSTEPS",
    "Trace",
    "Tracer",
    "default_registry",
    "parse_prometheus",
    "render_span_tree",
]
