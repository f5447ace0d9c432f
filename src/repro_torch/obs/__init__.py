"""Telemetry of the port (``repro.obs``):

``obs.trace``     — span tracer + Chrome-trace export + torch.profiler hooks
``obs.metrics``   — typed counters/gauges/histograms behind one schema
``obs.telemetry`` — the per-run bundle wiring both to a telemetry dir
"""
from repro_torch.obs.metrics import (ASYNC_SCHEMA, ASYNC_VIEW, COUNTER,
                                     FLEET_SCHEMA, GAUGE, HIST, ROUND_SCHEMA,
                                     MetricsRegistry, MetricSpec, MetricsView)
from repro_torch.obs.telemetry import (JsonlSink, Telemetry, from_config,
                                       get_default, set_default)
from repro_torch.obs.trace import (NULL_SPAN, SPAN_KINDS, SpanRecord, Tracer,
                                   chrome_trace_doc, export_chrome_trace,
                                   start_profiler, stop_profiler,
                                   validate_chrome_trace)

__all__ = [
    "ASYNC_SCHEMA", "ASYNC_VIEW", "COUNTER", "FLEET_SCHEMA", "GAUGE", "HIST",
    "ROUND_SCHEMA", "MetricSpec", "MetricsRegistry", "MetricsView",
    "JsonlSink", "Telemetry", "from_config", "get_default", "set_default",
    "NULL_SPAN", "SPAN_KINDS", "SpanRecord", "Tracer",
    "chrome_trace_doc", "export_chrome_trace", "start_profiler",
    "stop_profiler", "validate_chrome_trace",
]
