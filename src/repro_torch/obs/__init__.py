"""Telemetry of the port (``repro.obs``): so far the typed metrics
registry, ``obs.metrics``. The span tracer, the JSONL sink and
``launch/inspect.py`` are not yet ported (``ROADMAP.md`` item 14)."""
from repro_torch.obs.metrics import (ASYNC_SCHEMA, ASYNC_VIEW, COUNTER, GAUGE,
                                     HIST, ROUND_SCHEMA, MetricsRegistry,
                                     MetricSpec, MetricsView)

__all__ = ["ASYNC_SCHEMA", "ASYNC_VIEW", "COUNTER", "GAUGE", "HIST",
           "ROUND_SCHEMA", "MetricSpec", "MetricsRegistry", "MetricsView"]
