"""Observability: the in-graph ``EpochTelemetry`` counters (with the
serve plane's straggler accounting), the host span tracer and the
Prometheus-text metrics."""
from repro_torch.obs.telemetry import (EpochTelemetry, StragglerMonitor,
                                       fold_stragglers, reset, snapshot,
                                       tenant_rel_bounds)
from repro_torch.obs.trace import SpanTracer, get_tracer, span
from repro_torch.obs.metrics import (MetricsRegistry, metrics_text,
                                     parse_prometheus_text,
                                     render_pipeline_metrics)

__all__ = ["EpochTelemetry", "StragglerMonitor", "fold_stragglers",
           "snapshot", "tenant_rel_bounds", "reset",
           "SpanTracer", "get_tracer", "span",
           "MetricsRegistry", "metrics_text", "parse_prometheus_text",
           "render_pipeline_metrics"]
