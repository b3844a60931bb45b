"""Observability: the in-graph ``EpochTelemetry`` counters (with the
serve plane's straggler accounting), the host span tracer and the
Prometheus-text metrics."""
from repro_torch.obs.telemetry import (EpochTelemetry, StragglerMonitor,
                                       fold_stragglers, reset, snapshot,
                                       tenant_rel_bounds)

__all__ = ["EpochTelemetry", "StragglerMonitor", "fold_stragglers",
           "snapshot", "tenant_rel_bounds", "reset"]
