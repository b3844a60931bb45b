"""Observability: the in-graph ``EpochTelemetry`` counters, the host span
tracer and the Prometheus-text metrics."""
from repro_torch.obs.telemetry import (EpochTelemetry, reset, snapshot,
                                       tenant_rel_bounds)

__all__ = ["EpochTelemetry", "snapshot", "tenant_rel_bounds", "reset"]
