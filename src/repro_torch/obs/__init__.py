"""Observability: the in-graph ``EpochTelemetry`` counters."""
from repro_torch.obs.telemetry import EpochTelemetry, snapshot

__all__ = ["EpochTelemetry", "snapshot"]
