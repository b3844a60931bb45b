"""``fused_level_tick_roofline`` in the cells whose end-to-end latency is
``window_p95_ms.tenants``."""
from harness import registry

read = registry.metric_reader("fused_level_tick_roofline").read
