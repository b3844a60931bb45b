"""``priorities_idle_share`` in the cells whose end-to-end latency is
``window_p95_ms.tenants``."""
from harness import registry

read = registry.metric_reader("priorities_idle_share").read
