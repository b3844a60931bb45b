"""``launches_per_window`` in the cells whose end-to-end latency is
``window_p95_ms.tenants``."""
from harness import registry

read = registry.metric_reader("launches_per_window").read
