"""Least bytes of a window: at every level, each valid item's value and
stratum read once and each forwarded (root: sampled) row written once;
and the sketch kernels' least bytes (``bytes/cms_update.py``,
``bytes/quantile_compact.py``: 0 for a configuration with no tenants).
Padding, priorities, the sketches' sorts and the answers (a few hundred
bytes) are not counted."""
from harness import registry

ROW_BYTES = 8
SKETCH_KERNELS = ("cms_update", "quantile_compact")


def least_bytes(flows, config) -> float:
    tree = float(sum(ROW_BYTES * (i + o) for i, o in
                     zip(flows["level_in"], flows["level_out"])))
    return tree + sum(registry.byte_count(k).least_bytes(flows, config)
                      for k in SKETCH_KERNELS)
