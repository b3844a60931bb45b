"""Least bytes of ``quantile_compact``: one launch a window for each
level of every fold of a quantile sketch. A quantile query folds the
window's batch into its sketch (``L`` levels: 1, 2 or 4 as its capacity
``C`` is under 16, under 64 or not); a windowed one folds it into a
fresh sub-sketch and merges its ring (``2L``). A launch reads each of
its ``m`` targets and writes each one's value (4 + 4 bytes), ``m`` being
``C/2`` below the top level and ``C`` at it. The launch that takes the
window's batch (level 0 of a batch fold) also reads each sampled item's
cumulative weight once (4 bytes): its contract holds for intervals in
any order, so no live slot can be skipped. Items left out of the sample,
the padding and the sketch's own points are not counted."""

KERNEL = "quantile_compact_kernel"
KINDS = ("quantile", "windowed_quantile")


def _levels(capacity: int) -> int:
    return 1 if capacity < 16 else 2 if capacity < 64 else 4


def least_bytes(flows, config) -> float:
    """``flows``: as ``fused_level_tick``'s, with ``ticks``; ``config``:
    the cell's configuration (its ``tenants``)."""
    total = 0.0
    for t in config.get("tenants", ()):
        for q in t["queries"]:
            if q["kind"] not in KINDS:
                continue
            c = int(q.get("capacity", 256))
            targets = (_levels(c) - 1) * (c // 2) + c
            folds = 2 if q["kind"] == "windowed_quantile" else 1
            total += (8 * targets * folds * flows["ticks"]
                      + 4 * flows["level_out"][-1])
    return total
