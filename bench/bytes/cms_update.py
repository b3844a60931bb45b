"""Least bytes of ``cms_update``: one launch a window for each
heavy-hitter query (plain or decayed) of the configuration's tenants.
A launch reads each sampled item's key and weight once (4 + 4 bytes):
an item of weight above 0 changes a bucket of every row. Of the table,
at least one counter a row changes in a window that samples anything (4
bytes each). Items left out of the sample (weight 0) and the buffer's
padding are not counted."""

KERNEL = "cms_update_kernel"
KINDS = ("heavy_hitters", "decayed_heavy_hitters")


def least_bytes(flows, config) -> float:
    """``flows``: as ``fused_level_tick``'s, with ``sampled_ticks``;
    ``config``: the cell's configuration (its ``tenants``)."""
    sampled = flows["level_out"][-1]
    return float(sum(8 * sampled + 4 * q.get("depth", 4)
                     * flows["sampled_ticks"]
                     for t in config.get("tenants", ())
                     for q in t["queries"] if q["kind"] in KINDS))
