"""Least bytes of ``fused_level_tick``: one launch a non-root level a
tick. It reads each valid item's value and stratum once (4 + 4 bytes)
and writes each forwarded row once (value and stratum). The padding of
the buffers and the priorities (which a kernel may draw in registers)
are not counted."""

KERNEL = "fused_level_tick_kernel"
ROW_BYTES = 8


def least_bytes(flows, config) -> float:
    """``flows``: items in and rows out at each level, summed over the
    traced ticks (root last); ``config``, the cell's configuration, is
    not read."""
    return float(sum(ROW_BYTES * (i + o) for i, o in
                     zip(flows["level_in"][:-1], flows["level_out"][:-1])))
