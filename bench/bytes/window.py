"""Least bytes of a window: at every level, each valid item's value and
stratum read once and each forwarded (root: sampled) row written once.
Padding, priorities and the answers (a few hundred bytes) are not
counted."""

ROW_BYTES = 8


def least_bytes(flows) -> float:
    return float(sum(ROW_BYTES * (i + o) for i, o in
                     zip(flows["level_in"], flows["level_out"])))
