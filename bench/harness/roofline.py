"""Shares of the memory roofline from the device trace and the byte
counts under ``bench/bytes``: the least time the bytes need at the
card's peak bandwidth, over the device time the work took."""
from __future__ import annotations

import re

from harness import registry, trace


def kernel_roofline(ctx, name: str):
    """% of the roofline of the kernel whose byte count is
    ``bytes/<name>.py``, summed over its launches in the traced window;
    ``None`` where no launch of it was traced."""
    if ctx.trace is None or ctx.peaks is None:
        return None
    mod = registry.byte_count(name)
    pat = re.compile(rf"\b{re.escape(mod.KERNEL)}\b")
    t = sum(o.end - o.start for o in ctx.trace.ops
            if o.kind == "kernel" and trace.in_window(ctx.trace, o)
            and pat.search(o.name))
    if t <= 0:
        return None
    least = (mod.least_bytes(ctx.flows, ctx.config)
             / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least / t


def window_roofline(ctx):
    """% of the roofline of the whole window: its least bytes
    (``bytes/window.py``) over the union of its kernels' device
    intervals (copies and fills left out)."""
    if ctx.trace is None or ctx.peaks is None:
        return None
    t = trace.busy(ctx.trace, kinds=("kernel",))
    if t <= 0:
        return None
    mod = registry.byte_count("window")
    least = (mod.least_bytes(ctx.flows, ctx.config)
             / ctx.peaks["hbm_bytes_per_s"])
    return 100.0 * least / t
