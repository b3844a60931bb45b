"""% of the traced window in which no kernel, copy or fill ran."""
from harness import trace


def read(ctx):
    if ctx.trace is None or ctx.trace.window_s <= 0 or not ctx.trace.ops:
        return None
    return 100.0 * (1.0 - trace.busy(ctx.trace) / ctx.trace.window_s)
