"""Device operations (kernels, copies, fills) a window in the trace."""
from harness import trace


def read(ctx):
    if ctx.trace is None or not ctx.windows:
        return None
    n = sum(1 for o in ctx.trace.ops if trace.in_window(ctx.trace, o))
    return n / ctx.windows if n else None
