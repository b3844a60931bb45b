"""Device milliseconds a window in host-to-device copies."""
from harness import trace


def read(ctx):
    if ctx.trace is None or not ctx.windows:
        return None
    t = sum(o.end - o.start for o in ctx.trace.ops
            if o.kind == "copy" and "HtoD" in o.name
            and trace.in_window(ctx.trace, o))
    return 1e3 * t / ctx.windows if t > 0 else None
