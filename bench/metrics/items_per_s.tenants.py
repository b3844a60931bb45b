"""Valid items a second handed to ``run_epoch`` over the traced window,
first call to last read, under the profiler: ``items_per_s`` where that
is no end-to-end metric (its runs spread too widely for a bound)."""


def read(ctx):
    items, window_s = ctx.flows["level_in"][0], ctx.host["window_s"]
    return items / window_s if items > 0 and window_s > 0 else None
