"""Host milliseconds a window inside ``run_epoch``: the call from entry
to return, which holds the synchronous copy of pageable ingest, the
tick counter's read and the launches of the epoch's tick loop."""


def read(ctx):
    if not ctx.windows:
        return None
    return 1e3 * sum(ctx.host["dispatch_s"]) / ctx.windows
