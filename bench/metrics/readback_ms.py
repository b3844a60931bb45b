"""Host milliseconds a window reading the epoch's ``WindowAnswers`` to
the host (publication): the wait for the epoch's last kernels and the
copies of the answers."""


def read(ctx):
    if not ctx.windows:
        return None
    return 1e3 * sum(ctx.host["readback_s"]) / ctx.windows
