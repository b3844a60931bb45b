"""Host milliseconds a window inside the program's ``tick`` spans: the
tick loop's calls (appends, level ticks, routing, metadata folds, the
root), which issue the epoch's launches and may wait on a full launch
queue."""
from harness import program_spans


def read(ctx):
    return program_spans.host_ms(ctx, "tick")
