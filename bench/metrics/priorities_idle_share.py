"""% of the traced window in which no kernel, copy or fill ran while the
host was inside the program's ``priorities`` spans."""
from harness import program_spans


def read(ctx):
    return program_spans.idle_share(ctx, "priorities")
