"""Outermost host torch operations a window that start inside the
program's ``tick`` spans."""
from harness import program_spans


def read(ctx):
    return program_spans.ops_per_window(ctx, "tick")
