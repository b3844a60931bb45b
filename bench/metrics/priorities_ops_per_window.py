"""Outermost host torch operations a window that start inside the
program's ``priorities`` spans: the epoch's Threefry draws for every
level, as tensor operations."""
from harness import program_spans


def read(ctx):
    return program_spans.ops_per_window(ctx, "priorities")
