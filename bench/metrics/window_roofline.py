"""% of the memory roofline that the window's kernels reach together."""
from harness.roofline import window_roofline


def read(ctx):
    return window_roofline(ctx)
