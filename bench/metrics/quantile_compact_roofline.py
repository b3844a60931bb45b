"""% of its memory roofline that ``quantile_compact`` reaches."""
from harness.roofline import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "quantile_compact")
