"""% of its memory roofline that ``fused_level_tick`` reaches."""
from harness.roofline import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "fused_level_tick")
