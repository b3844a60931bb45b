"""% of its memory roofline that ``cms_update`` reaches."""
from harness.roofline import kernel_roofline


def read(ctx):
    return kernel_roofline(ctx, "cms_update")
