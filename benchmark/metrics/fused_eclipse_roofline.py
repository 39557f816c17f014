"""% of the K = 1 eclipse kernel's frozen bound (its launches' shapes) in
its own device time over the traced replayed blocks."""

from bm.kernels import roofline_share


def read(ctx):
    return roofline_share(ctx, "fused_eclipse")
